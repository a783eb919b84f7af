"""Smoke run of the full-resolution landmark pipeline on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-4 on one card
    python chip_smoke.py --four     # only the 4-card sharded path

Phases (smoke_checks.py; any failure exits non-zero):
  1. kernels at real widths against plain references: the 600x512
     proximal slice stack vs the numpy slicer, both find_peaks cores vs
     scipy, the bf16 UNet on the card vs the CPU, the forest vs a numpy
     descent, and the float32 matmul precision pin;
  2. the `Humerus` facade on a seeded STL: csys, landmarks, metrics vs
     the generator's truth, osteotomy resection;
  3. 8 exact-truth bones through `compute_landmarks_batch`: recovery
     bounds, GPU vs CPU, GPU run-to-run, compile / p50 / bones/s / peak
     memory;
  4. 16 seeded STLs (8 healthy, 8 arthritic) through `process_cohort`.

The script refuses to run without a GPU.  Its last stdout line is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the bone-sharded path over 4 cards")
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import smoke_checks as smoke

    dev = smoke.require_gpu()
    cards = smoke.card_lines()
    label = f"{cards[0]} (name, power limit)"
    for i, line in enumerate(cards):
        print(f"card {i}: {line}", flush=True)
    t_start = time.perf_counter()

    if args.four:
        smoke.phase_four(args.seed)
        count = 4
    else:
        smoke.phase_kernels(args.seed)
        facade = smoke.phase_facade(args.seed)
        batch = smoke.phase_batch(args.seed)
        cohort = smoke.phase_cohort(args.seed)
        count = 1
        print(f"[timing] card: {label}", flush=True)
        print(f"[timing] batch-8 program: compile+first run "
              f"{batch['first_call_s']:.2f} s, compile ~"
              f"{batch['first_call_s'] - batch['p50_s']:.2f} s (first minus "
              f"p50)", flush=True)
        print("[timing] batch-8 warm reps (ms, block_until_ready): "
              + ", ".join(f"{t * 1e3:.2f}" for t in batch["lat_s"])
              + f"; p50 {batch['p50_s'] * 1e3:.2f} ms, "
              f"{batch['bones_per_s']:.2f} bones/s", flush=True)
        print(f"[timing] peak_bytes_in_use {batch['peak_bytes_in_use']} "
              f"({batch['peak_bytes_in_use'] / 2**30:.2f} GiB)", flush=True)
        print(f"[timing] facade: ingest {facade['ingest_s']:.2f} s, first "
              f"landmark {facade['first_landmark_cold_s']:.2f} s cold / "
              f"{facade['first_landmark_warm_s']:.2f} s warm (compile ~"
              f"{facade['compile_s']:.2f} s)", flush=True)
        print(f"[timing] cohort: 16 STLs in {cohort['wall_s']:.2f} s incl. "
              f"the wire program's compile", flush=True)
    print(f"[timing] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
