"""Headline benchmark: bones/sec through the full landmark pipeline on a GPU.

Prints the device (platform, device_kind, count, and the card's name and
power limit) on stderr, then ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "bones/sec", "vs_baseline": N}

Protocol: BENCH_BATCH (default 8) seeded exact-truth synthetic bones
through the full-resolution pipeline (600x512 proximal + 200x100 full +
200x500 distal stacks, RF groove classifier, the default UNet-seeded
articular segmentation, transepicondylar MRR, all metrics), timed over
BENCH_REPS repeated executions ending in block_until_ready.  The output
is gated on the generator's truth (the accuracy gate's healthy bounds).
Refuses to run without a GPU.

Baseline: the reference publishes no numbers (BASELINE.md).  The
denominator is a conservative stand-in: this same full-resolution
pipeline on one CPU core, 2.1 s/bone (BASELINE.md).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_CPU_SEC_PER_BONE = 2.1
BATCH = int(os.environ.get("BENCH_BATCH", "8"))
REPS = int(os.environ.get("BENCH_REPS", "5"))


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    import smoke_checks as smoke
    from shoulder_tpu.pipeline import batch as B

    dev = smoke.require_gpu()
    log(f"device: platform {dev.platform}, kind {dev.device_kind}, count "
        f"{len(jax.devices())}; card (name, power limit): "
        + "; ".join(smoke.card_lines()))

    _, _, specs, truths = smoke.healthy_cohort(BATCH, seed=2026)
    bones = B.stack_bones(specs)

    t0 = time.perf_counter()
    lm = jax.block_until_ready(B.compute_landmarks_batch(bones, chunk=150))
    log(f"compile+first run {time.perf_counter() - t0:.1f}s")

    lat = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        lm = jax.block_until_ready(B.compute_landmarks_batch(bones, chunk=150))
        lat.append(time.perf_counter() - t0)
    dt = float(np.median(lat))
    bones_per_sec = BATCH / dt
    log("exec per-rep ms: " + ", ".join(f"{t * 1e3:.1f}" for t in lat)
        + f"; p50 {dt * 1e3:.1f} ms/batch of {BATCH}")

    lm = B.landmarks_to_numpy(lm)
    bad = [smoke.within_bounds(t, *smoke.bone_metrics(lm, i))
           for i, t in enumerate(truths)]
    if any(bad):
        log(f"output outside the truth bounds: {bad}")
        print(json.dumps({
            "metric": "full landmark pipeline throughput (INSANE OUTPUT)",
            "value": 0.0, "unit": "bones/sec", "vs_baseline": 0.0,
        }))
        return 1

    print(json.dumps({
        "metric": (f"full landmark pipeline throughput on {dev.device_kind},"
                   f" batch={BATCH}, p50 latency {dt * 1e3:.1f} ms/batch"),
        "value": round(bones_per_sec, 2),
        "unit": "bones/sec",
        "vs_baseline": round(bones_per_sec * BASELINE_CPU_SEC_PER_BONE, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
