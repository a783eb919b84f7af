"""End-to-end streamed-cohort benchmark: 64 bones incl. host ingest.

Times `shoulder_tpu.cohort.process_cohort` over the 4 reference fixtures
replicated x16 (= 64 bones), batch_size 8; the first pass pays
compilation; the second (reported) pass is warm but still re-ingests
every STL from disk.  Runs on the current device (H100: not measured).  Run:  python tools/bench_cohort.py [repeats_per_fixture] [batch_size]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FIXTURES = [
    "humerus_left.stl",
    "humerus_left_flipped.stl",
    "humerus_right.stl",
    "humerus_left_trab.stl",
]


def main():
    from shoulder_tpu import cohort

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    base = Path("/root/reference/tests/test_bones")
    paths = [str(base / f) for f in FIXTURES for _ in range(reps)]
    print(f"[cohort] {len(paths)} bones, batch_size {batch_size}")

    t0 = time.perf_counter()
    out = cohort.process_cohort(paths, batch_size=batch_size)
    t1 = time.perf_counter()
    assert len(out) == len(paths)
    print(f"[cohort] cold (compile) pass: {t1 - t0:.1f} s")

    t0 = time.perf_counter()
    out = cohort.process_cohort(paths, batch_size=batch_size)
    t1 = time.perf_counter()
    wall = t1 - t0
    print(
        f"[cohort] warm pass: {wall:.1f} s = "
        f"{len(paths) / wall:.2f} bones/s end-to-end incl. ingest"
    )
    stats = cohort.cohort_summary(out)
    print(f"[cohort] summary: {stats}")


if __name__ == "__main__":
    main()
