"""Measure the persistent compile cache: cold vs warm time-to-first-landmark.

Runs the single-bone landmark pipeline (the reference's whole use case,
README.md:22-41) on a seeded synthetic bone in THREE fresh processes, one
after the other (one JAX process on the card at a time; this parent
process never initializes a backend):

  1. cold   — cache dir emptied first: full compile + run
  2. warm   — second process: deserializes the executable
  3. warm2  — third process: confirms steady state

and prints the wall-clock time-to-first-landmark of each as JSON.  The
cache dir is `JAX_COMPILATION_CACHE_DIR` if set, else the fixed
`<checkout>/.jax_cache/measure`.  Runs on the GPU and fails without one,
unless `--backend cpu` is given.

Run:  python tools/measure_compile_cache.py [--backend gpu|cpu]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
if {backend!r} == "cpu":
    from shoulder_tpu.utils.platform import force_cpu
    force_cpu()
import jax
import smoke_checks as smoke
from shoulder_tpu.pipeline import batch as B
if {backend!r} != "cpu":
    smoke.require_gpu()
_, _, specs, _ = smoke.healthy_cohort(1, 2026)
bones = jax.block_until_ready(B.stack_bones(specs))
t1 = time.perf_counter()
lm = B.landmarks_to_numpy(B.compute_landmarks_batch(bones, chunk=50))
t2 = time.perf_counter()
print("CHILD_RESULT", t1 - t0, t2 - t1, float(lm.neckshaft[0]))
"""


def run_child(backend: str, env: dict) -> dict:
    code = CHILD.format(root=str(ROOT), backend=backend)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=1800, env=env)
    wall = time.perf_counter() - t0
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("CHILD_RESULT")]
    if r.returncode or not line:
        raise RuntimeError(f"child failed:\n{r.stderr[-2000:]}")
    _, t_setup, t_pipe, ns = line[0].split()
    return dict(wall_s=wall, setup_s=float(t_setup),
                pipeline_s=float(t_pipe), neckshaft=float(ns))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args()

    env = dict(os.environ)
    cache = Path(env.get("JAX_COMPILATION_CACHE_DIR")
                 or ROOT / ".jax_cache" / "measure")
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    env.pop("SHOULDER_TPU_CACHE", None)
    if cache.exists():
        shutil.rmtree(cache)
    print(f"[cache] emptied {cache}", flush=True)

    out = {"backend": args.backend}
    for name in ("cold", "warm", "warm2"):
        out[name] = res = run_child(args.backend, env)
        print(f"[{name:5s}] wall {res['wall_s']:7.1f} s  (setup "
              f"{res['setup_s']:.1f}, pipeline {res['pipeline_s']:.1f})  "
              f"ns={res['neckshaft']}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
