"""Segmenter A/B: sphere-consensus vs UNet(+consensus refinement).

Runs the full landmark pipeline over the reference fixtures twice — once
with segmenter="sphere", once with segmenter="unet" — and prints the
per-fixture metric deltas.  The round-2 acceptance bar (round-2 verdict,
item 2): all four fixtures within 0.5 deg / 0.5 mm.

Run:  python tools/eval_segmenter.py [stl ...]
"""

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

FIXTURES = sorted(
    Path("/root/reference/tests/test_bones").glob("*.stl")
)


def run(cfg, specs):
    from shoulder_tpu.pipeline import batch as B

    bones = B.stack_bones(specs)
    lm = B.compute_landmarks_batch(bones, cfg=cfg)
    return B.landmarks_to_numpy(lm)


def main():
    paths = [Path(p) for p in sys.argv[1:]] or FIXTURES
    from shoulder_tpu.config import DEFAULT_CONFIG
    from shoulder_tpu.io import ingest
    from shoulder_tpu.models import unet

    unet.load_default_params()  # raises if the weights are missing

    specs = [ingest.load_bone(p) for p in paths]
    cfg_s = dataclasses.replace(DEFAULT_CONFIG, segmenter="sphere")
    cfg_u = dataclasses.replace(DEFAULT_CONFIG, segmenter="unet")
    lm_s = run(cfg_s, specs)
    lm_u = run(cfg_u, specs)

    worst = {"neckshaft": 0.0, "retroversion": 0.0, "radius": 0.0}
    print(f"{'fixture':28s} {'d_neckshaft':>12s} {'d_retro':>9s} "
          f"{'d_radius':>9s} {'mask_s':>7s} {'mask_u':>7s}")
    for i, p in enumerate(paths):
        dns = float(abs(lm_u.neckshaft[i] - lm_s.neckshaft[i]))
        drv = float(abs(lm_u.retroversion[i] - lm_s.retroversion[i]))
        drd = float(abs(lm_u.radius_curvature[i] - lm_s.radius_curvature[i]))
        worst["neckshaft"] = max(worst["neckshaft"], dns)
        worst["retroversion"] = max(worst["retroversion"], drv)
        worst["radius"] = max(worst["radius"], drd)
        print(f"{p.stem:28s} {dns:12.3f} {drv:9.3f} {drd:9.3f} "
              f"{float(lm_s.qc_mask_area_frac[i]):7.3f} "
              f"{float(lm_u.qc_mask_area_frac[i]):7.3f}")
    ok = (worst["neckshaft"] < 0.5 and worst["retroversion"] < 0.5
          and worst["radius"] < 0.5)
    print(f"worst: {worst}  ->  {'PASS' if ok else 'FAIL'} "
          "(bar: 0.5 deg / 0.5 mm)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
