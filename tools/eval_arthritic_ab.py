"""Arthritic-cohort A/B: sphere-consensus vs UNet-seeded consensus.

Generates a deterministic synthetic arthritic cohort (flattened domes,
osteophytes, surface noise — the BASELINE config-4 stress case), runs the
full pipeline with both segmenters, and reports per-bone metric deltas
from the bone's own healthy ground truth (the generator's neck-shaft /
retroversion parameters are known), plus QC stats.  This quantifies what
the learned seed buys when the top-rows heuristic's assumption (the top
of the image is articular) degrades.

Run:  python tools/eval_arthritic_ab.py [n_bones]
"""

import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8

    from shoulder_tpu.config import DEFAULT_CONFIG
    from shoulder_tpu.io import ingest, stl
    from shoulder_tpu.io.testdata import synthetic_humerus
    from shoulder_tpu.models import unet
    from shoulder_tpu.pipeline import batch as B

    unet.load_default_params()  # raises if the weights are missing

    rng = np.random.default_rng(42)
    specs, truth = [], []
    i = 0
    while len(specs) < n:
        i += 1
        ns = float(rng.uniform(125.0, 145.0))
        rv = float(rng.uniform(15.0, 40.0))
        v, f = synthetic_humerus(
            length=float(rng.uniform(250, 310)),
            head_radius=float(rng.uniform(20, 27)),
            neck_shaft_deg=ns,
            retroversion_deg=rv,
            groove_theta_deg=float(rng.uniform(-180, 180)),
            side="left" if rng.random() < 0.5 else "right",
            rng_transform=rng,
            head_flattening=float(rng.uniform(0.12, 0.3)),
            osteophyte_amp=float(rng.uniform(0.5, 2.5)),
            surface_noise=float(rng.uniform(0.2, 0.6)),
        )
        nbr, wt = stl.edge_face_adjacency(f)
        try:
            spec = ingest.spec_from_arrays(
                f"arth{i}", v.astype(np.float32), f.astype(np.int32), nbr, wt
            )
        except ValueError:
            continue
        specs.append(spec)
        truth.append((ns, rv))

    bones = B.stack_bones(specs)
    out = {}
    for seg in ("sphere", "unet"):
        cfg = dataclasses.replace(DEFAULT_CONFIG, segmenter=seg)
        lm = B.landmarks_to_numpy(B.compute_landmarks_batch(bones, cfg=cfg))
        out[seg] = lm

    print(f"{'bone':8s} {'truth_ns':>8s} "
          f"{'sph_ns':>8s} {'unet_ns':>8s} {'sph_resid':>9s} {'unet_resid':>10s}")
    errs = {"sphere": [], "unet": []}
    for i, (ns, rv) in enumerate(truth):
        row = [f"arth{i:<4d}", f"{ns:8.1f}"]
        for seg in ("sphere", "unet"):
            v = float(out[seg].neckshaft[i])
            errs[seg].append(abs(v - ns) if np.isfinite(v) else np.nan)
            row.append(f"{v:8.1f}")
        row.append(f"{float(out['sphere'].qc_sphere_resid[i]):9.2f}")
        row.append(f"{float(out['unet'].qc_sphere_resid[i]):10.2f}")
        print(" ".join(row))
    for seg in ("sphere", "unet"):
        e = np.asarray(errs[seg])
        print(f"{seg:7s}: neck-shaft |err| mean {np.nanmean(e):.2f} deg, "
              f"max {np.nanmax(e):.2f}, NaN {int(np.isnan(e).sum())}/{n}, "
              f"mean resid {np.nanmean(out[seg].qc_sphere_resid):.2f} mm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
