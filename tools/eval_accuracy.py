"""Ground-truth accuracy eval: does the pipeline recover the generator?

The synthetic generator (io/testdata.py) takes exact neck_shaft_deg /
retroversion_deg / head_radius / side parameters.  This tool generates a
deterministic healthy cohort and an arthritic cohort, runs the DEFAULT
full-resolution pipeline, and reports the recovery error of every clinical
metric against the constructed truth — the accuracy contract the
reference's own validation prints by eyeball
(/root/reference/tests/validate_health.py:8-14).

Results are written to tools/eval_accuracy_results.json; the frozen test
bounds live in tests/test_accuracy_gate.py and PARITY.md's accuracy table.

Run:  python tools/eval_accuracy.py [n_per_cohort]
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def make_cohort(n, rng, arthritic: bool):
    """Deterministic cohort of BoneSpecs + per-bone truth dicts."""
    from shoulder_tpu.io import ingest, stl
    from shoulder_tpu.io.testdata import synthetic_humerus

    specs, truth = [], []
    i = 0
    while len(specs) < n:
        i += 1
        p = dict(
            length=float(rng.uniform(250, 310)),
            head_radius=float(rng.uniform(20, 27)),
            neck_shaft_deg=float(rng.uniform(125.0, 145.0)),
            retroversion_deg=float(rng.uniform(15.0, 40.0)),
            side="left" if rng.random() < 0.5 else "right",
        )
        deg = dict(
            head_flattening=float(rng.uniform(0.12, 0.3)),
            osteophyte_amp=float(rng.uniform(0.5, 2.5)),
            surface_noise=float(rng.uniform(0.2, 0.6)),
        ) if arthritic else {}
        v, f = synthetic_humerus(rng_transform=rng, **p, **deg)
        nbr, wt = stl.edge_face_adjacency(f)
        try:
            spec = ingest.spec_from_arrays(
                f"b{i}", v.astype(np.float32), f.astype(np.int32), nbr, wt
            )
        except ValueError:
            continue  # degenerate draw; redraw
        specs.append(spec)
        truth.append({**p, **deg})
    return specs, truth


def run_cohort(specs, segmenter=None):
    import dataclasses

    from shoulder_tpu.config import DEFAULT_CONFIG
    from shoulder_tpu.pipeline import batch as B

    cfg = DEFAULT_CONFIG if segmenter is None else dataclasses.replace(
        DEFAULT_CONFIG, segmenter=segmenter
    )
    bones = B.stack_bones(specs)
    t0 = time.perf_counter()
    lm = B.landmarks_to_numpy(
        B.compute_landmarks_batch(bones, cfg=cfg, chunk=150)
    )
    print(f"  pipeline: {time.perf_counter() - t0:.1f}s "
          f"for {len(specs)} bones", file=sys.stderr)
    return lm


def table(name, lm, truth):
    rows = []
    print(f"\n== {name} cohort ==")
    print(f"{'bone':6s} {'side':>5s} {'ns_t':>6s} {'ns':>7s} {'ns_err':>7s} "
          f"{'rv_t':>6s} {'rv':>7s} {'rv_err':>7s} "
          f"{'r_t':>5s} {'r':>6s} {'r_err':>6s}")
    for i, t in enumerate(truth):
        side_ok = (t["side"] == "left") == bool(lm.side_is_left[i])
        ns, rv, r = (float(lm.neckshaft[i]), float(lm.retroversion[i]),
                     float(lm.radius_curvature[i]))
        row = dict(
            side_ok=bool(side_ok),
            ns_truth=t["neck_shaft_deg"], ns=ns,
            ns_err=ns - t["neck_shaft_deg"],
            rv_truth=t["retroversion_deg"], rv=rv,
            rv_err=rv - t["retroversion_deg"],
            r_truth=t["head_radius"], r=r, r_err=r - t["head_radius"],
        )
        rows.append(row)
        print(f"b{i:<5d} {'ok' if side_ok else 'WRONG':>5s} "
              f"{row['ns_truth']:6.1f} {ns:7.2f} {row['ns_err']:+7.2f} "
              f"{row['rv_truth']:6.1f} {rv:7.2f} {row['rv_err']:+7.2f} "
              f"{row['r_truth']:5.1f} {r:6.2f} {row['r_err']:+6.2f}")
    summary = {}
    for k in ("ns_err", "rv_err", "r_err"):
        e = np.array([r[k] for r in rows])
        summary[k] = dict(
            mean=float(np.nanmean(e)),
            abs_mean=float(np.nanmean(np.abs(e))),
            abs_max=float(np.nanmax(np.abs(e))),
            nan=int(np.isnan(e).sum()),
        )
    summary["side_acc"] = float(np.mean([r["side_ok"] for r in rows]))
    print(f"summary: side {summary['side_acc']*100:.0f}% | "
          + " | ".join(
            f"{k} mean {summary[k]['mean']:+.2f} |max| "
            f"{summary[k]['abs_max']:.2f}" for k in
            ("ns_err", "rv_err", "r_err")))
    return rows, summary


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    # optional second arg: segmenter override ("sphere"/"unet"); results
    # only land in the committed json for the default path
    segmenter = sys.argv[2] if len(sys.argv) > 2 else None
    rng = np.random.default_rng(2026)

    out = {}
    for name, arthritic in (("healthy", False), ("arthritic", True)):
        specs, truth = make_cohort(n, rng, arthritic)
        lm = run_cohort(specs, segmenter)
        rows, summary = table(name, lm, truth)
        out[name] = dict(rows=rows, summary=summary)

    path = Path(__file__).parent / "eval_accuracy_results.json"
    if segmenter is not None:
        path = path.with_name(f"eval_accuracy_{segmenter}.json")
    path.write_text(json.dumps(out, indent=1))
    print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
