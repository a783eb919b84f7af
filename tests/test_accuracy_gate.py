"""Ground-truth accuracy gate (VERDICT r3 item 1).

The synthetic generator REALIZES its parameters exactly (io/testdata.py:
the articular surface is a spherical cap cut by the parametric plane, with
a geometric crease at the rim), so the full-resolution DEFAULT pipeline
must recover neck-shaft / retroversion / radius / side to within the
frozen bounds below.  Goldens lock stability; THIS test locks correctness:
a regression that biases neck-shaft by 3 degrees fails here even if every
golden still matches (the reference's de-facto accuracy contract is the
printed metrics of /root/reference/tests/validate_health.py:8-14).

Bounds were measured on the round-5 build (retrained articular UNet +
plausibility-gated support; `tools/eval_accuracy.py 8`, committed results
in tools/eval_accuracy_results.json and the PARITY.md accuracy table):

  healthy  : ns 1.45 / rv 0.49 / rad 0.21 |max|; means -1.20/-0.27/-0.18
  arthritic: ns 26.45 / rv 19.52 / rad 2.81 |max| (one outlier bone with
             head_flattening 0.29; 7/8 bones within 9.0/9.4/2.8);
             means +1.34/-0.13/+0.83

The |max| bounds carry ~25-100% headroom over those measurements.  The
MEAN bounds are deliberately tight: the round-4 regression mode was a
systematic -25 deg neck-shaft BIAS that a generous per-bone max would
never catch — a biased build must fail here even if no single bone is
catastrophic.  (Arthritic radius truth is structurally ambiguous: the
generator's flattening deforms the head away from its nominal radius, so
the radius columns measure precision, not pure recovery.)

Slow (full-resolution cohorts on CPU): gated behind RUN_SLOW=1.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="slow: set RUN_SLOW=1"
)

N_PER_COHORT = 8

# frozen recovery bounds (degrees / mm); measurements in the docstring
BOUNDS = {
    "healthy": dict(ns=3.0, rv=4.0, rad=1.5, mean_ns=2.0, mean_rv=2.0),
    "arthritic": dict(ns=30.0, rv=25.0, rad=3.5, mean_ns=5.0, mean_rv=5.0),
}


@pytest.fixture(scope="module", params=["healthy", "arthritic"])
def cohort(request):
    from shoulder_tpu.io.testdata import exact_truth_cohorts
    from shoulder_tpu.pipeline import batch as B

    arthritic = request.param == "arthritic"
    # same deterministic draw as tools/eval_accuracy.py: healthy first,
    # arthritic second, one shared generator stream
    cohorts = exact_truth_cohorts(N_PER_COHORT, seed=2026)
    _, _, specs, truth = cohorts[1] if arthritic else cohorts[0]
    lm = B.landmarks_to_numpy(
        B.compute_landmarks_batch(B.stack_bones(specs), chunk=150)
    )
    return request.param, truth, lm


def test_side_recovery(cohort):
    kind, truth, lm = cohort
    for i, t in enumerate(truth):
        assert (t["side"] == "left") == bool(lm.side_is_left[i]), (
            f"{kind} bone {i}: side {t['side']} not recovered"
        )


def test_neckshaft_recovery(cohort):
    kind, truth, lm = cohort
    err = np.asarray(lm.neckshaft) - np.array(
        [t["neck_shaft_deg"] for t in truth]
    )
    assert np.isfinite(err).all(), f"{kind}: non-finite neckshaft"
    assert np.max(np.abs(err)) < BOUNDS[kind]["ns"], (
        f"{kind} neckshaft errors {np.round(err, 2)}"
    )
    assert abs(np.mean(err)) < BOUNDS[kind]["mean_ns"], (
        f"{kind} neckshaft BIAS {np.mean(err):+.2f} "
        f"(errors {np.round(err, 2)})"
    )


def test_retroversion_recovery(cohort):
    kind, truth, lm = cohort
    err = np.asarray(lm.retroversion) - np.array(
        [t["retroversion_deg"] for t in truth]
    )
    assert np.isfinite(err).all(), f"{kind}: non-finite retroversion"
    assert np.max(np.abs(err)) < BOUNDS[kind]["rv"], (
        f"{kind} retroversion errors {np.round(err, 2)}"
    )
    assert abs(np.mean(err)) < BOUNDS[kind]["mean_rv"], (
        f"{kind} retroversion BIAS {np.mean(err):+.2f} "
        f"(errors {np.round(err, 2)})"
    )


def test_radius_recovery(cohort):
    kind, truth, lm = cohort
    err = np.asarray(lm.radius_curvature) - np.array(
        [t["head_radius"] for t in truth]
    )
    assert np.isfinite(err).all(), f"{kind}: non-finite radius"
    assert np.max(np.abs(err)) < BOUNDS[kind]["rad"], (
        f"{kind} radius errors {np.round(err, 2)}"
    )
