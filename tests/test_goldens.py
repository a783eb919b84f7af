"""Golden-value regression guard over the reference fixtures.

Locks the round-1 validated outputs (anatomically verified: sides correct,
flip-invariant, clinically plausible — tests/test_reference_fixtures.py) so
later kernel/pipeline refactors can't silently shift results.  Tolerances
follow BASELINE.json: 0.5 mm points / 0.5 deg angles, with a little slack
for backend (CPU vs GPU) float differences.

Slow (full resolution); gated with RUN_SLOW=1.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from conftest import reference_stl

pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="slow: set RUN_SLOW=1"
)

GOLD = json.loads(
    (Path(__file__).parent / "goldens_fixtures.json").read_text()
)


@pytest.fixture(scope="module")
def landmarks():
    from shoulder_tpu.io import ingest
    from shoulder_tpu.pipeline import batch as B

    names = list(GOLD)
    specs = [ingest.load_bone(reference_stl(n)) for n in names]
    bt = B.stack_bones(specs)
    lm = B.landmarks_to_numpy(B.compute_landmarks_batch(bt, chunk=50))
    return names, lm


def test_golden_metrics(landmarks):
    names, lm = landmarks
    for i, n in enumerate(names):
        g = GOLD[n]
        assert bool(lm.side_is_left[i]) == g["side_is_left"], n
        assert lm.retroversion[i] == pytest.approx(g["retroversion"], abs=0.5), n
        assert lm.neckshaft[i] == pytest.approx(g["neckshaft"], abs=0.5), n
        assert lm.radius_curvature[i] == pytest.approx(
            g["radius_curvature"], abs=0.5
        ), n
        assert lm.neck_z[i] == pytest.approx(g["neck_z"], abs=0.75), n
        assert lm.bg_theta[i] == pytest.approx(g["bg_theta"], abs=0.02), n


def test_golden_axes(landmarks):
    names, lm = landmarks
    for i, n in enumerate(names):
        g = GOLD[n]
        assert np.allclose(lm.canal_axis[i], g["canal_axis"], atol=0.5), n
        assert np.allclose(lm.te_axis[i], g["te_axis"], atol=0.75), n
        assert np.allclose(
            lm.anp_plane_normal[i], g["anp_plane_normal"], atol=0.01
        ), n
