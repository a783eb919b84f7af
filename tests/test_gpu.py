"""Card-side checks: the chip_smoke.py phases as tests.

Marked `gpu`; they skip on the CPU suite and run on a machine with an
NVIDIA GPU under

    SHOULDER_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu.py

The checks themselves live in smoke_checks.py, which chip_smoke.py
runs too.
"""

import pytest

import smoke_checks as smoke

pytestmark = pytest.mark.gpu

SEED = 2026


@pytest.fixture(scope="module")
def gpu():
    try:
        return smoke.require_gpu()
    except RuntimeError as e:
        pytest.skip(str(e))


@pytest.fixture(scope="module")
def proximal_stack(gpu):
    _, _, specs, _ = smoke.healthy_cohort(1, SEED)
    return smoke.check_slice_stack(specs[0])


def test_precision_pinned(gpu):
    smoke.check_precision()


def test_find_peaks_vs_scipy(proximal_stack):
    smoke.check_find_peaks(proximal_stack)


def test_unet_gpu_vs_cpu(proximal_stack):
    smoke.check_unet(proximal_stack)


def test_forest_vs_numpy(gpu):
    smoke.check_forest(SEED)


def test_facade(gpu):
    smoke.phase_facade(SEED)


def test_batch_recovery_and_cpu_agreement(gpu):
    smoke.phase_batch(SEED)
