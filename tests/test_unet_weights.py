"""Articular and CT UNets: the plain-JAX apply over the shipped .npz weights.

The goldens were frozen from the original Flax models on the CPU, with
XLA's excess-precision rewrite off: with it on, XLA may keep a bf16
convolution result in float32 across a fusion, and which fusions it
forms differs between two graphs of the same math (the Flax model
differed from itself by 1.6 logits between eager and jitted runs).  With
it off, the plain apply reproduced the Flax logits bit for bit.
"""

import jax
import numpy as np
import pytest

from shoulder_tpu.models import ct_unet, unet

UNET_GOLDEN = dict(
    logit_sum=-1621407.8859992623,
    pixels=[(0, 0, -5.360612869262695), (37, 411, -7.612048625946045),
            (128, 256, -9.055192947387695), (255, 3, -7.616472244262695),
            (300, 500, -7.64166784286499), (411, 77, -7.566187858581543),
            (500, 200, -7.416321754455566), (511, 511, -6.6241912841796875)],
    mask_count=24613, mask_index_sum=1006066278,
)
CT_GOLDEN = dict(
    logit_sum=-44767.70806066692,
    voxels=[(0, 0, 0, -0.7127957344055176), (10, 20, 5, -1.3428394794464111),
            (20, 18, 16, 0.789068877696991), (30, 5, 29, -1.3404921293258667),
            (39, 35, 31, -1.1105791330337524)],
    mask_count=6689, mask_index_sum=164137685,
)


def _exact(fn, *args):
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False}
    )
    return np.asarray(compiled(*args))


def _mask_stats(logits):
    m = (logits > 0).ravel()
    return int(m.sum()), int(np.flatnonzero(m).sum())


def test_unet_matches_flax_golden():
    from shoulder_tpu.models import unet_train

    img, _ = unet_train.synth_polar_batch(jax.random.PRNGKey(0), 1, 512)
    params = unet.load_default_params()
    lg = _exact(unet.apply, params, np.asarray(img))[0, :, :, 0]
    assert lg.astype(np.float64).sum() == pytest.approx(
        UNET_GOLDEN["logit_sum"], rel=1e-6)
    for i, j, v in UNET_GOLDEN["pixels"]:
        assert lg[i, j] == pytest.approx(v, abs=1e-5), (i, j)
    assert _mask_stats(lg) == (UNET_GOLDEN["mask_count"],
                               UNET_GOLDEN["mask_index_sum"])


def test_ct_unet_matches_flax_golden():
    from shoulder_tpu.pipeline.ct import synth_ct_volume

    vol, _, _ = synth_ct_volume(shape=(40, 36, 32), spacing=(7.5, 1.8, 1.8),
                                seed=3)
    lg = _exact(ct_unet.apply_volume, ct_unet.load_params(), vol)
    assert lg.shape == vol.shape
    assert lg.astype(np.float64).sum() == pytest.approx(
        CT_GOLDEN["logit_sum"], rel=1e-6)
    for i, j, k, v in CT_GOLDEN["voxels"]:
        assert lg[i, j, k] == pytest.approx(v, abs=1e-5), (i, j, k)
    assert _mask_stats(lg) == (CT_GOLDEN["mask_count"],
                               CT_GOLDEN["mask_index_sum"])


def test_missing_unet_weights_raise(tmp_path, monkeypatch):
    """No silent switch to the sphere segmenter: a missing file raises."""
    monkeypatch.setattr(unet, "PARAMS_PATH", tmp_path / "absent.npz")
    monkeypatch.setattr(unet, "_default_params_cache", [])
    with pytest.raises(FileNotFoundError):
        unet.load_default_params()


def test_params_roundtrip_and_init_shapes(tmp_path):
    """save/load keeps the layer tree; init matches the shipped layout."""
    shipped = unet.load_default_params()
    fresh = unet.init_params(jax.random.PRNGKey(0))
    shape = lambda t: jax.tree.map(np.shape, t)
    assert shape(fresh) == shape(shipped)
    path = tmp_path / "w.npz"
    unet.save_params(fresh, path)
    back = unet.load_params(path)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, fresh))
    ct_fresh = unet.init_params(jax.random.PRNGKey(0), ct_unet.FEATURES,
                                ndim=3)
    assert shape(ct_fresh) == shape(ct_unet.load_params())
