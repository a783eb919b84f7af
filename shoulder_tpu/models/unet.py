"""UNet for articular-surface segmentation of polar-radius images.

The reference ships an ONNX "UNet-CRF" consuming a (1,1,512,512) float32
polar-radius image and emitting a logit mask thresholded at 0 (reference
anatomic_neck.py:62-85).  Its weights are absent from the snapshot
(SURVEY.md §2.2), so shoulder_tpu re-creates the component: same interface
(512x512 normalized polar image in, >0 logit mask out), written as a pure
function over a params dict (NHWC, bf16 convolutions, GroupNorm in float32
so batch=1 inference is exact).

The same building blocks serve the 3D CT UNet (models/ct_unet.py): `forward`
is dimension-generic, and the params dict has one entry per layer:

  enc{i}/conv{j}, enc{i}/norm{j}   encoder blocks (two conv+norm+gelu)
  mid/...                          bottleneck block
  up{i}                            2x repeat-upsample conv
  dec{i}/...                       decoder blocks (after the skip concat)
  head                             1x1 logit conv

Each conv holds `kernel` (spatial..., in, out) and `bias`; each norm holds
`scale` and `bias`.  Weights ship as one flat `.npz` with "/"-joined keys
(models/params/unet.npz), trained on pipeline-extracted images of
exact-truth synthetic humeri plus the real fixtures
(tools/make_unet_corpus.py + tools/train_unet.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

FEATURES = (16, 32, 64, 128)
PARAMS_PATH = Path(__file__).parent / "params" / "unet.npz"
_EPS = 1e-6  # GroupNorm epsilon


# ------------------------------------------------------------ layers
def _conv(p, x, padding, dtype):
    """Convolution over all spatial axes, channels last, `dtype` compute."""
    x = x.astype(dtype)
    k = jnp.asarray(p["kernel"], dtype)
    nd = x.ndim - 2
    spatial = "DHW"[-nd:]
    dn = jax.lax.conv_dimension_numbers(
        x.shape, k.shape,
        (f"N{spatial}C", f"{spatial}IO", f"N{spatial}C"),
    )
    y = jax.lax.conv_general_dilated(x, k, (1,) * nd, padding,
                                     dimension_numbers=dn)
    return y + jnp.asarray(p["bias"], dtype)


def _group_norm(p, x, groups: int):
    """GroupNorm with float32 statistics and output."""
    c = x.shape[-1]
    xg = x.astype(jnp.float32).reshape(x.shape[:-1] + (groups, c // groups))
    axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
    mu = jnp.mean(xg, axes)
    var = jnp.maximum(0.0, jnp.mean(jax.lax.square(xg), axes) - mu * mu)
    expand = lambda s: jnp.expand_dims(
        jnp.repeat(s, c // groups, axis=-1), tuple(range(1, x.ndim - 1))
    )
    mul = jax.lax.rsqrt(expand(var) + _EPS) * p["scale"]
    return (x - expand(mu)) * mul + p["bias"]


def _avg_pool2(x):
    nd = x.ndim - 2
    win = (1,) + (2,) * nd + (1,)
    return jax.lax.reduce_window(x, 0.0, jax.lax.add, win, win, "VALID") / (
        2 ** nd
    )


def _upsample2(x):
    for ax in range(1, x.ndim - 1):
        x = jnp.repeat(x, 2, axis=ax)
    return x


def _pad_theta(x, k: int = 1):
    """Circular pad on the theta (W) axis: the polar image wraps at +-pi."""
    return jnp.concatenate([x[:, :, -k:], x, x[:, :, :k]], axis=2)


def _block(p, x, groups_cap: int, pre_pad: Callable | None, padding):
    """Two (conv -> GroupNorm -> gelu) stages; conv in bf16."""
    for j in range(2):
        if pre_pad is not None:
            x = pre_pad(x)
        x = _conv(p[f"conv{j}"], x, padding, jnp.bfloat16)
        x = _group_norm(p[f"norm{j}"], x,
                        min(groups_cap, x.shape[-1]))
        x = jax.nn.gelu(x)
    return x


def forward(params, x, groups_cap: int, pre_pad: Callable | None = None,
            block_padding="SAME"):
    """Encoder/decoder with skip connections, any number of spatial dims.

    x: (B, spatial..., 1).  Returns float32 logits of the same shape.
    """
    levels = sum(1 for k in params if k.startswith("enc"))
    x = x.astype(jnp.bfloat16)
    skips = []
    for i in range(levels):
        x = _block(params[f"enc{i}"], x, groups_cap, pre_pad, block_padding)
        skips.append(x)
        x = _avg_pool2(x)
    x = _block(params["mid"], x, groups_cap, pre_pad, block_padding)
    for i, skip in enumerate(reversed(skips)):
        x = _conv(params[f"up{i}"], _upsample2(x), "SAME", jnp.bfloat16)
        x = jnp.concatenate([x, skip.astype(x.dtype)], axis=-1)
        x = _block(params[f"dec{i}"], x, groups_cap, pre_pad, block_padding)
    return _conv(params["head"], x, "SAME", jnp.float32)


def init_params(key, features: Sequence[int] = FEATURES, ndim: int = 2,
                in_ch: int = 1):
    """Fresh params: lecun-normal kernels, zero biases, unit norm scales."""
    keys = iter(jax.random.split(key, 8 * len(features) + 8))

    def conv(cin, cout, k):
        shape = (k,) * ndim + (cin, cout)
        std = 1.0 / np.sqrt(cin * k ** ndim)
        w = std * jax.random.truncated_normal(next(keys), -2.0, 2.0, shape)
        return {"kernel": w / 0.87962566, "bias": jnp.zeros(cout)}

    def block(cin, cout):
        norm = {"scale": jnp.ones(cout), "bias": jnp.zeros(cout)}
        return {"conv0": conv(cin, cout, 3), "norm0": dict(norm),
                "conv1": conv(cout, cout, 3), "norm1": dict(norm)}

    params, cin = {}, in_ch
    for i, f in enumerate(features[:-1]):
        params[f"enc{i}"] = block(cin, f)
        cin = f
    params["mid"] = block(cin, features[-1])
    cin = features[-1]
    for i, f in enumerate(reversed(features[:-1])):
        params[f"up{i}"] = conv(cin, f, 2)
        params[f"dec{i}"] = block(2 * f, f)
        cin = f
    params["head"] = conv(cin, 1, 1)
    return params


def apply(params, x):
    """Articular UNet: (B, H, W, 1) image in [0, 1] -> (B, H, W, 1) logits.

    Rows are zero-padded, theta columns circularly padded: the image is a
    cylinder, and the articular arc routinely crosses the seam (the
    groove-anchored roll puts the seam 35 deg from the cap center).
    """
    return forward(params, x, 8, _pad_theta, ((1, 1), (0, 0)))


# ------------------------------------------------------------ weights
def save_params(params, path) -> None:
    flat = {
        "/".join(k.key for k in path_): np.asarray(v, np.float32)
        for path_, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    np.savez(path, **flat)


def load_params(path):
    """Params dict from a flat "/"-keyed .npz; raises if unreadable."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = params
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = np.asarray(z[key], np.float32)
    return params


_default_params_cache: list = []


def load_default_params():
    """The shipped articular-UNet weights, loaded once per process.

    A missing or unreadable file raises: the pipeline never switches
    segmenters on its own (pass `segmenter="sphere"` to run without the
    UNet).  The reference re-created its ONNX InferenceSession on every
    points() call (anatomic_neck.py:62-69); loading once is the deliberate
    fix (SURVEY.md §5 checkpoint/resume).
    """
    if not _default_params_cache:
        _default_params_cache.append(load_params(PARAMS_PATH))
    return _default_params_cache[0]


def segment_image(params, image, levels: int = 3):
    """(H, W) normalized polar image -> (H, W) float mask via the UNet.

    Pads to a multiple of 2^levels so skip connections align for any
    window size, then crops back.
    """
    h, w = image.shape
    m = 1 << levels
    ph, pw = (-h) % m, (-w) % m
    x = jnp.pad(image, ((0, ph), (0, pw)))
    logits = apply(params, x[None, :, :, None])
    return (logits[0, :h, :w, 0] > 0).astype(image.dtype)
