"""3D UNet for CT bone segmentation (the config-5 volume path).

Small NDHWC 3D UNet (bf16 convolutions, GroupNorm in float32) that maps a
normalized CT volume to per-voxel bone logits; marching tetrahedra
extracts the surface from the logits at iso 0 (pipeline/ct.py).  A pure
function over the params dict layout of models/unet.py, with plain SAME
padding on all three axes.  Trained on synthetic CT volumes rendered from
the procedural humerus (pipeline.ct.synth_ct_volume) — the classical HU
threshold remains the robust default.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

from shoulder_tpu.models import unet

FEATURES = (8, 16, 32)
PARAMS_PATH = Path(__file__).parent / "params" / "ct_unet.npz"

HU_SCALE = 1000.0


def apply(params, x):
    """(B, D, H, W, 1) normalized volume -> (B, D, H, W, 1) logits."""
    return unet.forward(params, x, 4)


def apply_volume(params, volume):
    """(D,H,W) HU volume -> (D,H,W) bone logits (pad to /4 internally)."""
    v = jnp.asarray(volume, jnp.float32) / HU_SCALE
    d, h, w = v.shape
    pad = [(0, (-s) % 4) for s in (d, h, w)]
    vp = jnp.pad(v, pad)
    logits = apply(params, vp[None, ..., None])[0, ..., 0]
    return logits[:d, :h, :w]


def train(steps: int = 200, size=(64, 48, 48), lr: float = 1e-3,
          seed: int = 0, log_every: int = 25):
    """Train on synthetic CT volumes (fresh volume per step)."""
    from shoulder_tpu.pipeline.ct import synth_ct_volume

    params = unet.init_params(jax.random.PRNGKey(seed), FEATURES, ndim=3)
    tx = optax.adamw(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, vol, label):
        def loss_fn(p):
            logits = apply(p, vol)
            return jnp.mean(
                optax.sigmoid_binary_cross_entropy(logits, label)
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        vol, _, _ = synth_ct_volume(
            shape=size, spacing=(300.0 / size[0], 1.8, 1.8),
            seed=int(rng.integers(1 << 31)),
            retroversion_deg=float(rng.uniform(10, 40)),
            neck_shaft_deg=float(rng.uniform(125, 145)),
            head_radius=float(rng.uniform(19, 27)),
            side="left" if rng.random() < 0.5 else "right",
        )
        label = (vol > 350.0).astype(np.float32)
        v = jnp.asarray(vol)[None, ..., None] / HU_SCALE
        l = jnp.asarray(label)[None, ..., None]
        params, opt_state, loss = step(params, opt_state, v, l)
        if i % log_every == 0:
            losses.append(float(loss))
            print(f"[ct_unet] step {i} loss {float(loss):.4f}", flush=True)
    return params, losses


def save_params(params, path=PARAMS_PATH) -> None:
    unet.save_params(params, path)


def load_params(path=PARAMS_PATH):
    """The shipped CT-UNet weights; raises if the file is missing."""
    return unet.load_params(path)
