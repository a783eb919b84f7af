"""Single-buffer result readback.

pack() flattens any pytree of arrays into ONE float32 buffer on device;
unpack() reshapes it back on the host, so the ~25 leaves of a Landmarks
pytree come back in one device-to-host transfer instead of ~25.  Whether
that saves anything on a GPU is not measured (ROADMAP 3.4).
Integer/bool leaves round-trip exactly through f32 (all are small counts,
indices, or flags < 2^24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _spec(tree):
    leaves, treedef = jax.tree.flatten(tree)
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    return treedef, shapes, dtypes


def pack(tree):
    """Device-side: concat all leaves into one f32 vector."""
    leaves = jax.tree.leaves(tree)
    return jnp.concatenate(
        [jnp.ravel(l).astype(jnp.float32) for l in leaves]
    )


def unpack(flat: np.ndarray, tree_like):
    """Host-side: rebuild the pytree from the packed vector.

    `tree_like` provides structure/shapes/dtypes (e.g. the jax output
    itself, or a ShapeDtypeStruct pytree from jax.eval_shape).
    """
    treedef, shapes, dtypes = _spec(tree_like)
    flat = np.asarray(flat)
    out = []
    off = 0
    for shape, dtype in zip(shapes, dtypes):
        n = int(np.prod(shape)) if shape else 1
        chunk = flat[off:off + n].reshape(shape)
        out.append(chunk.astype(dtype))
        off += n
    return jax.tree.unflatten(treedef, out)


_pack_jitted = jax.jit(pack)


def fetch(tree):
    """One-round-trip device->host fetch of an arbitrary pytree."""
    flat = np.asarray(_pack_jitted(tree))
    return unpack(flat, tree)
