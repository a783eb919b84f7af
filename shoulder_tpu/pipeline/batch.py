"""Bone batching and device placement.

Builds BoneTensors from ingested BoneSpecs, stacks them into batches, and
runs the landmark pipeline vmapped over bones — the framework's data-parallel
axis (SURVEY.md §2.4: per-bone work is independent; the batch shards over
a device mesh via shoulder_tpu.parallel).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from shoulder_tpu.config import DEFAULT_CONFIG, PipelineConfig
from shoulder_tpu.io.ingest import BoneSpec
from shoulder_tpu.models import forest
from shoulder_tpu.pipeline.landmarks import (
    BoneTensors,
    Landmarks,
    compute_landmarks,
)


def bone_tensors(spec: BoneSpec, np_only: bool = False) -> BoneTensors:
    """Per-bone tensors.  np_only keeps numpy leaves (host staging)."""
    cast = (lambda a, d: np.asarray(a, d)) if np_only else jnp.asarray
    return BoneTensors(
        verts=cast(spec.vertices, np.float32),
        faces=cast(spec.faces, np.int32),
        neighbors=cast(spec.neighbors, np.int32),
        obb_transform=cast(spec.obb_transform, np.float32),
        z_min=cast(spec.z_bounds[0], np.float32),
        z_max=cast(spec.z_bounds[1], np.float32),
        z_length=cast(spec.z_length, np.float32),
        cutoff_lo=cast(spec.cutoff_pcts[0], np.float32),
        cutoff_hi=cast(spec.cutoff_pcts[1], np.float32),
        face_orig=(
            None if spec.face_orig is None
            else cast(spec.face_orig, np.int32)
        ),
    )


def stack_bones(specs: Sequence[BoneSpec]) -> BoneTensors:
    """Stack N BoneSpecs into a leading batch dimension.

    Stacks on the host and ships the whole pytree in one device_put
    instead of one transfer per bone per field.
    """
    singles = [bone_tensors(s, np_only=True) for s in specs]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *singles)
    return jax.device_put(stacked)


class WireBones(NamedTuple):
    """Wire format for a stacked bone batch: ~40% less H2D traffic.

    `ids` packs faces(0:3) | neighbors(3:6) | face_orig(6) as uint16 —
    both id spaces fit (config.max_verts, max_faces < 2**16) and boundary
    -1 rides as 0xFFFF.  `meta` packs obb_transform.ravel() (0:16) +
    z_min, z_max, z_length, cutoff_lo, cutoff_hi (16:21).  Decode happens
    on-device inside the jitted pipeline (decode_wire): two uint16->int32
    upcasts, against ~4.5 MB saved per batch-8.  Whether the saving buys
    anything on a GPU's host link is not measured (ROADMAP 3.4).
    """

    verts: jnp.ndarray   # (B,V,3) f32, CT frame, padded
    ids: jnp.ndarray     # (B,F,7) u16
    meta: jnp.ndarray    # (B,21) f32


def stack_wire(specs: Sequence[BoneSpec]) -> WireBones:
    """Host-stack N BoneSpecs into the numpy wire format (no device work)."""
    n = len(specs)
    f = specs[0].faces.shape[0]
    v = specs[0].vertices.shape[0]
    # the uint16 wire reserves 0xFFFF as the "no neighbor" sentinel; any
    # legitimate vertex/face id must stay below it or the int32->uint16
    # cast wraps silently.  Fail loudly on misconfigured capacities.
    if f >= 0xFFFF or v >= 0xFFFF:
        raise ValueError(
            f"wire format requires max_faces/max_verts < 65535, got "
            f"faces={f}, verts={v}; use stack_bones (int32) instead"
        )
    ids = np.empty((n, f, 7), np.uint16)
    meta = np.empty((n, 21), np.float32)
    for i, s in enumerate(specs):
        if s.face_orig is None:
            raise ValueError("wire format requires presorted faces")
        ids[i, :, 0:3] = s.faces
        ids[i, :, 3:6] = np.where(s.neighbors < 0, 0xFFFF, s.neighbors)
        ids[i, :, 6] = s.face_orig
        meta[i, :16] = np.asarray(s.obb_transform, np.float32).ravel()
        meta[i, 16] = s.z_bounds[0]
        meta[i, 17] = s.z_bounds[1]
        meta[i, 18] = s.z_length
        meta[i, 19] = s.cutoff_pcts[0]
        meta[i, 20] = s.cutoff_pcts[1]
    verts = np.stack([s.vertices for s in specs]).astype(np.float32)
    return WireBones(verts=verts, ids=ids, meta=meta)


def decode_wire(w: WireBones) -> BoneTensors:
    """Traced wire -> BoneTensors decode; works batched or per-bone."""
    ids = w.ids.astype(jnp.int32)
    nbr = ids[..., 3:6]
    t = w.meta[..., :16].reshape(w.meta.shape[:-1] + (4, 4))
    return BoneTensors(
        verts=w.verts,
        faces=ids[..., 0:3],
        neighbors=jnp.where(nbr == 0xFFFF, -1, nbr),
        obb_transform=t,
        z_min=w.meta[..., 16],
        z_max=w.meta[..., 17],
        z_length=w.meta[..., 18],
        cutoff_lo=w.meta[..., 19],
        cutoff_hi=w.meta[..., 20],
        face_orig=ids[..., 6],
    )


def compute_landmarks_wire(
    wire: WireBones,
    rf: forest.ForestParams | None = None,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
) -> Landmarks:
    """vmapped landmark pipeline over a wire-format bone batch."""
    if rf is None:
        rf = forest.load_params()
    key = ("wire", proximal, cfg, chunk)
    fn = _batched_cache.get(key)
    if fn is None:
        fn = jax.jit(
            jax.vmap(
                lambda w, r: compute_landmarks(
                    decode_wire(w), r, proximal=proximal, cfg=cfg,
                    chunk=chunk,
                ),
                in_axes=(0, None),
            )
        )
        _batched_cache[key] = fn
    return fn(wire, rf)


_batched_cache = {}


def compute_landmarks_batch(
    bones: BoneTensors,
    rf: forest.ForestParams | None = None,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
) -> Landmarks:
    """vmapped landmark pipeline over a bone batch (leading dim)."""
    if rf is None:
        rf = forest.load_params()
    key = (proximal, cfg, chunk)
    fn = _batched_cache.get(key)
    if fn is None:
        fn = jax.jit(
            jax.vmap(
                lambda b, r: compute_landmarks(
                    b, r, proximal=proximal, cfg=cfg, chunk=chunk
                ),
                in_axes=(0, None),
            )
        )
        _batched_cache[key] = fn
    return fn(bones, rf)


def landmarks_to_numpy(lm: Landmarks) -> Landmarks:
    """Fetch results to host in ONE transfer (see pipeline.packing)."""
    from shoulder_tpu.pipeline import packing

    if isinstance(jax.tree.leaves(lm)[0], jax.Array):
        return packing.fetch(lm)
    return jax.tree.map(np.asarray, lm)
