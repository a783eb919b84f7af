"""Device-mesh sharding for bone batches.

The framework's scaling story (SURVEY.md §2.4): the bone batch is the data-
parallel axis.  Per-bone work is fully independent, so the batched pipeline
shards the leading dimension of every BoneTensors leaf over a 1D 'bone'
mesh and each device runs the one-device program on its shard; the hot
path holds no cross-device collective, and results gather to the host on
readback.  Only the optional cohort statistics talk across devices (the
psum in cohort_stats).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shoulder_tpu.config import DEFAULT_CONFIG, PipelineConfig
from shoulder_tpu.models import forest
from shoulder_tpu.pipeline.batch import decode_wire
from shoulder_tpu.pipeline.landmarks import BoneTensors, compute_landmarks


def bone_mesh(devices=None, axis: str = "bone") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_bones(bones, mesh: Mesh, axis: str = "bone"):
    """Place a stacked bone batch with the bone dim sharded.

    Accepts any bone-batch pytree whose leaves are batched on axis 0 —
    a stacked BoneTensors or the cohort's WireBones NamedTuple alike.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), bones)


def sharded_landmark_fn(
    mesh: Mesh,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
    axis: str = "bone",
    wire: bool = False,
):
    """jit-compiled batched pipeline over a bone-sharded batch.

    Each device runs the one-device batched program on its own shard of
    bones (`shard_map`), so the partitioner has nothing to decide and the
    program holds no collective.  With `wire=True` the input is a
    pipeline.batch.WireBones batch (the compact uint16 wire format);
    decode happens per-shard on-device.
    """

    def local(bones, rf):
        return jax.vmap(
            lambda b: compute_landmarks(
                decode_wire(b) if wire else b, rf,
                proximal=proximal, cfg=cfg, chunk=chunk),
        )(bones)

    # a single spec broadcasts across each argument's whole pytree
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis), P()), out_specs=P(axis),
    ))


def cohort_stats(landmarks, mesh: Mesh, axis: str = "bone"):
    """Cross-bone cohort statistics as an explicit SPMD collective.

    Each device reduces its local shard of the bone batch to (count, sum,
    sum-of-squares) per metric, then a `jax.lax.psum` over the bone axis
    combines the partial moments across devices — one small all-reduce
    instead of gathering per-bone values to one device.  NaN lanes (isolated
    failed bones) are excluded from the moments, so one bad bone cannot
    poison the cohort numbers.  Returns replicated scalars:
    mean/std/n per metric plus the left-side fraction.
    """
    fn = _cohort_stats_fn(mesh, axis)
    return fn(landmarks.retroversion, landmarks.neckshaft,
              landmarks.radius_curvature, landmarks.side_is_left)


def _cohort_stats_fn(mesh: Mesh, axis: str = "bone"):
    """The jitted shard_map program behind cohort_stats (exposed so tests
    can assert the psum collective is present in the jaxpr)."""
    spec = P(axis)

    def local(retro, ns, rad, left):
        def moments(x):
            ok = jnp.isfinite(x)
            parts = jnp.stack([
                jnp.sum(ok.astype(jnp.float32)),
                jnp.sum(jnp.where(ok, x, 0.0)),
            ])
            n, s = jax.lax.psum(parts, axis)
            mean = s / jnp.maximum(n, 1.0)
            # two-pass (mean-shifted) variance: the one-pass E[x^2]-mean^2
            # form catastrophically cancels in f32 at anatomical scales
            # (XLA fuses mean*mean into an fma, so a cohort of IDENTICAL
            # ~114-deg values returned std ~0.04 instead of 0); centering
            # first costs one extra psum of a scalar and is exact where it
            # matters
            d2 = jnp.sum(jnp.where(ok, (x - mean) ** 2, 0.0))
            var = jax.lax.psum(d2, axis) / jnp.maximum(n, 1.0)
            return mean, jnp.sqrt(var), n

        out = {}
        for name, x in (("retroversion", retro), ("neckshaft", ns),
                        ("radius", rad)):
            mean, std, n = moments(x)
            out[f"mean_{name}"] = mean
            out[f"std_{name}"] = std
            out[f"n_{name}"] = n
        nl = jax.lax.psum(
            jnp.stack([jnp.sum(left.astype(jnp.float32)),
                       jnp.asarray(float(left.shape[0]), jnp.float32)]),
            axis,
        )
        out["left_fraction"] = nl[0] / jnp.maximum(nl[1], 1.0)
        return out

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=P(),
    ))
