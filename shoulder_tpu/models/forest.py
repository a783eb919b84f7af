"""Vectorized random-forest inference (gather-based, fixed depth).

JAX replacement for the reference's onnxruntime TreeEnsembleClassifier
session (reference bicipital_groove.py:174-181).  Parameters are extracted
offline from the shipped ONNX by tools/extract_onnx_rf.py into dense
(tree, node) arrays; evaluation walks all trees for all samples in lockstep
for `max_depth` steps — pure gathers, no branching, vmappable and shardable.

The ONNX export (skl2onnx of an sklearn RandomForestClassifier) stores each
leaf's class distribution scaled by 1/n_trees with post_transform NONE, so
summing leaf weights over trees reproduces predict_proba exactly.
"""

from __future__ import annotations

import dataclasses
import importlib.resources
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ForestParams:
    feature: jnp.ndarray       # (T, M) int32
    value: jnp.ndarray         # (T, M) f32 thresholds
    true_child: jnp.ndarray    # (T, M) int32 (self at leaves)
    false_child: jnp.ndarray   # (T, M) int32
    leaf_weights: jnp.ndarray  # (T, M, C) f32
    max_depth: int             # static
    binary_complement: bool = False  # static: class-0 prob = 1 - class-1 sum

    def tree_flatten(self):
        return (
            (self.feature, self.value, self.true_child, self.false_child,
             self.leaf_weights),
            (self.max_depth, self.binary_complement),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, max_depth=aux[0], binary_complement=aux[1])


def load_params(npz_path=None) -> ForestParams:
    if npz_path is None:
        npz_path = (
            importlib.resources.files("shoulder_tpu")
            / "models/params/rfc_bg3.npz"
        )
    with np.load(npz_path) as z:
        return ForestParams(
            feature=jnp.asarray(z["feature"]),
            value=jnp.asarray(z["value"]),
            true_child=jnp.asarray(z["true_child"]),
            false_child=jnp.asarray(z["false_child"]),
            leaf_weights=jnp.asarray(z["leaf_weights"]),
            max_depth=int(z["max_depth"]),
            binary_complement=bool(z.get("binary_complement", False)),
        )


def _subtree_table(params: ForestParams, levels: int):
    """(T, M, C) row per node holding its depth-`levels` subtree.

    Layout per row: for each level l in [0, levels) a block of 2^l
    features then 2^l thresholds (BFS order: the node at within-subtree
    position p has children at 2p true / 2p+1 false), then the 2^levels
    level-`levels` descendant ids.  All small-int fields are exact as f32
    values (never bitcast — see ops.slicing.SortedGeom on denormals).
    Leaves self-loop (true=false=self), so a subtree that runs past a leaf
    keeps resolving to that leaf and overshooting max_depth is harmless.
    """
    T, M = params.feature.shape
    feat = params.feature.astype(jnp.float32)
    thr = params.value
    ids = jnp.broadcast_to(
        jnp.arange(M, dtype=jnp.int32)[None, :, None], (T, M, 1)
    )
    blocks = []
    for _ in range(levels):
        w = ids.shape[2]
        flat = ids.reshape(T, M * w)
        f_l = jnp.take_along_axis(feat, flat, axis=1).reshape(T, M, w)
        t_l = jnp.take_along_axis(thr, flat, axis=1).reshape(T, M, w)
        blocks += [f_l, t_l]
        tc = jnp.take_along_axis(params.true_child, flat, axis=1)
        fc = jnp.take_along_axis(params.false_child, flat, axis=1)
        ids = jnp.stack(
            [tc.reshape(T, M, w), fc.reshape(T, M, w)], axis=-1
        ).reshape(T, M, 2 * w)
    blocks.append(ids.astype(jnp.float32))
    return jnp.concatenate(blocks, axis=-1)


@partial(jax.jit, static_argnames=("levels",))
def predict_proba(params: ForestParams, x, levels: int = 3):
    """Class probabilities for samples x (R, n_features) -> (R, C).

    Matches ONNX TreeEnsembleClassifier semantics with BRANCH_LEQ nodes:
    go to the true child when x[feature] <= value.

    The lockstep descent is latency-bound (sequential rounds of (R, T)
    gathers), so each round advances `levels` tree levels off ONE gather:
    the node row packs its whole depth-`levels` subtree (tests +
    descendant ids, `_subtree_table`), the within-subtree walk is
    gather-free one-hot selects, and the round count drops from max_depth
    to ceil(max_depth / levels) — 25 -> 9 serialized gathers at levels=3
    (levels=4/5 widen the row and build 2-4x tables).  The H100 time of
    either formulation is not measured.  The sample value is
    selected by a one-hot contraction over the 9 features.  Bit-exact vs
    the level-1 descent: identical comparisons, identical f32 arithmetic.
    """
    x = jnp.asarray(x)
    n_trees, _max_nodes = params.feature.shape
    n_features = x.shape[1]

    packed = _subtree_table(params, levels)             # (T, M, C)
    fids = jnp.arange(n_features, dtype=jnp.float32)
    rounds = -(-params.max_depth // levels)

    idx = jnp.zeros((x.shape[0], n_trees), dtype=jnp.int32)
    for _ in range(rounds):
        g = jnp.take_along_axis(
            packed[None], idx[..., None, None], axis=2
        )[:, :, 0, :]                                   # (R, T, C)
        pos = jnp.zeros(idx.shape, dtype=jnp.int32)
        off = 0
        for l in range(levels):
            w = 1 << l
            f_blk = g[..., off:off + w]
            t_blk = g[..., off + w:off + 2 * w]
            off += 2 * w
            oh = pos[..., None] == jnp.arange(w)        # (R, T, w)
            f_sel = jnp.sum(jnp.where(oh, f_blk, 0.0), axis=-1)
            t_sel = jnp.sum(jnp.where(oh, t_blk, 0.0), axis=-1)
            onehot = f_sel[..., None] == fids           # (R, T, F)
            xv = jnp.sum(jnp.where(onehot, x[:, None, :], 0.0), axis=-1)
            go_true = xv <= t_sel
            pos = 2 * pos + jnp.where(go_true, 0, 1)
        w = 1 << levels
        oh = pos[..., None] == jnp.arange(w)
        ids_blk = g[..., off:off + w]
        idx = jnp.sum(jnp.where(oh, ids_blk, 0.0), axis=-1).astype(jnp.int32)

    # gather leaf class weights and sum over trees
    lw = jnp.take_along_axis(
        params.leaf_weights[None], idx[..., None, None], axis=2
    )[:, :, 0, :]  # (R, T, C)
    proba = jnp.sum(lw, axis=1)
    if params.binary_complement:
        proba = proba.at[:, 0].set(1.0 - proba[:, 1])
    return proba
