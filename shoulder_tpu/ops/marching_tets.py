"""Dense-JAX isosurface extraction: marching tetrahedra (Kuhn lattice).

The CT end-to-end path (BASELINE.json config 5) needs volume -> surface
mesh on device.  Classic marching cubes needs a 256-case triangle table;
marching tetrahedra over the translation-invariant Kuhn 6-tet subdivision
needs no tables, tiles space consistently (shared faces get matching
diagonals, so the output welds watertight), and maps cleanly onto dense
XLA: a cheap full-lattice activity pass, a compaction, and triangle
emission only for active tetrahedra.

Orientation is fixed numerically per triangle (normal points inside ->
outside), so winding is globally consistent for the downstream slice
kernel, which relies on outward normals.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Kuhn subdivision: 6 monotone corner paths (0,0,0) -> (1,1,1).
# Corner offsets per tet: v0=(0,0,0), v1=e[p0], v2=e[p0]+e[p1], v3=(1,1,1).
_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _tet_corner_offsets():
    eye = np.eye(3, dtype=np.int32)
    tets = []
    for p in _PERMS:
        v0 = np.zeros(3, np.int32)
        v1 = eye[p[0]]
        v2 = eye[p[0]] + eye[p[1]]
        v3 = np.ones(3, np.int32)
        tets.append([v0, v1, v2, v3])
    return np.asarray(tets)  # (6, 4, 3)


_TET_OFFSETS = _tet_corner_offsets()

# number of triangles for a 4-bit inside mask (popcount 0..4 -> 0,1,2,1,0
# triangles; 2-inside emits a quad = 2 triangles)
_N_TRIS = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int32
)

# per-case edge lists: each triangle is 3 edges, each edge is a (u, v)
# corner pair whose crossing point is a triangle vertex.  Cases with one
# vertex "odd one out" (masks with popcount 1 or 3) use its 3 incident
# edges; popcount-2 masks split the quad (i,k),(i,l),(j,l) + (i,k),(j,l),(j,k)
# where i,j inside and k,l outside.


def _case_edges():
    edges = np.zeros((16, 2, 3, 2), np.int32)  # (case, tri, vtx, {u,v})
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not mask >> i & 1]
        if len(inside) == 1:
            i = inside[0]
            tri = [(i, outside[0]), (i, outside[1]), (i, outside[2])]
            edges[mask, 0] = tri
        elif len(inside) == 3:
            k = outside[0]
            tri = [(k, inside[0]), (k, inside[1]), (k, inside[2])]
            edges[mask, 0] = tri
        elif len(inside) == 2:
            i, j = inside
            k, l = outside
            edges[mask, 0] = [(i, k), (i, l), (j, l)]
            edges[mask, 1] = [(i, k), (j, l), (j, k)]
    return edges


_CASE_EDGES = _case_edges()


class TriangleSoup(NamedTuple):
    triangles: jnp.ndarray  # (max_tris, 3, 3) f32
    count: jnp.ndarray      # () int32 valid triangles


@functools.partial(
    jax.jit, static_argnames=("max_active", "max_tris")
)
def marching_tets(
    volume,
    iso: float,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    max_active: int = 262144,
    max_tris: int = 393216,
) -> TriangleSoup:
    """Extract the iso-surface of a (D, H, W) scalar volume.

    "Inside" is volume > iso.  Returns a padded triangle soup in world
    coordinates (origin + index * spacing); weld on host for an indexed
    mesh (io/stl.weld).
    """
    vol = jnp.asarray(volume, jnp.float32)
    D, H, W = vol.shape
    nd, nh, nw = D - 1, H - 1, W - 1
    n_cubes = nd * nh * nw
    origin = jnp.asarray(origin, jnp.float32)
    spacing = jnp.asarray(spacing, jnp.float32)

    # 8 corner values per cube, indexed by (dz, dy, dx) offsets
    def corner(o):
        return jax.lax.dynamic_slice(vol, (o[0], o[1], o[2]), (nd, nh, nw))

    # tet corner values for all 6 tets: build per-offset corner grids once
    offset_vals = {}
    for t in range(6):
        for c in range(4):
            key = tuple(int(x) for x in _TET_OFFSETS[t, c])
            if key not in offset_vals:
                offset_vals[key] = corner(key).reshape(-1)

    # per-tet inside mask + triangle count over the full lattice
    n_total = n_cubes * 6
    masks = []
    for t in range(6):
        bits = 0
        m = jnp.zeros(n_cubes, jnp.int32)
        for c in range(4):
            key = tuple(int(x) for x in _TET_OFFSETS[t, c])
            m = m | ((offset_vals[key] > iso).astype(jnp.int32) << c)
        masks.append(m)
    mask_all = jnp.stack(masks, axis=1).reshape(-1)        # (n_cubes*6,)
    ntri_all = jnp.asarray(_N_TRIS)[mask_all]

    # compact active tets
    active = ntri_all > 0
    order = jnp.argsort(~active, stable=True)[:max_active]
    act_ids = order                                        # tet flat ids
    act_valid = active[order]
    act_mask = mask_all[order]

    cube_id = act_ids // 6
    tet_id = act_ids % 6
    ci = cube_id // (nh * nw)
    cj = (cube_id // nw) % nh
    ck = cube_id % nw
    cube_idx = jnp.stack([ci, cj, ck], axis=1)             # (A, 3) d,h,w

    # gather the 4 corner values + positions per active tet
    offs = jnp.asarray(_TET_OFFSETS)                       # (6,4,3)
    tet_offs = offs[tet_id]                                # (A,4,3)
    corner_idx = cube_idx[:, None, :] + tet_offs           # (A,4,3)
    vals = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    # world positions: index order is (z, y, x) = (d, h, w); map to xyz
    pos = (
        origin[None, None, :]
        + corner_idx[..., ::-1].astype(jnp.float32) * spacing[None, None, :]
    )                                                       # (A,4,3) xyz

    # emit up to 2 triangles per tet from the case edge table
    case_edges = jnp.asarray(_CASE_EDGES)                  # (16,2,3,2)
    e = case_edges[act_mask]                               # (A,2,3,2)
    u = e[..., 0]
    v = e[..., 1]
    a_idx = jnp.arange(act_ids.shape[0])[:, None, None]
    # canonicalize each lattice edge's interpolation direction so shared
    # edges produce bit-identical vertices in every incident tet (the host
    # weld is exact-match)
    flat_id = (
        corner_idx[..., 0] * (H * W)
        + corner_idx[..., 1] * W
        + corner_idx[..., 2]
    )                                                       # (A,4)
    id_u = flat_id[a_idx, u]
    id_v = flat_id[a_idx, v]
    swap = id_u > id_v
    u, v = jnp.where(swap, v, u), jnp.where(swap, u, v)
    val_u = vals[a_idx, u]
    val_v = vals[a_idx, v]
    denom = val_v - val_u
    denom = jnp.where(jnp.abs(denom) < 1e-20, 1.0, denom)
    t_par = (iso - val_u) / denom
    t_par = jnp.clip(t_par, 0.0, 1.0)
    p_u = pos[a_idx, u]
    p_v = pos[a_idx, v]
    tri = p_u + t_par[..., None] * (p_v - p_u)             # (A,2,3,3)

    # triangle validity
    ntri = jnp.asarray(_N_TRIS)[act_mask]
    tri_valid = (
        (jnp.arange(2)[None, :] < ntri[:, None]) & act_valid[:, None]
    )                                                       # (A,2)

    # orient: normal must point inside -> outside
    inside = ((act_mask[:, None] >> jnp.arange(4)[None, :]) & 1).astype(
        jnp.float32
    )                                                       # (A,4)
    n_in = jnp.sum(inside, axis=1, keepdims=True)
    cen_in = jnp.sum(pos * inside[..., None], axis=1) / jnp.maximum(n_in, 1)
    cen_out = jnp.sum(pos * (1 - inside)[..., None], axis=1) / jnp.maximum(
        4 - n_in, 1
    )
    grad = cen_out - cen_in                                 # (A,3)
    nrm = jnp.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    flip = jnp.sum(nrm * grad[:, None, :], axis=-1) < 0     # (A,2)
    tri = jnp.where(
        flip[..., None, None],
        tri[:, :, jnp.array([0, 2, 1]), :],
        tri,
    )

    # final compaction to (max_tris, 3, 3)
    tri_flat = tri.reshape(-1, 3, 3)
    valid_flat = tri_valid.reshape(-1)
    order2 = jnp.argsort(~valid_flat, stable=True)[:max_tris]
    out = tri_flat[order2]
    keep = valid_flat[order2]
    out = jnp.where(keep[:, None, None], out, 0.0)
    return TriangleSoup(out, jnp.minimum(jnp.sum(valid_flat), max_tris))
