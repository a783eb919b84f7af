"""Host-side minimum-volume oriented bounding box.

Replaces trimesh's `apply_obb` (reference mesh.py:82,144).  Algorithm: convex
hull (qhull), then for every hull-face normal the exact 2D minimum-area
rectangle of the projected hull (rotating over hull-edge directions), keeping
the minimum-volume box.  This matches trimesh.bounds.oriented_bounds'
strategy, including the convention that the returned transform carries the
mesh to a frame whose AABB is centered at the origin with extents sorted
ascending (x smallest, z largest) — the reference's downstream code depends
on z being the long axis of the humerus (mesh.py:85-117).

OBB runs once per bone at ingest on the host; it is not on the device hot
path (SURVEY.md §7 build order, stage 3).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull


def _min_area_rect_2d(pts2d: np.ndarray):
    """Exact minimum-area rectangle of a 2D point set.

    Returns (area, u, v, (umin, umax, vmin, vmax)) where u/v are the unit
    rectangle axes in the input frame.
    """
    hull = ConvexHull(pts2d)
    hp = pts2d[hull.vertices]
    edges = np.roll(hp, -1, axis=0) - hp
    lens = np.linalg.norm(edges, axis=1)
    keep = lens > 1e-15
    dirs = edges[keep] / lens[keep, None]
    # rectangle aligned to each hull edge direction
    us = dirs
    vs = np.stack([-dirs[:, 1], dirs[:, 0]], axis=1)
    pu = hp @ us.T  # (H, E)
    pv = hp @ vs.T
    du = pu.max(axis=0) - pu.min(axis=0)
    dv = pv.max(axis=0) - pv.min(axis=0)
    areas = du * dv
    k = int(np.argmin(areas))
    return (
        float(areas[k]),
        us[k],
        vs[k],
        (pu[:, k].min(), pu[:, k].max(), pv[:, k].min(), pv[:, k].max()),
    )


def _native_search(hp: np.ndarray, normals: np.ndarray, hull=None):
    """Native min-volume box search (csrc/obb.cpp); None if unavailable.

    Same arithmetic as the numpy loop below (the oracle), in double
    precision.  When the ConvexHull object is provided, the per-candidate
    2D hull is computed as the polytope SILHOUETTE (front/back facet
    classification over the hull adjacency) instead of a fresh point-set
    hull — measured ~334 ms -> ~60 ms per humerus on one host core;
    ingest throughput can gate cohort streaming (ROADMAP 1.7).
    """
    import ctypes

    from shoulder_tpu.io import native as native_mod

    lib = native_mod._load()
    if lib is None or not hasattr(lib, "shoulder_min_volume_obb"):
        return None
    hp = np.ascontiguousarray(hp, np.float64)
    nrm = np.ascontiguousarray(normals, np.float64)
    axes = np.empty((3, 3), np.float64)
    lo = np.empty(3, np.float64)
    hi = np.empty(3, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)

    if hull is not None and hasattr(lib, "shoulder_min_volume_obb_sil"):
        # remap simplices to hull-vertex indices and orient them CCW as
        # seen from outside (qhull's simplex winding is arbitrary; the
        # outward direction is authoritative in `equations`)
        inv = np.full(hull.points.shape[0], -1, np.int64)
        inv[hull.vertices] = np.arange(hull.vertices.shape[0])
        simp = inv[hull.simplices]
        eqs = hull.equations[:, :3]
        tri = hp[simp]
        winding = np.einsum(
            "ij,ij->i",
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
            eqs,
        )
        flip = winding < 0
        simp[flip] = simp[flip][:, [0, 2, 1]]
        nbr = np.array(hull.neighbors)
        nbr[flip] = nbr[flip][:, [0, 2, 1]]
        simp = np.ascontiguousarray(simp, np.int32)
        nbr = np.ascontiguousarray(nbr, np.int32)
        fnorm = np.ascontiguousarray(eqs, np.float64)
        fn = lib.shoulder_min_volume_obb_sil
        fn.restype = ctypes.c_int
        rc = fn(
            hp.ctypes.data_as(dp), ctypes.c_int32(hp.shape[0]),
            simp.ctypes.data_as(ip), nbr.ctypes.data_as(ip),
            fnorm.ctypes.data_as(dp), ctypes.c_int32(simp.shape[0]),
            nrm.ctypes.data_as(dp), ctypes.c_int32(nrm.shape[0]),
            axes.ctypes.data_as(dp), lo.ctypes.data_as(dp),
            hi.ctypes.data_as(dp),
        )
        if rc == 0:
            return axes, lo, hi

    fn = lib.shoulder_min_volume_obb
    fn.restype = ctypes.c_int
    rc = fn(
        hp.ctypes.data_as(dp), ctypes.c_int32(hp.shape[0]),
        nrm.ctypes.data_as(dp), ctypes.c_int32(nrm.shape[0]),
        axes.ctypes.data_as(dp), lo.ctypes.data_as(dp),
        hi.ctypes.data_as(dp),
    )
    if rc != 0:
        return None
    return axes, lo, hi


def oriented_bounds(vertices: np.ndarray):
    """Minimum-volume OBB.

    Returns (to_obb (4,4), extents (3,)): `to_obb` maps mesh coordinates to
    the OBB frame (centered, axis-aligned, extents ascending x<=y<=z,
    right-handed).
    """
    hull = ConvexHull(vertices)
    hp = vertices[hull.vertices]
    normals = hull.equations[:, :3]
    # dedupe face normals (qhull triangulates coplanar faces)
    normals = np.unique(np.round(normals, 6), axis=0)

    res = _native_search(hp, normals, hull=hull)
    if res is not None:
        axes, lo, hi = res
    else:
        best = None
        for n in normals:
            n = n / np.linalg.norm(n)
            # in-plane basis
            helper = np.eye(3)[np.argmin(np.abs(n))]
            a = np.cross(helper, n)
            a /= np.linalg.norm(a)
            b = np.cross(n, a)
            proj = hp @ np.stack([a, b], axis=1)  # (H,2)
            h = hp @ n
            area, u2, v2, (umin, umax, vmin, vmax) = _min_area_rect_2d(proj)
            depth = h.max() - h.min()
            volume = area * depth
            if best is None or volume < best[0]:
                u3 = u2[0] * a + u2[1] * b
                v3 = v2[0] * a + v2[1] * b
                axes = np.stack([u3, v3, n], axis=0)  # rows: world->obb
                lo = np.array([umin, vmin, h.min()])
                hi = np.array([umax, vmax, h.max()])
                best = (volume, axes, lo, hi)
        _, axes, lo, hi = best
    extents = hi - lo
    center_obb = (lo + hi) / 2.0

    # sort so extents ascend (z = long axis), then enforce right-handedness
    order = np.argsort(extents)
    axes = axes[order]
    extents = extents[order]
    center_obb = center_obb[order]
    if np.linalg.det(axes) < 0:
        axes[0] *= -1.0
        center_obb[0] *= -1.0

    to_obb = np.eye(4)
    to_obb[:3, :3] = axes
    to_obb[:3, 3] = -center_obb
    return to_obb, extents
