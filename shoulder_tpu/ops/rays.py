"""Batched Möller-Trumbore ray-triangle intersection (dense JAX).

Replaces the reference's rtree-backed trimesh ray engine
(reference anatomic_neck.py:184-224).  A handful of rays against ~32k
triangles is a trivially dense elementwise workload; no spatial index needed
(SURVEY.md §2.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-7


def first_hit(verts, faces, origin, direction, face_valid=None):
    """Nearest positive-t intersection of one ray with a triangle soup.

    Returns (point (3,), t, hit (bool)).  Padded faces (degenerate) never
    hit because their edge cross products vanish.
    """
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    return _first_hit_tris(v0, e1, e2, origin, direction, face_valid)


def first_hits(verts, faces, origins, directions, face_valid=None):
    """`first_hit` for a batch of rays against ONE triangle soup.

    The triangle-vertex gather (3 x F rows — the expensive part; the
    per-ray math is dense elementwise work) happens once, not once per ray.
    Returns (points (R,3), ts (R,), hits (R,)).
    """
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0

    def one(o, d):
        return _first_hit_tris(v0, e1, e2, o, d, face_valid)

    return jax.vmap(one)(jnp.asarray(origins), jnp.asarray(directions))


def _first_hit_tris(v0, e1, e2, origin, direction, face_valid=None):
    d = jnp.asarray(direction)
    o = jnp.asarray(origin)

    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=1)
    ok = jnp.abs(det) > _EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=1) * inv
    t = jnp.sum(e2 * qvec, axis=1) * inv

    hit = (
        ok
        & (u >= -_EPS)
        & (v >= -_EPS)
        & (u + v <= 1.0 + _EPS)
        & (t > 1e-5)
    )
    if face_valid is not None:
        hit = hit & face_valid
    t_masked = jnp.where(hit, t, jnp.inf)
    k = jnp.argmin(t_masked)
    any_hit = hit[k]
    point = o + t_masked[k] * d
    point = jnp.where(any_hit, point, o)
    return point, t_masked[k], any_hit
