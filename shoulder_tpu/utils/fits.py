"""Least-squares geometric fits (JAX, weight-mask aware).

These replace the reference's third-party fitters with jnp.linalg equivalents
(SURVEY.md §2.3):
  * line/plane best-fit  <- skspatial Line/Plane.best_fit (PCA/SVD),
    used at reference canal.py:66, anatomic_neck.py:128,
    bicipital_groove.py:252
  * circle               <- circle_fit.least_squares_circle (mesh.py:102)
  * ellipse              <- lsq-ellipse LsqEllipse (anatomic_neck.py:141)
  * sphere               <- reference bone_props._spherefit (bone_props.py:126)

Every fit takes an optional per-point weight vector so padded/masked batches
fit cleanly under vmap with static shapes.
"""

from __future__ import annotations

import jax.numpy as jnp


def _weights(pts, w):
    if w is None:
        return jnp.ones(pts.shape[0], dtype=pts.dtype)
    return jnp.asarray(w, dtype=pts.dtype)


def _weighted_mean(pts, w):
    return jnp.sum(pts * w[:, None], axis=0) / jnp.sum(w)


def _null3(a):
    """Unit null-space vector of a (numerically) rank-2 symmetric 3x3."""
    c01 = jnp.cross(a[0], a[1])
    c02 = jnp.cross(a[0], a[2])
    c12 = jnp.cross(a[1], a[2])
    cands = jnp.stack([c01, c02, c12])
    norms = jnp.linalg.norm(cands, axis=1)
    v = cands[jnp.argmax(norms)]
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)


def eigh3(a):
    """Analytic eigendecomposition of a symmetric 3x3 matrix.

    Returns (vals(3,), vecs(3,3)) in ascending order, the same convention
    as jnp.linalg.eigh (eigenvector signs are arbitrary in both).  The
    trigonometric closed form replaces eigh's iterative decomposition
    (a solver call per fit) with a few fused elementwise ops; the
    line/plane fits run once per landmark stage.
    """
    a = jnp.asarray(a)
    q = jnp.trace(a) / 3.0
    a_q = a - q * jnp.eye(3, dtype=a.dtype)
    p2 = jnp.sum(a_q * a_q) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    r = jnp.clip(jnp.linalg.det(a_q) / (2.0 * p**3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    hi = q + 2.0 * p * jnp.cos(phi)
    lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    mid = 3.0 * q - hi - lo
    vals = jnp.stack([lo, mid, hi])

    eye = jnp.eye(3, dtype=a.dtype)
    v_hi = _null3(a - hi * eye)
    v_lo = _null3(a - lo * eye)
    v_mid = jnp.cross(v_hi, v_lo)
    v_mid = v_mid / jnp.maximum(jnp.linalg.norm(v_mid), 1e-30)
    vecs = jnp.stack([v_lo, v_mid, v_hi], axis=1)
    # degenerate (near-spherical) scatter: any orthonormal basis is valid
    degenerate = p2 < 1e-20
    vals = jnp.where(degenerate, jnp.full(3, q, a.dtype), vals)
    vecs = jnp.where(degenerate, eye, vecs)
    return vals, vecs


def fit_line(pts, w=None):
    """Best-fit 3D line through points: returns (point, direction).

    direction is the principal right-singular vector of the centered points,
    matching skspatial.objects.Line.best_fit (reference canal.py:66).
    """
    pts = jnp.asarray(pts)
    w = _weights(pts, w)
    center = _weighted_mean(pts, w)
    x = (pts - center) * jnp.sqrt(w)[:, None]
    # principal eigenvector of the 3x3 scatter matrix (cheaper + more stable
    # under vmap than a full SVD of (N,3)); analytic solver — see eigh3
    cov = x.T @ x
    _, vecs = eigh3(cov)
    direction = vecs[:, -1]
    return center, direction


def fit_plane(pts, w=None):
    """Best-fit plane: returns (point, normal); normal is the least-principal
    eigenvector, matching skspatial Plane.best_fit (anatomic_neck.py:128)."""
    pts = jnp.asarray(pts)
    w = _weights(pts, w)
    center = _weighted_mean(pts, w)
    x = (pts - center) * jnp.sqrt(w)[:, None]
    cov = x.T @ x
    _, vecs = eigh3(cov)
    normal = vecs[:, 0]
    return center, normal


def fit_circle(pts2d, w=None):
    """Least-squares (Kasa/Coope) circle fit: returns (cx, cy, r, residu).

    residu is the sum of squared radial deviations, matching
    circle_fit.least_squares_circle's residual (reference mesh.py:102).
    """
    pts2d = jnp.asarray(pts2d)
    w = _weights(pts2d, w)
    mean = _weighted_mean(pts2d, w)
    x, y = pts2d[:, 0] - mean[0], pts2d[:, 1] - mean[1]
    a = jnp.stack([x, y, jnp.ones_like(x)], axis=1) * w[:, None]
    b = (x**2 + y**2) * w
    sol, *_ = jnp.linalg.lstsq(a, b)
    cx = sol[0] / 2.0
    cy = sol[1] / 2.0
    r = jnp.sqrt(sol[2] + cx**2 + cy**2)
    dist = jnp.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    residu = jnp.sum(w * (dist - r) ** 2)
    return cx + mean[0], cy + mean[1], r, residu


def fit_sphere(pts, w=None):
    """Algebraic sphere fit: returns (radius, center).

    Same linear system as reference bone_props._spherefit
    (bone_props.py:126-148): [2x 2y 2z 1] c = x^2+y^2+z^2 — but solved on
    mean-centered points: at bone-scale coordinates the uncentered system
    loses the radius to float32 cancellation.
    """
    pts = jnp.asarray(pts)
    w = _weights(pts, w)
    mean = _weighted_mean(pts, w)
    q = pts - mean
    a = jnp.concatenate([2.0 * q, jnp.ones((q.shape[0], 1), q.dtype)], axis=1)
    f = jnp.sum(q**2, axis=1)
    # centered normal equations: stable in f32 and much cheaper than an
    # SVD-backed lstsq on hundreds of thousands of rows
    aw = a * w[:, None]
    ata = aw.T @ a
    atf = aw.T @ f
    c = jnp.linalg.solve(ata + 1e-6 * jnp.eye(4, dtype=a.dtype), atf)
    radius = jnp.sqrt(jnp.maximum(c[0] ** 2 + c[1] ** 2 + c[2] ** 2 + c[3], 0.0))
    return radius, c[:3] + mean


def _eig3(m):
    """Eigen-decomposition of a real 3x3 matrix via Cardano's formula.

    Returns (vals(3,), vecs(3,3)) with real parts only; complex-conjugate
    pairs come back with their real part and garbage eigenvectors — callers
    must select the relevant real eigenpair themselves (fit_ellipse selects
    by the 4ac-b^2 > 0 constraint, which only the real root satisfies).
    Exists because jnp.linalg.eig has no lowering on every backend (on a
    GPU it needs MAGMA), and a closed form stays inside the fused program.
    """
    m = jnp.asarray(m)
    tr = jnp.trace(m)
    # sum of principal 2x2 minors
    m2 = (
        m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        + m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
        + m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
    )
    det = jnp.linalg.det(m)
    # characteristic poly: l^3 - tr l^2 + m2 l - det; depress with l = t+tr/3
    p = m2 - tr**2 / 3.0
    q = -det + tr * m2 / 3.0 - 2.0 * tr**3 / 27.0
    # real-only Cardano (no complex arithmetic in the program):
    disc = q**2 / 4.0 + p**3 / 27.0
    # disc > 0: a single real root via real cube roots
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    cbrt = lambda x: jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)
    t_single = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)
    # disc <= 0: three real roots via the trigonometric method
    p_neg = jnp.minimum(p, -1e-30)
    rho = 2.0 * jnp.sqrt(-p_neg / 3.0)
    arg = jnp.clip(3.0 * q / (p_neg * rho), -1.0, 1.0)
    theta = jnp.arccos(arg)
    ks = jnp.arange(3, dtype=m.dtype)
    t_trig = rho * jnp.cos(theta / 3.0 - 2.0 * jnp.pi * ks / 3.0)
    t_roots = jnp.where(disc > 0, jnp.full(3, t_single, m.dtype), t_trig)
    vals = t_roots + tr / 3.0
    vals = jnp.where(jnp.isfinite(vals), vals, 0.0)

    def null_vec(lam):
        a = m - lam * jnp.eye(3, dtype=m.dtype)
        c01 = jnp.cross(a[0], a[1])
        c02 = jnp.cross(a[0], a[2])
        c12 = jnp.cross(a[1], a[2])
        cands = jnp.stack([c01, c02, c12])
        norms = jnp.linalg.norm(cands, axis=1)
        v = cands[jnp.argmax(norms)]
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)

    vecs = jnp.stack([null_vec(vals[k]) for k in range(3)], axis=1)
    return vals, vecs


def fit_ellipse(pts2d, w=None):
    """Direct least-squares (Fitzgibbon/Halir-Flusser) ellipse fit.

    Returns (center(2,), width, height, phi) as in lsq-ellipse's
    as_parameters() (reference anatomic_neck.py:141).  Uses the numerically
    stable partitioned formulation so only a 3x3 eigenproblem is solved.
    """
    pts2d = jnp.asarray(pts2d)
    w = _weights(pts2d, w)
    # center/scale for conditioning
    mean = _weighted_mean(pts2d, w)
    xy = pts2d - mean
    scale = jnp.sqrt(jnp.sum(w[:, None] * xy**2, axis=0) / jnp.sum(w))
    scale = jnp.maximum(scale, 1e-12)
    x = xy[:, 0] / scale[0]
    y = xy[:, 1] / scale[1]

    sw = jnp.sqrt(w)
    d1 = jnp.stack([x**2, x * y, y**2], axis=1) * sw[:, None]
    d2 = jnp.stack([x, y, jnp.ones_like(x)], axis=1) * sw[:, None]
    s1 = d1.T @ d1
    s2 = d1.T @ d2
    s3 = d2.T @ d2
    t = -jnp.linalg.solve(s3, s2.T)
    m = s1 + s2 @ t
    c1inv = jnp.array([[0.0, 0.0, 0.5], [0.0, -1.0, 0.0], [0.5, 0.0, 0.0]])
    m = c1inv @ m
    # closed-form 3x3 eigensolver: jnp.linalg.eig does not lower on every
    # backend
    vals, vecs = _eig3(m)
    # pick eigenvector with 4ac - b^2 > 0 (the ellipse-defining pair; it is
    # unique and real per Halir & Flusser)
    cond = 4.0 * vecs[0] * vecs[2] - vecs[1] ** 2
    cond = jnp.where(jnp.isfinite(cond), cond, -jnp.inf)
    idx = jnp.argmax(cond)
    a1 = vecs[:, idx]
    a2 = t @ a1
    # conic coefficients in scaled frame: ax^2 + bxy + cy^2 + dx + ey + f
    a_, b_, c_ = a1[0], a1[1], a1[2]
    d_, e_, f_ = a2[0], a2[1], a2[2]

    # unscale: substitute x = (X-mx)/sx etc.
    sx, sy = scale[0], scale[1]
    mx, my = mean[0], mean[1]
    A = a_ / sx**2
    B = b_ / (sx * sy)
    C = c_ / sy**2
    D = -2 * A * mx - B * my + d_ / sx
    E = -2 * C * my - B * mx + e_ / sy
    F = (
        A * mx**2 + B * mx * my + C * my**2
        - (d_ / sx) * mx - (e_ / sy) * my + f_
    )

    # conic -> geometric parameters (standard formulas)
    den = B**2 - 4 * A * C
    cx = (2 * C * D - B * E) / den
    cy = (2 * A * E - B * D) / den
    num = 2 * (A * E**2 + C * D**2 + F * B**2 - B * D * E - 4 * A * C * F)
    s = jnp.sqrt((A - C) ** 2 + B**2)
    axis1 = -jnp.sqrt(num * (A + C + s)) / den
    axis2 = -jnp.sqrt(num * (A + C - s)) / den
    phi = 0.5 * jnp.arctan2(B, A - C)
    return jnp.array([cx, cy]), axis1, axis2, phi
