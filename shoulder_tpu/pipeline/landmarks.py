"""The staged landmark pipeline: one jitted function per bone, vmappable.

This is the accelerator re-architecture of the reference's lazy object web
(SURVEY.md §7 design stance): a pure function over fixed-shape tensors that
computes every landmark and metric in one traced program.  The stateful
`Humerus` facade (shoulder_tpu.bone) reproduces the reference API on top.

Stages (reference call stack SURVEY.md §3.2):
  A. full-bone contour stack  (slice.py:209-224 semantics)
  B. surgical neck            (surgical_neck.py:22-56)
  C. proximal contour stack   (slice.py:227-253)
  D. canal axis               (canal.py:19-85)
  E. bicipital groove         (bicipital_groove.py:26-265)
  F. anatomic neck            (anatomic_neck.py:31-236)
  G. transepicondylar axis    (epicondyle.py:29-101)  [full bones only]
  H. clinical metrics         (bone_props.py:12-148)

All landmark outputs are cached in the CT frame, exactly like the
reference's `_*_ct` convention (canal.py:16-17 etc.).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from shoulder_tpu.config import DEFAULT_CONFIG, PipelineConfig
from shoulder_tpu.models import segment
from shoulder_tpu.models.forest import ForestParams, predict_proba
from shoulder_tpu.ops import rays, rect
from shoulder_tpu.ops import signal as sig
from shoulder_tpu.ops import slicing
from shoulder_tpu.utils import fits, geometry as geom


class BoneTensors(NamedTuple):
    """Fixed-shape per-bone tensors (batch by stacking, shard over bones)."""

    verts: jnp.ndarray          # (V,3) f32, CT frame, padded
    faces: jnp.ndarray          # (F,3) i32, padded with [0,0,0]
    neighbors: jnp.ndarray      # (F,3) i32
    obb_transform: jnp.ndarray  # (4,4) f32 CT -> OBB
    z_min: jnp.ndarray          # () OBB-frame bounds
    z_max: jnp.ndarray
    z_length: jnp.ndarray
    cutoff_lo: jnp.ndarray      # canal window (ProxObb) or default
    cutoff_hi: jnp.ndarray
    # when present, faces/neighbors are pre-sorted by OBB-frame z_min at
    # ingest and face_orig[i] is slot i's original index (the device-side
    # z-argsort and its reorder gathers are skipped — see
    # ops.slicing.sorted_geom); None falls back to the device sort
    face_orig: jnp.ndarray | None = None


class Landmarks(NamedTuple):
    """Everything the API surfaces, in the CT frame, masked fixed shapes."""

    canal_points: jnp.ndarray       # (200,3)
    canal_mask: jnp.ndarray         # (200,) bool
    canal_axis: jnp.ndarray         # (2,3)
    neck_z: jnp.ndarray             # () OBB frame
    sn_points: jnp.ndarray          # (max_chain,3)
    sn_n: jnp.ndarray               # ()
    bg_points: jnp.ndarray          # (S_g,3)
    bg_axis: jnp.ndarray            # (2,3)
    bg_theta: jnp.ndarray           # ()
    anp_points: jnp.ndarray         # (2048,3) neck-rim points
    anp_n: jnp.ndarray
    anp_plane_point: jnp.ndarray    # (3,)
    anp_plane_normal: jnp.ndarray   # (3,)
    anp_axis_normal: jnp.ndarray    # (2,3)
    anp_axis_central: jnp.ndarray   # (2,3)
    te_axis: jnp.ndarray            # (2,3) (zeros for proximal-only)
    side_is_left: jnp.ndarray       # () bool
    retroversion: jnp.ndarray       # () deg (nan for proximal-only)
    neckshaft: jnp.ndarray          # () deg
    radius_curvature: jnp.ndarray   # () mm
    # QC / observability (SURVEY.md §5)
    qc_rf_pos_frac: jnp.ndarray
    qc_mask_area_frac: jnp.ndarray
    qc_sphere_resid: jnp.ndarray
    qc_canal_fit_rms: jnp.ndarray
    qc_slice_overflow: jnp.ndarray  # () bool: slice band too small
    qc_peak_overflow: jnp.ndarray  # () bool: a groove slice had more
    #   local maxima than cfg.groove_cand_cap slots — peak results on
    #   that slice may be truncated (never fires on anatomic inputs;
    #   measured max is 10 maxima vs 64 slots)
    qc_open_edges: jnp.ndarray  # () bool: a slicing plane hit an open
    #   mesh boundary (torn / non-watertight input) and a contour chain
    #   dead-ended — downstream contours may be truncated


def _cutoff_bounds(n: int, cutoff):
    """Reference Slices._cutoff index semantics (slice.py:157-164)."""
    return int((1 - cutoff[1]) * n), int((1 - cutoff[0]) * n)


def _to_ct(pts, obb_transform):
    return geom.transform_pts(pts, geom.inv_transform(obb_transform))


# --------------------------------------------------------------------- D
def _canal(stack: slicing.SliceStack, bone: BoneTensors, proximal: bool,
           cfg: PipelineConfig):
    n = stack.zs.shape[0]
    idx = jnp.arange(n)
    if proximal and tuple(cfg.canal_cutoff) == (0.35, 0.75):
        # dynamic window from the ingest-time OBB area scan; the reference
        # substitutes it only when the caller left cutoff_pcts at the
        # default (canal.py:32-37) — a custom cutoff wins even on proximal
        start = jnp.floor((1.0 - bone.cutoff_hi) * n)
        end = jnp.floor((1.0 - bone.cutoff_lo) * n)
        mean_cut = 0.5 * (bone.cutoff_lo + bone.cutoff_hi)
    else:
        s, e = _cutoff_bounds(n, cfg.canal_cutoff)
        start, end = jnp.asarray(s), jnp.asarray(e)
        mean_cut = jnp.asarray(
            0.5 * (cfg.canal_cutoff[0] + cfg.canal_cutoff[1]), jnp.float32
        )
    mask = (idx >= start) & (idx < end)

    pts = jnp.concatenate([stack.centroids, stack.zs[:, None]], axis=1)
    w = mask.astype(pts.dtype)
    center, direction = fits.fit_line(pts, w)
    direction = jnp.where(direction[2] < 0, -direction, direction)

    half = bone.z_length * mean_cut / 2.0
    axis_obb = jnp.stack([center + direction * half, center - direction * half])

    # rms line-fit residual for QC
    d = pts - center
    perp = d - jnp.outer(d @ direction, direction)
    rms = jnp.sqrt(
        jnp.sum(jnp.sum(perp**2, axis=1) * w) / jnp.maximum(jnp.sum(w), 1)
    )

    points_ct = _to_ct(pts, bone.obb_transform)
    axis_ct = _to_ct(axis_obb, bone.obb_transform)
    return points_ct, mask, axis_ct, axis_obb, rms


# --------------------------------------------------------------------- B
def _surgical_neck(stack, bone: BoneTensors, proximal: bool,
                   cfg: PipelineConfig, max_chain: int, sg=None):
    n = stack.zs.shape[0]
    cut = (cfg.surgical_neck_cutoff_prox if proximal
           else cfg.surgical_neck_cutoff_full)
    s, e = _cutoff_bounds(n, cut)
    areas = stack.areas[s:e]
    zs = stack.zs[s:e]
    t = sig.rbf_changepoint_1bkp(areas, min_size=cfg.cpd_min_size)
    neck_z = zs[t]

    raw, overflow = _raw_loop_at(
        bone, neck_z, max_chain, select="central", sg=sg, band=cfg.full.band
    )
    pts3 = jnp.concatenate(
        [raw.points, jnp.full((max_chain, 1), neck_z, raw.points.dtype)],
        axis=1,
    )
    pts_ct = _to_ct(pts3, bone.obb_transform)
    valid = jnp.arange(max_chain) < raw.n
    pts_ct = jnp.where(valid[:, None], pts_ct, 0.0)
    return neck_z, pts_ct, raw.n, overflow


def _raw_loop_at(bone: BoneTensors, z, max_chain, select, sg=None,
                 band: int = 2048):
    """Returns (RawLoop, overflow) — overflow means the band window missed
    a crossing face and the loop may be truncated; callers route it into
    qc_slice_overflow alongside the stack kernels' flags."""
    if sg is None:
        sg = slicing.sorted_geom(
            geom.transform_pts(bone.verts, bone.obb_transform),
            bone.faces, bone.neighbors, face_orig=bone.face_orig,
        )
    return slicing.slice_raw_banded(
        sg, z, min(band, bone.faces.shape[0]), max_chain, select
    )


# ---------------------------------------------------------------- polar
def _to_polar_start(contour, center):
    """theta/r of a contour, rolled so argmin(theta) leads.

    Reference _cart2pol_no_sort + roll-to-min (slice.py:102-147).  Returns
    (theta (N,), r (N,)).  The two rolls ride ONE (N, 2) row gather —
    paired-row rolls issue ~3x faster than two flat rolls under the
    per-slice vmap (same trick as find_peaks' shift-paired tables).
    """
    d = contour - center
    theta = jnp.arctan2(d[:, 1], d[:, 0])
    r = jnp.linalg.norm(d, axis=1)
    shift = jnp.argmin(theta)
    pr = jnp.roll(jnp.stack([theta, r], axis=1), -shift, axis=0)
    return pr[:, 0], pr[:, 1]


# --------------------------------------------------------------------- E
def _groove(prox: slicing.SliceStack, bone: BoneTensors, canal_axis_ct,
            rf: ForestParams, cfg: PipelineConfig, chunk: int = 16):
    n = prox.zs.shape[0]
    interp = cfg.proximal.interp_num
    s, e = _cutoff_bounds(n, cfg.groove_cutoff)
    contours = prox.contours[s:e]          # (S,512,2)
    cents = prox.centroids[s:e]
    zs = prox.zs[s:e]
    S = e - s
    K = cfg.groove_max_peaks               # 7

    theta, r = jax.vmap(_to_polar_start)(contours, cents)   # (S,512) each
    r0 = r - jnp.mean(r, axis=1, keepdims=True)             # stationary

    # per-slice peak detection on the negated, smoothed, min-rolled radius
    # (bicipital_groove.py:102-128)
    def peaks_one(r0_row):
        radius = sig.savgol_filter(-r0_row, cfg.groove_savgol_window,
                                   cfg.groove_savgol_polyorder)
        rmin = jnp.argmin(radius)
        rolled = jnp.roll(radius, -rmin)
        p = sig.find_peaks(
            rolled, cfg.groove_peak_height, cfg.groove_peak_prominence,
            cfg.groove_peak_width, max_peaks=cfg.max_peaks_per_slice,
            cand_cap=cfg.groove_cand_cap,
        )
        idx = (p["idx"] + rmin) % interp
        valid = p["valid"]
        # keep top K by prominence (find_peaks already sorts by prominence)
        keep = jnp.arange(cfg.max_peaks_per_slice) < K
        return (
            idx[:K], valid[:K] & keep[:K], p["prominences"][:K],
            p["widths"][:K], p["width_heights"][:K],
            jnp.minimum(p["n_peaks"], K), p["overflow"],
        )

    # chunked map: find_peaks' O(N^2) masks are ~6 MB/slice; bounding the
    # live set keeps batched HBM use flat (batch x chunk x N^2, not
    # batch x S x N^2)
    idx, valid, prom, widths, whs, n_pk, pk_overflow = jax.lax.map(
        peaks_one, r0, batch_size=chunk
    )
    peak_overflow = jnp.any(pk_overflow)   # -> qc_peak_overflow

    take = jax.vmap(jnp.take)              # (S,512),(S,K) -> (S,K)
    pk_theta = take(theta, idx)
    pk_radius = take(r, idx)               # original radius incl. mean

    # nearest / next-nearest wrapped angular gaps among a slice's peaks,
    # excluding gaps that round to 0 at 2 decimals (bicipital_groove.py:39-65)
    def near_feats(th_row, val_row, n_row):
        d = th_row[:, None] - th_row[None, :]
        gap = jnp.abs(jnp.arctan2(jnp.sin(d), jnp.cos(d)))
        ok = val_row[:, None] & val_row[None, :]
        ok = ok & (jnp.round(gap, 2) != 0.0)
        g = jnp.where(ok, gap, jnp.inf)
        g = jnp.sort(g, axis=1)
        nearest = jnp.where(jnp.isfinite(g[:, 0]), g[:, 0], 0.0)
        nextn = jnp.where(jnp.isfinite(g[:, 1]), g[:, 1], 0.0)
        nearest = jnp.where(n_row <= 1, 0.0, nearest)
        nextn = jnp.where(n_row <= 2, 0.0, nextn)
        return nearest, nextn

    pk_near, pk_next = jax.vmap(near_feats)(pk_theta, valid, n_pk)

    # z minmax-scaled over the window (bicipital_groove.py:89)
    z_scale = (zs - jnp.min(zs)) / (jnp.max(zs) - jnp.min(zs))
    pk_z = jnp.broadcast_to(z_scale[:, None], (S, K))

    # canal distance feature, preserving the reference's frame quirk:
    # CT-frame canal direction scaled by the OBB z (bicipital_groove.py:67-81)
    canal_u = geom.unit_vector(canal_axis_ct[0], canal_axis_ct[1])
    canal_xy = canal_u[:2][None, None, :] * zs[:, None, None]    # (S,1,2)
    pk_xy = jnp.stack(
        [pk_radius * jnp.cos(pk_theta), pk_radius * jnp.sin(pk_theta)],
        axis=-1,
    )
    pk_canal_dist = jnp.linalg.norm(pk_xy - canal_xy, axis=-1)

    pk_num = jnp.broadcast_to((n_pk / K)[:, None], (S, K)).astype(jnp.float32)

    feats = jnp.stack(
        [pk_radius, pk_near, pk_next, pk_z, prom, widths, whs,
         pk_canal_dist, pk_num],
        axis=-1,
    ).reshape(S * K, 9)
    row_valid = valid.reshape(S * K)

    # per-bone StandardScaler over valid rows (bicipital_groove.py:156)
    w = row_valid.astype(jnp.float32)[:, None]
    mean = jnp.sum(feats * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    var = jnp.sum(w * (feats - mean) ** 2, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    x = (feats - mean) / jnp.sqrt(jnp.maximum(var, 1e-12))
    x = jnp.where(w > 0, x, 0.0)

    proba = predict_proba(rf, x)[:, 1]

    # linear-kernel KDE over positive peak angles -> global groove angle
    pos = row_valid & (proba > cfg.groove_rf_threshold)
    kde_w = pos.astype(jnp.float32)
    # degrade gracefully if the RF finds nothing (reference would crash)
    kde_w = jnp.where(jnp.sum(kde_w) > 0, kde_w,
                      row_valid.astype(jnp.float32) * proba)
    grid = jnp.linspace(-jnp.pi, jnp.pi, cfg.groove_kde_bins)
    bg_theta, _ = sig.kde_linear_argmax(
        pk_theta.reshape(S * K), kde_w, grid
    )

    # per-slice windowed argmin around bg_theta with cyclic wrap
    # (bicipital_groove.py:192-230)
    ivar = int(round(cfg.groove_deg_window / (360.0 / interp)))
    ivar = max(ivar, 1)

    def local_min(th_row, r_row, r0_row):
        # searchsorted(side="left") == count of elements < bg_theta: one
        # dense compare+sum over the row instead of log2(interp)
        # serialized gather rounds
        esti = jnp.sum(th_row < bg_theta).astype(jnp.int32)
        esti = jnp.minimum(esti, interp - 1)
        win = (esti - ivar + jnp.arange(2 * ivar)) % interp
        off = jnp.argmin(r0_row[win])
        j = (esti - ivar + off) % interp
        return jnp.stack([r_row[j] * jnp.cos(th_row[j]),
                          r_row[j] * jnp.sin(th_row[j])])

    bg_xy = jax.vmap(local_min)(theta, r, r0)
    bg_xyz = jnp.concatenate([bg_xy + cents, zs[:, None]], axis=1)

    # groove axis: unsigned line fit spanning the points' z extent
    # (bicipital_groove.py:244-265)
    center, direction = fits.fit_line(bg_xyz)
    z_dist = jnp.max(bg_xyz[:, 2]) - jnp.min(bg_xyz[:, 2])
    axis_obb = jnp.stack([
        center + direction * z_dist / 2.0,
        center - direction * z_dist / 2.0,
    ])

    bg_points_ct = _to_ct(bg_xyz, bone.obb_transform)
    bg_axis_ct = _to_ct(axis_obb, bone.obb_transform)
    rf_pos_frac = jnp.sum(pos) / jnp.maximum(jnp.sum(row_valid), 1)
    return bg_points_ct, bg_axis_ct, bg_theta, rf_pos_frac, peak_overflow


# --------------------------------------------------------------------- F
def _anp_image_points(prox: slicing.SliceStack, bg_theta,
                      cfg: PipelineConfig):
    """The anatomic-neck polar image + per-pixel OBB-frame surface points
    (reference anatomic_neck.py:34-58).  Split out so evaluation tooling
    can inject oracle masks downstream (_anp_from_mask)."""
    n = prox.zs.shape[0]
    interp = cfg.proximal.interp_num
    s, e = _cutoff_bounds(n, cfg.anp_cutoff)
    contours = prox.contours[s:e]          # (R,512,2), R = 512
    zs = prox.zs[s:e]
    R = e - s

    zero = jnp.zeros(2, contours.dtype)

    def polar_row(contour):
        th, r = _to_polar_start(contour, zero)  # uncentered (itr_start)
        # even-theta resample from th[0] to th[-2] over th[:-1]
        # (anatomic_neck.py:43-44).  interp_ascending is jnp.interp minus
        # the per-sample binary search (log2(n) dependent gather rounds per
        # sample).  The grid is built explicitly
        # as th0 + j*step (ulp-equal to linspace) so its groove-angle roll
        # below is closed-form modular arithmetic instead of a gather.
        step = (th[-2] - th[0]) / (interp - 1)
        j = jnp.arange(interp, dtype=th.dtype)
        t_samp = th[0] + j * step
        # grid=(th[0], step) matches t_samp's construction bit-exactly, so
        # the interp's +-1 bucket correction is closed-form arithmetic
        # instead of a per-knot pair gather (see interp_ascending)
        r_i = sig.interp_ascending(
            t_samp, th[:-1], r[:-1], grid=(th[0], step)
        )
        # roll so the groove angle leads (anatomic_neck.py:48-49); only
        # r_i needs the gather — the rolled uniform grid is elementwise
        shift = jnp.argmin(jnp.abs(t_samp - bg_theta))
        jr = (jnp.arange(interp) + shift) % interp
        t_rolled = th[0] + jr.astype(th.dtype) * step
        return t_rolled, jnp.roll(r_i, -shift)

    t_im, r_im = jax.vmap(polar_row)(contours)   # (R, 512) each

    # MinMaxScaler over the whole image (anatomic_neck.py:56-58)
    image = (r_im - jnp.min(r_im)) / (jnp.max(r_im) - jnp.min(r_im))

    # 3D surface points per pixel
    x = r_im * jnp.cos(t_im)
    y = r_im * jnp.sin(t_im)
    z = jnp.broadcast_to(zs[:, None], (R, interp))
    pts = jnp.stack([x, y, z], axis=-1)          # (R,512,3)
    return image, pts


def _anatomic_neck(prox: slicing.SliceStack, bone: BoneTensors, bg_theta,
                   cfg: PipelineConfig, seg_params=None, out_n: int = 2048):
    image, pts = _anp_image_points(prox, bg_theta, cfg)

    if cfg.segmenter == "unet":
        # UNet over the normalized polar image (the reference's interface,
        # anatomic_neck.py:62-85), then geometric-consistency refinement:
        # the CNN mask seeds the robust-sphere consensus instead of the
        # top-rows heuristic — the analog of the reference's CRF stage
        # ("unetcrf").  On a healthy head both seeds converge to the same
        # consensus (metric parity with the sphere segmenter); on degraded
        # geometry the learned seed is what keeps the fit on the articular
        # dome.
        from shoulder_tpu.models import unet as unet_mod

        unary = unet_mod.segment_image(seg_params, image)
        unary = segment._longest_cyclic_run_per_row(unary > 0.5).astype(
            image.dtype
        )
        # the CNN both SEEDS the robust-sphere consensus and SUPPORTS the
        # final mask: supported pixels stay articular up to
        # sphere_seg_support_tol x tol from the consensus sphere, so the
        # boundary can follow flattened/eroded domes the strict inlier set
        # would clip (the arthritic case the reference's tuned CNN handled,
        # anatomic_neck.py:61-76)
        mask, sph_radius, sph_center, sph_resid = segment.sphere_segment(
            pts, cfg.sphere_seg_iters, cfg.sphere_seg_tol_mm,
            cfg.sphere_seg_init_top_rows, init_mask=unary,
            support_mask=unary,
            support_tol_factor=cfg.sphere_seg_support_tol,
            support_min_disagree=cfg.sphere_seg_support_min_disagree,
            support_max_disagree=cfg.sphere_seg_support_max_disagree,
            support_min_recall=cfg.sphere_seg_support_min_recall,
            support_rescue_max_frac=cfg.sphere_seg_support_rescue_frac,
        )
    else:
        mask, sph_radius, sph_center, sph_resid = segment.sphere_segment(
            pts, cfg.sphere_seg_iters, cfg.sphere_seg_tol_mm,
            cfg.sphere_seg_init_top_rows,
        )
    return _anp_from_mask(mask, pts, bone, sph_resid, out_n)


def _anp_from_mask(mask, pts, bone: BoneTensors, sph_resid,
                   out_n: int = 2048):
    """Rim extraction, plane fit, ellipse recenter, axis rays, and
    radius-of-curvature from an articular mask (reference
    anatomic_neck.py:123-236).  Mask-source-agnostic: the pipeline passes
    the segmenter output; evaluation tooling passes oracle (exact
    generative) masks."""
    # rim = theta-direction mask transitions.  Theta is PERIODIC (the
    # image is rolled so the groove azimuth leads), so the boundary is the
    # cyclic diff; the reference's np.diff(prepend=0)
    # (anatomic_neck.py:81) additionally emits a spurious column-0 "edge"
    # on every row whose articular arc wraps the seam — a line of dome
    # points at the groove azimuth that tilts the plane fit (documented
    # divergence, PARITY.md).
    maskb = mask > 0.5
    edge = maskb != jnp.roll(maskb, 1, axis=-1)               # (R,512)

    edge_flat = edge.reshape(-1)
    pts_flat = pts.reshape(-1, 3)
    anp_pts, anp_n = slicing.compact_points(pts_flat, edge_flat, out_n)
    anp_pts_ct = _to_ct(anp_pts, bone.obb_transform)
    anp_pts_ct = jnp.where(
        (jnp.arange(out_n) < anp_n)[:, None], anp_pts_ct, 0.0
    )

    # plane fit on the rim points, normal up (anatomic_neck.py:128-132)
    ew = edge_flat.astype(jnp.float32)
    p_pt, p_n = fits.fit_plane(pts_flat, ew)
    p_n = jnp.where(p_n[2] < 0, -p_n, p_n)

    # ellipse recenter in the plane frame (anatomic_neck.py:134-146)
    to2d = geom.plane_transform(p_pt, p_n)
    pts2d = geom.transform_pts(pts_flat, to2d)[:, :2]
    ecenter, *_ = fits.fit_ellipse(pts2d, ew)
    center3 = geom.transform_pts(
        jnp.concatenate([ecenter, jnp.zeros(1)])[None, :],
        geom.inv_transform(to2d),
    )[0]

    plane_pt_ct, plane_n_ct = geom.transform_plane(
        center3, p_n, geom.inv_transform(bone.obb_transform)
    )

    # axis rays against the OBB-frame mesh (anatomic_neck.py:174-236);
    # all four rays share one triangle-vertex gather
    verts_obb = geom.transform_pts(bone.verts, bone.obb_transform)
    nc = p_n.at[2].set(0.0)
    nc = nc / jnp.linalg.norm(nc)
    hits, _, _ = rays.first_hits(
        verts_obb, bone.faces,
        jnp.broadcast_to(center3, (4, 3)),
        jnp.stack([p_n, -p_n, nc, -nc]),
    )
    axis_normal_ct = _to_ct(hits[0:2], bone.obb_transform)
    axis_central_ct = _to_ct(hits[2:4], bone.obb_transform)

    # radius of curvature: sphere fit over all articular points
    # (bone_props.py:118-148)
    rad, _cent = fits.fit_sphere(pts_flat, mask.reshape(-1))

    mask_frac = jnp.mean(mask)
    return (
        anp_pts_ct, anp_n, plane_pt_ct, plane_n_ct,
        axis_normal_ct, axis_central_ct,
        center3, p_n,                 # OBB-frame plane for internal reuse
        rad, mask_frac, sph_resid,
    )


# --------------------------------------------------------------------- G
def _transepicondylar(distal: slicing.SliceStack, bone: BoneTensors,
                      canal_axis_ct, axis_central_ct, cfg: PipelineConfig):
    n = distal.zs.shape[0]
    s, e = _cutoff_bounds(n, cfg.epicondyle_cutoff)
    contours = distal.contours[s:e]
    zs = distal.zs[s:e]

    rects = jax.vmap(rect.min_rotated_rect)(contours)
    k = jnp.argmax(rects.major_extent)
    contour = contours[k]
    z_sel = zs[k]
    r_sel = rect.RotatedRect(
        rects.center[k], rects.major_dir[k],
        rects.major_extent[k], rects.minor_extent[k],
    )

    out, _ = rect.end_slab_mask(contour, r_sel, cfg.epicondyle_yscale)
    rid = rect.cyclic_runs(out, cfg.epicondyle_max_fragments)
    cents, counts, valid = rect.run_chord_centroids(
        contour, rid, None, cfg.epicondyle_max_fragments
    )
    # the farthest-apart pair of fragment centroids (epicondyle.py:56-81)
    d = jnp.linalg.norm(cents[:, None, :] - cents[None, :, :], axis=-1)
    ok = valid[:, None] & valid[None, :]
    d = jnp.where(ok, d, -jnp.inf)
    flat = jnp.argmax(d)
    i, j = flat // cfg.epicondyle_max_fragments, flat % cfg.epicondyle_max_fragments
    end_pts = jnp.stack([cents[i], cents[j]])
    end3 = jnp.concatenate(
        [end_pts, jnp.full((2, 1), z_sel, end_pts.dtype)], axis=1
    )
    end_ct = _to_ct(end3, bone.obb_transform)

    # orient medial first via the canal/head-central csys (epicondyle.py:89-96)
    tfrm = geom.construct_csys(canal_axis_ct, axis_central_ct)
    in_csys = geom.transform_pts(end_ct, tfrm)
    flip = in_csys[1, 0] < in_csys[0, 0]
    end_ct = jnp.where(flip, end_ct[::-1], end_ct)
    return end_ct


# --------------------------------------------------------------------- H
def _metrics(canal_axis_ct, axis_normal_ct, axis_central_ct, te_axis_ct,
             bg_points_ct, proximal: bool):
    # side (bone_props.py:24-48)
    tf_central = geom.construct_csys(canal_axis_ct, axis_central_ct)
    bg_mean = jnp.mean(geom.transform_pts(bg_points_ct, tf_central), axis=0)
    side_is_left = bg_mean[1] <= 0

    # neckshaft (bone_props.py:93-111)
    tf_ns = geom.construct_csys(canal_axis_ct, axis_normal_ct)
    an = geom.transform_pts(axis_normal_ct, tf_ns)
    anu = geom.unit_vector(an[0], an[1])
    neckshaft = 180.0 - geom.unitxyz_to_spherical(anu)[2]

    if proximal:
        retro = jnp.float32(jnp.nan)
    else:
        # retroversion (bone_props.py:64-85)
        tf_te = geom.construct_csys(canal_axis_ct, te_axis_ct)
        an2 = geom.transform_pts(axis_normal_ct, tf_te)
        an2u = geom.unit_vector(an2[0], an2[1])
        an2u = an2u.at[0].multiply(-1.0)
        theta = geom.unitxyz_to_spherical(an2u)[1]
        retro = jnp.where(side_is_left, theta, -theta)
    return side_is_left, retro, neckshaft


@functools.partial(
    jax.jit, static_argnames=("proximal", "cfg", "chunk")
)
def compute_landmarks(
    bone: BoneTensors,
    rf: ForestParams,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
    seg_params=None,
) -> Landmarks:
    if cfg.segmenter == "unet" and seg_params is None:
        # Resolve the shipped weights at trace time; they embed as program
        # constants, so every caller (facade, vmapped batch, sharded mesh)
        # inherits them without threading an extra argument.  Loads once
        # per process (models.unet.load_default_params cache) and raises
        # if the weight file is missing.
        from shoulder_tpu.models import unet as unet_mod

        seg_params = unet_mod.load_default_params()

    verts_obb = geom.transform_pts(bone.verts, bone.obb_transform)
    # the z-sorted face geometry depends only on the mesh: compute it once
    # and share it across the full/proximal/distal stacks.  Ingest-built
    # bones arrive pre-sorted (face_orig set), so the full-face-set argsort
    # and its reorder gathers vanish from the device program entirely
    sg = slicing.sorted_geom(
        verts_obb, bone.faces, bone.neighbors, face_orig=bone.face_orig
    )

    # A: full stack (zs descending, slice.py:219-224)
    zs_full = jnp.linspace(
        cfg.z_inset * bone.z_max, cfg.z_inset * bone.z_min,
        cfg.full.zslice_num,
    )
    full = slicing.slice_stack(
        verts_obb, bone.faces, bone.neighbors, zs_full,
        cfg.full.interp_num, cfg.max_chain, chunk, cfg.full.band, sg=sg,
        group=cfg.full.group, slab=cfg.full.slab,
        compact_k=cfg.slice_compact_k,
    )

    # B: surgical neck
    neck_z, sn_points, sn_n, sn_overflow = _surgical_neck(
        full, bone, proximal, cfg, cfg.max_chain, sg=sg
    )

    # C: proximal stack (head -> surgical neck, slice.py:248-253)
    zs_prox = jnp.linspace(
        cfg.z_inset * bone.z_max, neck_z, cfg.proximal.zslice_num
    )
    prox = slicing.slice_stack(
        verts_obb, bone.faces, bone.neighbors, zs_prox,
        cfg.proximal.interp_num, cfg.max_chain, chunk, cfg.proximal.band,
        sg=sg, group=cfg.proximal.group, slab=cfg.proximal.slab,
        compact_k=cfg.slice_compact_k,
    )

    # D: canal
    canal_pts, canal_mask, canal_axis, _canal_obb, canal_rms = _canal(
        full, bone, proximal, cfg
    )

    # E: bicipital groove
    bg_points, bg_axis, bg_theta, rf_pos_frac, peak_overflow = _groove(
        prox, bone, canal_axis, rf, cfg, chunk=min(chunk, 16)
    )

    # F: anatomic neck
    (anp_pts, anp_n, plane_pt, plane_n, axis_normal, axis_central,
     _plane_pt_obb, _plane_n_obb, radius, mask_frac, sph_resid,
     ) = _anatomic_neck(prox, bone, bg_theta, cfg, seg_params=seg_params)

    # G: transepicondylar (full bones only)
    overflow = jnp.any(full.overflow) | jnp.any(prox.overflow) | sn_overflow
    open_edges = jnp.any(full.open_edges) | jnp.any(prox.open_edges)
    if proximal:
        te_axis = jnp.zeros((2, 3), jnp.float32)
    else:
        zs_dist = jnp.linspace(
            cfg.z_inset * bone.z_min, 0.0, cfg.distal.zslice_num
        )
        distal = slicing.slice_stack(
            verts_obb, bone.faces, bone.neighbors, zs_dist,
            cfg.distal.interp_num, cfg.max_chain, chunk, cfg.distal.band,
            sg=sg, group=cfg.distal.group, slab=cfg.distal.slab,
            compact_k=cfg.slice_compact_k,
        )
        te_axis = _transepicondylar(
            distal, bone, canal_axis, axis_central, cfg
        )
        overflow = overflow | jnp.any(distal.overflow)
        open_edges = open_edges | jnp.any(distal.open_edges)

    # H: metrics
    side_is_left, retro, neckshaft = _metrics(
        canal_axis, axis_normal, axis_central, te_axis, bg_points, proximal
    )

    return Landmarks(
        canal_points=canal_pts,
        canal_mask=canal_mask,
        canal_axis=canal_axis,
        neck_z=neck_z,
        sn_points=sn_points,
        sn_n=sn_n,
        bg_points=bg_points,
        bg_axis=bg_axis,
        bg_theta=bg_theta,
        anp_points=anp_pts,
        anp_n=anp_n,
        anp_plane_point=plane_pt,
        anp_plane_normal=plane_n,
        anp_axis_normal=axis_normal,
        anp_axis_central=axis_central,
        te_axis=te_axis,
        side_is_left=side_is_left,
        retroversion=retro,
        neckshaft=neckshaft,
        radius_curvature=radius,
        qc_rf_pos_frac=rf_pos_frac,
        qc_mask_area_frac=mask_frac,
        qc_sphere_resid=sph_resid,
        qc_canal_fit_rms=canal_rms,
        qc_slice_overflow=overflow,
        qc_peak_overflow=peak_overflow,
        qc_open_edges=open_edges,
    )
