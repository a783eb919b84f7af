"""Batched mesh x plane cross-section kernel (pure JAX, fixed shapes).

This is the #1 kernel of the framework (SURVEY.md §7): the reference spends
its time in trimesh.section_multiplane + per-contour resampling
(reference slice.py:21-29,166-189).  Here the whole thing is dense,
fixed-shape XLA:

  1. per-face plane crossing + oriented intersection segments (elementwise),
  2. loop labelling via pointer doubling over the face-adjacency successor
     map (O(log MAX_CHAIN) dense gather rounds — no sequential walk),
  3. per-loop area/centroid/point-count via scatter-adds,
  4. loop ordering via parallel list ranking (pointer jumping),
  5. arc-length resampling to a fixed number of contour points.

Everything vmaps over slices and bones; lax.map chunking bounds the (S, F)
intermediate footprint.

Orientation convention: segments are directed z_hat x face_normal, so
exterior loops come out CCW (positive shoelace area) and holes CW, matching
shapely's convention used by the reference's largest-polygon selection
(slice.py:52-60).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from shoulder_tpu.ops import signal


class FaceGeom(NamedTuple):
    """Per-bone, z-independent face data precomputed once per mesh.

    Segment orientation needs no face normal: it is decided combinatorially
    from the vertex sign pattern (see _crossing_topology), so vertex
    coordinates + adjacency are the whole state.
    """

    fvx: jnp.ndarray      # (F,3) x of the 3 vertices of each face
    fvy: jnp.ndarray      # (F,3)
    fvz: jnp.ndarray      # (F,3)
    neighbors: jnp.ndarray  # (F,3) neighbor face across edge slot k


class SliceStack(NamedTuple):
    """The universal contour-stack intermediate (SURVEY.md §7)."""

    contours: jnp.ndarray    # (S, N, 2) resampled largest-loop contours
    centroids: jnp.ndarray   # (S, 2) area centroid of the largest loop
    areas: jnp.ndarray       # (S,) largest-loop signed area
    total_areas: jnp.ndarray  # (S,) sum of signed loop areas
    zs: jnp.ndarray          # (S,)
    overflow: jnp.ndarray    # (S,) bool: band window missed a crossing face
    open_edges: jnp.ndarray  # (S,) bool: a crossed face had no crossed
    #   neighbor across its exit edge (open boundary / torn mesh) — the
    #   chain dead-ends there and the contour is truncated


class RawLoop(NamedTuple):
    points: jnp.ndarray   # (max_chain, 2) ordered loop points (padded)
    n: jnp.ndarray        # () int32 number of valid points
    area: jnp.ndarray     # ()
    centroid: jnp.ndarray  # (2,)


def face_geom(verts, faces, neighbors) -> FaceGeom:
    fv = verts[faces]  # (F,3,3)
    return FaceGeom(
        fvx=fv[:, :, 0], fvy=fv[:, :, 1], fvz=fv[:, :, 2],
        neighbors=neighbors,
    )


class SortedGeom(NamedTuple):
    """Face geometry sorted by face z_min, for banded slicing.

    A plane at height z only crosses faces in a short contiguous window of
    the sorted order (all crossing faces have z_min <= z, and they cluster
    just below the z_min-insertion point).  Per-slice work then runs on a
    (band,) window instead of all (F,) faces.

    Vertex coordinates are stored TRANSPOSED as one (9, F) matrix (rows:
    x0 x1 x2 y0 y1 y2 z0 z1 z2): the whole-band crossing math then runs
    with the band as the minor (contiguous) dimension, and the per-slice
    window cut is ONE dynamic slice.  Neighbors stay (F, 3): they are only
    ever gathered at the ~512 compacted crossing faces.

    Padding faces carry z_min = +inf so they sort to the tail and never
    enter a window.
    """

    fv9: jnp.ndarray          # (9, F) sorted; see layout note above
    fvt: jnp.ndarray          # (F, 13) face-major table: cols 0-8 the
    #                           face's coordinates, cols 9-12 the ids
    #                           (orig_id, 3 neighbor ids) as float32
    #                           VALUES so ONE (k, 13) row gather brings a
    #                           compacted face's whole geometry AND its
    #                           ids (one row gather instead of several
    #                           column gathers).  Ids must be stored as
    #                           values, NEVER bitcast bit patterns: an
    #                           accelerator's float32 path may flush
    #                           denormals to zero and canonicalize NaNs,
    #                           so any id < 2^23 bitcast into a float can
    #                           read back as 0, and -1 (0xFFFFFFFF, a NaN)
    #                           as the default qNaN pattern (this
    #                           corrupted every id on an earlier
    #                           accelerator while every CPU test passed).
    #                           Integer values are exact in float32 up to
    #                           2^24, far above any face count here.
    neighbors: jnp.ndarray    # (F, 3) sorted-frame neighbor ids, -1 none
    z_min: jnp.ndarray        # (F,) per-slot face z_min (ingest-presorted
    #                           geometry may carry sub-ulp disorder from
    #                           host/device f32 transform differences; all
    #                           window math searches z_key instead)
    z_key: jnp.ndarray        # (F,) monotone non-decreasing search key
    #                           with z_key[i] <= z_min[i]: every face with
    #                           z_min <= z is guaranteed below
    #                           searchsorted(z_key, z) regardless of that
    #                           disorder
    z_max: jnp.ndarray        # (F,) face z_max per sorted slot
    z_mm: jnp.ndarray         # (F,2) [z_min, z_max] per slot: ONE window
    #                           fetch serves the exact interval crossing
    #                           test (z_min < z <= z_max) — position-vs-
    #                           start is NOT a valid crossing test under
    #                           ingest-presorted geometry, where the
    #                           conservative z_key window can admit faces
    #                           with z_min >= z that would break the
    #                           compaction's front-packed invariant
    cummax_z_max: jnp.ndarray  # (F,) running max of z_max in sorted order
    orig_id: jnp.ndarray      # (F,) original face index per sorted slot


def sorted_geom(verts, faces, neighbors, face_orig=None) -> SortedGeom:
    """Z-sorted face geometry for banded slicing.

    With `face_orig=None` the faces are argsorted on device.  With a
    `face_orig` (F,) array the faces are declared ALREADY z-ascending in
    this vertex frame (the ingest layer pre-sorts them on the host — the
    z-order is a pure function of ingest-known data, so the device-side
    full-face-set sort plus its reorder gathers are pure waste on the hot
    path); `face_orig[i]` is slot i's pre-sort face index, which keeps
    loop-start selection (min original id) and therefore every downstream
    contour bit-identical to the device-sorted formulation.  Host (f64)
    and device (f32) transforms can disagree by ulps near z-ties, so the
    presorted path derives a conservative monotone search key (suffix
    running min) instead of trusting exact sortedness — see z_key.
    """
    g = face_geom(verts, faces, neighbors)
    z_min = jnp.min(g.fvz, axis=1)
    z_max = jnp.max(g.fvz, axis=1)
    # padding faces are degenerate ([0,0,0]); push them past every window
    degenerate = (faces[:, 0] == faces[:, 1]) & (faces[:, 1] == faces[:, 2])
    z_min = jnp.where(degenerate, jnp.inf, z_min)
    z_max = jnp.where(degenerate, -jnp.inf, z_max)
    if face_orig is not None:
        # suffix running-min: z_key[i] = min_{j>=i} z_min[j], non-decreasing
        # by construction and <= z_min slot-wise, so window selection stays
        # exact even if host and device disagree on near-tie order.  The
        # handful of extra faces a conservative window admits are killed by
        # the sign recheck in _compact_slice / _crossing_topology.
        z_key = jnp.flip(jax.lax.cummin(jnp.flip(z_min)))
        nbr = neighbors
        fv9 = jnp.concatenate([g.fvx.T, g.fvy.T, g.fvz.T], axis=0)
        cmx = jax.lax.cummax(z_max)
        auxi = jnp.concatenate(
            [face_orig.astype(jnp.int32)[:, None], nbr.astype(jnp.int32)],
            axis=1,
        )
        fvt = jnp.concatenate([fv9.T, auxi.astype(fv9.dtype)], axis=1)
        z_mm = jnp.stack([z_min, z_max], axis=1)
        return SortedGeom(fv9, fvt, nbr, z_min, z_key, z_max, z_mm, cmx,
                          face_orig.astype(jnp.int32))
    # lexicographic (z_min, face id) sort: a plain argsort may tie-order
    # differently under vmap (all padding faces tie at +inf, and equal-z
    # real faces tie too), which would shift window boundaries between
    # batched and unbatched runs
    idx = jnp.arange(z_min.shape[0], dtype=jnp.int32)
    _, order = jax.lax.sort((z_min, idx), num_keys=2)
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    nbr = jnp.where(neighbors >= 0, inv[neighbors], -1)[order]
    fv9 = jnp.concatenate(
        [g.fvx[order].T, g.fvy[order].T, g.fvz[order].T], axis=0
    )
    zmn = z_min[order]
    cmx = jax.lax.cummax(z_max[order])
    auxi = jnp.concatenate(
        [order.astype(jnp.int32)[:, None], nbr.astype(jnp.int32)], axis=1
    )
    fvt = jnp.concatenate([fv9.T, auxi.astype(fv9.dtype)], axis=1)
    zmx = z_max[order]
    z_mm = jnp.stack([zmn, zmx], axis=1)
    return SortedGeom(fv9, fvt, nbr, zmn, zmn, zmx, z_mm, cmx, order)


def _window_zmax(sg: SortedGeom, z, band: int):
    """The (band, 2) [z_min, z_max] window of plane z, its start offset
    and insertion point, and an overflow flag (true would mean the band
    is too small: a face below the window with z_max >= z would be a
    missed crossing).

    Windows are contiguous slabs of the z-sorted order cut with ONE
    dynamic slice.

    The whole-band work is just the crossing test, and with z_min-sorted
    windows that test needs the [z_min, z_max] pair per face (see
    `_compact_slice`): every x/y/z coordinate it ever needs lives at the
    k compacted faces (fetched from `sg.fvt` as one row gather).  Under
    the per-slice vmap the dynamic slice lowers to a gather whose cost
    scales with elements fetched.
    """
    start = jnp.searchsorted(sg.z_key, z)
    lo = jnp.clip(start - band, 0, sg.z_key.shape[0] - band)
    zmm_w = jax.lax.dynamic_slice_in_dim(sg.z_mm, lo, band, axis=0)
    below = jnp.maximum(lo - 1, 0)
    overflow = (lo > 0) & (sg.cummax_z_max[below] >= z)
    return zmm_w, lo, start, overflow


def _window_starts(sg: SortedGeom, zs, band: int):
    """Batched `_window` offsets, insertion points, + overflow flags for a
    whole plane stack.

    One vectorized searchsorted over all S planes replaces the log2(F)
    scalar binary search each slice would otherwise re-run inside the
    per-slice map — same values, S-fold fewer serialized gather rounds.

    method='compare_all' turns the S x log2(F) scalar-gather rounds of the
    default scan into one broadcast compare-reduce (S x F bools).  Which
    method the H100 prefers is not measured (ROADMAP 3.5).
    """
    starts = jnp.searchsorted(sg.z_key, zs, method="compare_all")
    lo = jnp.clip(starts - band, 0, sg.z_key.shape[0] - band)
    below = jnp.maximum(lo - 1, 0)
    overflow = (lo > 0) & (sg.cummax_z_max[below] >= zs)
    return lo, starts, overflow


def _crossing_topology(geom: FaceGeom, z):
    """Combinatorial crossing structure of every face with plane z —
    no intersection points computed (those are deferred to the compacted
    face set, `_segment_points`, which is ~2x smaller than the band).

    Orientation is combinatorial, not metric: with CCW winding (outward
    normal n) the in-plane traversal direction is z-hat x n, and the
    traversal always ENTERS through the (+ -> -) crossed edge and EXITS
    through the (- -> +) one (marching-triangles invariant).  The sign
    pattern of d is deterministic; a geometric test (dot of the segment
    with dir2d) is fp noise whenever the plane grazes a vertex and the
    segment is near zero-length, and it flips between differently-fused
    XLA programs (batched vs unbatched) — changing the loop topology.

    Returns (crossed (F,), entry_slot (F,), exit_slot (F,), succ (F,),
    open_edge (F,)).
    """
    F = geom.fvz.shape[0]
    d = geom.fvz - z
    d = jnp.where(d == 0.0, 1e-7, d)
    pos = d > 0.0
    pos_next = jnp.roll(pos, -1, axis=1)
    cross_edge = pos != pos_next            # (F,3)
    crossed = jnp.sum(cross_edge, axis=1) == 2

    rows = jnp.arange(F)
    entry_slot = jnp.argmax(pos & ~pos_next, axis=1)
    exit_slot = jnp.argmax(~pos & pos_next, axis=1)

    succ_raw = geom.neighbors[rows, exit_slot]
    has_nbr = (succ_raw >= 0) & (succ_raw < F)
    succ = jnp.where(crossed & has_nbr, succ_raw, rows)
    # a missing neighbor across the exit edge, or a successor that is
    # itself uncrossed, dead-ends the chain (non-watertight boundary);
    # flag it: downstream surfaces this as qc_open_edges (a torn mesh
    # yields truncated contours that would otherwise look valid)
    open_edge = crossed & ~(has_nbr & crossed[succ])
    succ = jnp.where(crossed[succ], succ, rows)
    # enforce injectivity: when the plane grazes a vertex, the orientation
    # sign of a near-zero-length segment is fp noise and TWO faces can
    # claim the same successor; pointer doubling (label merge) and a
    # sequential walk (visited marks, the numpy oracle) would resolve such
    # junctions differently.  Keep only the smallest-index predecessor per
    # target; dead-end the rest.  Non-degenerate slices (one predecessor per target) unchanged.
    linked = crossed & (succ != rows)
    pred_min = (
        jnp.full(F, F, jnp.int32)
        .at[jnp.where(linked, succ, F)]
        .min(rows.astype(jnp.int32), mode="drop")
    )
    succ = jnp.where(linked & (pred_min[succ] != rows), rows, succ)
    return crossed, entry_slot, exit_slot, succ, open_edge


def _segment_points(fvx, fvy, fvz, z, entry_slot, exit_slot):
    """Intersection segment endpoints for faces with known crossing slots.

    Bit-identical to computing the points on the full band and gathering:
    the per-edge interpolation is elementwise in the face row.
    """
    F = fvz.shape[0]
    d = fvz - z
    d = jnp.where(d == 0.0, 1e-7, d)
    d_next = jnp.roll(d, -1, axis=1)
    denom = d - d_next
    denom = jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)
    t = d / denom
    px = fvx + t * (jnp.roll(fvx, -1, axis=1) - fvx)
    py = fvy + t * (jnp.roll(fvy, -1, axis=1) - fvy)
    rows = jnp.arange(F)
    start = jnp.stack([px[rows, entry_slot], py[rows, entry_slot]], axis=1)
    end = jnp.stack([px[rows, exit_slot], py[rows, exit_slot]], axis=1)
    return start, end


def _crossing_segments(geom: FaceGeom, z):
    """Oriented intersection segments of every face with plane z.

    Returns (crossed (F,), start (F,2), end (F,2), succ (F,)) where succ is
    the next face along the loop (self for uncrossed faces).
    """
    crossed, entry_slot, exit_slot, succ, open_edge = _crossing_topology(
        geom, z
    )
    start, end = _segment_points(
        geom.fvx, geom.fvy, geom.fvz, z, entry_slot, exit_slot
    )
    return crossed, start, end, succ, open_edge


def _iters_for(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _label_loops(crossed, succ):
    """Min-index loop labels via pointer doubling.  Uncrossed -> F."""
    F = succ.shape[0]
    lab = jnp.where(crossed, jnp.arange(F), F)
    ptr = succ
    for _ in range(_iters_for(F)):
        lab = jnp.minimum(lab, jnp.where(crossed, lab[ptr], lab))
        ptr = ptr[ptr]
    return lab


def _loop_stats(crossed, start, end, lab, F):
    """Per-label signed area, area centroid, point count, mean point.

    Scatter-adds into F+1 slots; slot F collects all uncrossed faces.
    """
    cross2 = start[:, 0] * end[:, 1] - end[:, 0] * start[:, 1]
    cross2 = jnp.where(crossed, cross2, 0.0)
    area2 = jnp.zeros(F + 1).at[lab].add(cross2)
    area = 0.5 * area2

    cx = jnp.zeros(F + 1).at[lab].add((start[:, 0] + end[:, 0]) * cross2)
    cy = jnp.zeros(F + 1).at[lab].add((start[:, 1] + end[:, 1]) * cross2)
    denom = jnp.where(jnp.abs(area) > 1e-12, 6.0 * area, 1.0)
    centroid = jnp.stack([cx, cy], axis=1) / denom[:, None]

    ones = jnp.where(crossed, 1, 0)
    count = jnp.zeros(F + 1, dtype=jnp.int32).at[lab].add(ones)
    sx = jnp.zeros(F + 1).at[lab].add(jnp.where(crossed, start[:, 0], 0.0))
    sy = jnp.zeros(F + 1).at[lab].add(jnp.where(crossed, start[:, 1], 0.0))
    cnt = jnp.maximum(count, 1).astype(start.dtype)
    mean_pt = jnp.stack([sx, sy], axis=1) / cnt[:, None]
    return area, centroid, count, mean_pt


def _order_loop(crossed, start, succ, lab, best, count_best, max_chain,
                is_rep=None):
    """Ordered (max_chain, 2) points of the loop labelled `best`.

    `is_rep` marks the loop's start face; defaults to the face whose local
    index equals the label (min local index).  The banded path passes the
    min-ORIGINAL-index face so contour ordering matches the unbanded
    kernel and the numpy oracle exactly.
    """
    F = succ.shape[0]
    rows = jnp.arange(F)
    member = crossed & (lab == best)
    if is_rep is None:
        is_rep = member & (rows == best)

    ptr = jnp.where(is_rep, rows, succ)
    rnk = jnp.where(is_rep, 0, 1)
    for _ in range(_iters_for(F)):
        rnk = rnk + rnk[ptr]
        ptr = ptr[ptr]

    position = jnp.where(is_rep, 0, count_best - rnk)
    position = jnp.where(member, position, max_chain)  # dropped
    points = (
        jnp.zeros((max_chain, 2), dtype=start.dtype)
        .at[position]
        .set(start, mode="drop")
    )
    return points


def _resample(points, n_valid, interp_num, max_chain):
    """Arc-length resample of a padded ordered loop, closing it first.

    Matches reference Slices._resample_polygon (slice.py:166-189) applied to
    the closed discrete path.
    """
    idx = jnp.arange(max_chain + 1)
    first = points[0]
    closed = jnp.concatenate([points, points[:1]], axis=0)
    # position n_valid holds the closing point; beyond that, repeat it so
    # padded entries never influence the interpolation
    closed = jnp.where((idx[:, None] < n_valid), closed, first[None, :])

    seg = jnp.linalg.norm(jnp.diff(closed, axis=0), axis=1)
    seg = jnp.where(idx[:-1] < n_valid, seg, 0.0)
    cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(seg)])
    total = cum[-1]
    # strictly increase past the valid range so sampling never lands there
    cum = jnp.where(idx <= n_valid, cum, total + (idx - n_valid).astype(cum.dtype))

    # O(N) source-segment map: sample j sits at d_j = j*step; its source
    # segment is src[j] = max{i : cum[i] <= d_j}.  Scatter each i to the
    # first sample index at/after cum[i], then a forward cummax fills the
    # gaps — no per-sample binary search (jnp.interp costs log2(N) gather
    # rounds per axis, the hottest part of the slice kernel's post stage).
    step = total / (interp_num - 1)
    step = jnp.where(step > 0, step, 1.0)
    first_sample = jnp.ceil(cum / step).astype(jnp.int32)

    d = jnp.arange(interp_num, dtype=cum.dtype) * step
    # (x, y, cum, x+, y+, cum+) pair table, source-knot order.  The old
    # path scattered knot ids (src = cummax of scatter-max) and gathered
    # pair[src] — an interp_num-row gather per slice, the roofline
    # currency.  first_sample is non-decreasing (cum is), so the same
    # selection is a winner-scatter + forward-fill (fill_from_scatter):
    # no sample-side gather at all.  Knot 0 always writes slot 0
    # (cum[0] = 0), so the init row is never reached; pair[0] keeps the
    # old src = 0 zero-init semantics regardless.
    table = jnp.concatenate([closed, cum[:, None]], axis=1)
    pair = jnp.concatenate(
        [table, jnp.concatenate([table[1:], table[-1:]], axis=0)], axis=1
    )
    # dense=True routes fill_from_scatter down the precondition-free
    # masked-max path (a dense compare-reduce, no scatter); it does not
    # require first_sample to be monotone.
    g = signal.fill_from_scatter(
        first_sample, pair, interp_num, pair[0], dense=True
    )
    g0, g1 = g[:, 0:3], g[:, 3:6]
    c0, c1 = g0[:, 2], g1[:, 2]
    t = jnp.clip((d - c0) / jnp.where(c1 > c0, c1 - c0, 1.0), 0.0, 1.0)
    p0, p1 = g0[:, 0:2], g1[:, 0:2]
    return p0 + t[:, None] * (p1 - p0)


def _geom_from_slab(slab, nbr_local):
    """FaceGeom view of a (9, band) window slab (fallback paths only)."""
    return FaceGeom(
        fvx=slab[0:3].T, fvy=slab[3:6].T, fvz=slab[6:9].T,
        neighbors=nbr_local,
    )


def _slice_one(sg: SortedGeom, lo, start_w, z, interp_num: int,
               max_chain: int, band: int, compact: int = 0, zmax_w=None):
    F = band
    over_compact = jnp.asarray(False)
    if compact and compact < F:
        # pack the ~300 crossing faces to the front: the pointer-doubling
        # gathers then run over k slots instead of the band
        if zmax_w is None:
            zmax_w = jax.lax.dynamic_slice_in_dim(sg.z_mm, lo, band, axis=0)
        (crossed, start, end, succ, orig_id, over_compact,
         open_any) = _compact_slice(sg, zmax_w, lo, start_w, z, compact)
        F = compact
    else:
        slab = jax.lax.dynamic_slice_in_dim(sg.fv9, lo, band, axis=1)
        nbr = sg.neighbors[lo + jnp.arange(F)]
        nbr_local = jnp.where(nbr >= 0, nbr - lo, -1)
        crossed, start, end, succ, open_edge = _crossing_segments(
            _geom_from_slab(slab, nbr_local), z
        )
        orig_id = sg.orig_id[lo + jnp.arange(F)]
        open_any = jnp.any(open_edge)
    lab = _label_loops(crossed, succ)
    area, centroid, count, _ = _loop_stats(crossed, start, end, lab, F)
    best = jnp.argmax(area[:F])
    n_best = count[best]
    is_rep = None
    if orig_id is not None:
        # loop start = member with the smallest ORIGINAL face index, so the
        # banded kernel's contour ordering matches the unbanded/oracle one
        big = jnp.iinfo(jnp.int32).max
        min_orig = (
            jnp.full(F + 1, big, jnp.int32)
            .at[lab]
            .min(jnp.where(crossed, orig_id.astype(jnp.int32), big))
        )
        is_rep = crossed & (lab == best) & (orig_id == min_orig[lab])
    # loop length is bounded by the (compacted) face count, so the ordering
    # and resampling buffers never need to exceed it
    chain = min(max_chain, F)
    points = _order_loop(crossed, start, succ, lab, best, n_best, chain,
                         is_rep)
    contour = _resample(points, n_best, interp_num, chain)
    return (contour, centroid[best], area[best], jnp.sum(area[:F]),
            over_compact, open_any)


def _compact_slice(sg: SortedGeom, zmm_w, lo, start, z, k: int):
    """Crossing segments compacted to the first k slots (crossed first).

    The crossing test is exact interval algebra, not band-wide sign math:
    a face has exactly 2 crossed edges iff its vertices carry both signs
    of d = z_vert - z, and under the kernel's d==0 -> +1e-7 convention
    that is precisely (z_min < z) & (z_max >= z) — tested directly on the
    fetched (band, 2) [z_min, z_max] window.  (`window position < start`
    is NOT equivalent under ingest-presorted geometry: the conservative
    z_key window can admit faces with z_min >= z, and a position test
    would compact them as spurious uncrossed slots, breaking the
    front-packed invariant.)

    The partition is computed with a cumsum + one scatter (crossed faces
    to slots [0, ncross) in window order; slots >= ncross keep their zero
    init and are masked invalid) — exactly the stable partition
    `argsort((crossed-bit, position))[:k]` restricted to crossed faces,
    without the per-slice O(F log^2 F) bitonic sort, and deterministic
    under batching (a batched bool argsort(stable=True) could tie-order
    differently from the unbatched one).

    Everything data-dependent runs on the (k,) compacted set, not the
    band.  The k faces' full geometry arrives as ONE (k, 13) row gather
    from the face-major `sg.fvt`; crossing slots and intersection points
    are then
    re-derived per compacted face with the same arithmetic as the band
    formulation, so the results are bit-identical.
    """
    band = zmm_w.shape[0]
    crossed = (zmm_w[:, 1] >= z) & (zmm_w[:, 0] < z)

    csum_c = jnp.cumsum(crossed.astype(jnp.int32))
    ncross = csum_c[-1]
    over = ncross > k
    # order[j] = window position of the j-th crossed face = first i with
    # csum_c[i] == j+1.  As a searchsorted with method='compare_all' this
    # is one broadcast (k, band) compare-reduce instead of a band-sized
    # scatter.
    order = jnp.searchsorted(
        csum_c, jnp.arange(1, k + 1, dtype=csum_c.dtype),
        method="compare_all",
    ).astype(jnp.int32)
    # compact slots beyond ncross resolve past the window end (clamped
    # for the fvt row gather) — `valid_c` masks them out of every
    # data-dependent read below
    order = jnp.minimum(order, band - 1)
    valid_c = jnp.arange(k, dtype=jnp.int32) < ncross
    rows = jnp.arange(k)
    # one row gather brings each compacted face's whole geometry AND its
    # original-id/neighbor ids (float32-VALUE columns 9-12 of the table;
    # see the fvt layout note for why bitcast bit patterns are forbidden)
    g = sg.fvt[lo + order]                  # (k, 13)
    gx, gy, gz = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    gi = g[:, 9:13].astype(jnp.int32)       # (k, 4) exact: |id| < 2^24
    # crossing pattern + entry/exit slots re-derived from the gathered z
    # rows (identical inputs -> identical combinatorics; see
    # _crossing_topology for why orientation is combinatorial)
    d_k = gz - z
    d_k = jnp.where(d_k == 0.0, 1e-7, d_k)
    pos_k = d_k > 0.0
    posn_k = jnp.roll(pos_k, -1, axis=1)
    # every valid slot holds a crossed face by construction; the sign
    # pattern is still needed for the entry/exit slots, and the extra
    # check is free.  valid_c masks the zero-init duplicate slots.
    crossed_c = (jnp.sum(pos_k != posn_k, axis=1) == 2) & valid_c
    entry_c = jnp.argmax(pos_k & ~posn_k, axis=1)
    exit_c = jnp.argmax(~pos_k & posn_k, axis=1)
    # intersection points (same per-edge interpolation as the band
    # formulation — elementwise in the face row, so bit-identical)
    dn_k = jnp.roll(d_k, -1, axis=1)
    denom = d_k - dn_k
    denom = jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)
    t = d_k / denom
    px = gx + t * (jnp.roll(gx, -1, axis=1) - gx)     # (k, 3)
    py = gy + t * (jnp.roll(gy, -1, axis=1) - gy)
    # slot selection as one-hot masked sums, not per-row gathers: a
    # px[rows, entry_c] gather costs one scattered row fetch per face,
    # while select+reduce over the 3-wide slot axis is pure elementwise
    # work.  Exact: the two masked-out addends are 0.0.
    e_hot = entry_c[:, None] == jnp.arange(3)[None, :]   # (k, 3)
    x_hot = exit_c[:, None] == jnp.arange(3)[None, :]
    start_c = jnp.stack([
        jnp.sum(jnp.where(e_hot, px, 0.0), axis=1),
        jnp.sum(jnp.where(e_hot, py, 0.0), axis=1),
    ], axis=1)
    end_c = jnp.stack([
        jnp.sum(jnp.where(x_hot, px, 0.0), axis=1),
        jnp.sum(jnp.where(x_hot, py, 0.0), axis=1),
    ], axis=1)
    # successor id from the exit-edge column of the already-gathered
    # neighbor ids (the band never touches neighbors), same one-hot trick
    nbr_exit = jnp.sum(jnp.where(x_hot, gi[:, 1:4], 0), axis=1)
    succ_w = jnp.where(nbr_exit >= 0, nbr_exit - lo, -1)  # window-local
    # compact id of the successor by window-position EQUALITY against the
    # compacted `order` row: one (k, k) compare-reduce instead of the
    # band-sized inverse-map build + (k,)-from-(band,) gather.  Valid
    # compact slots hold DISTINCT window positions (dest is injective on
    # crossed faces), so each row matches at most once; -1 / out-of-window
    # / uncrossed / compacted-out successors match nothing and stay -1
    # (missing neighbor = open boundary; compacted-out only on overflow —
    # `over` flags that case, so the open-edge signal is gated on ~over)
    eq = (succ_w[:, None] == order[None, :]) & valid_c[None, :]
    has = jnp.any(eq, axis=1)
    succ_idx = jnp.argmax(eq, axis=1)
    open_edge_c = crossed_c & ~has
    # enforce injectivity (vertex-grazing planes can make two faces claim
    # one successor; see _crossing_topology): keep the smallest-compact-
    # index predecessor, dead-end the rest.  Compact order preserves
    # window order, so this matches the band-domain resolution.  The
    # first predecessor per target column falls out of the SAME eq
    # matrix (argmax = first true row), replacing the old scatter-min +
    # pred_min[succ] gather with dense (k, k) passes.
    linked = crossed_c & has
    win = eq & linked[:, None]
    first_pred = jnp.argmax(win, axis=0)        # (k,) min linked row per col
    # keep[r] = "r is the first predecessor of its target".  Each row
    # matches at most one column (valid slots hold distinct window
    # positions), so this is any_c(win[r,c] & first_pred[c]==r) — a dense
    # (k,k) pass instead of the first_pred[succ_idx] gather
    is_first = win & (rows[:, None] == first_pred[None, :])
    keep = jnp.any(is_first, axis=1)
    succ_c = jnp.where(keep, succ_idx, rows)
    return (crossed_c, start_c, end_c, succ_c, gi[:, 0], over,
            jnp.any(open_edge_c & ~over))


@functools.partial(
    jax.jit,
    static_argnames=("interp_num", "max_chain", "chunk", "band", "group",
                     "slab", "compact_k"),
)
def slice_stack(
    verts, faces, neighbors, zs, interp_num: int, max_chain: int = 2048,
    chunk: int = 50, band: int = 6144, sg: SortedGeom | None = None,
    group: int = 1, slab: int = 0,
    compact_k: int = 512,
) -> SliceStack:
    """Cross-section contour stack for all planes `zs` of one mesh.

    Faces are z-sorted once; each plane's work runs on a (band,)-face
    window (see SortedGeom) — ~7x less gather/elementwise work than the
    full face set at humerus scale.  Loops are labelled by pointer
    doubling and ordered by parallel list ranking over the compacted
    crossing faces.

    `sg` optionally passes a precomputed `sorted_geom(verts, faces,
    neighbors)`: the z-sort (a full-face-set argsort) depends only on the
    mesh, so callers slicing several stacks of one bone share it.
    """
    band = min(band, faces.shape[0])
    if sg is None:
        sg = sorted_geom(verts, faces, neighbors)

    los, starts, win_over = _window_starts(sg, zs, band)

    S = zs.shape[0]
    F_all = sg.z_max.shape[0]
    G = group if (group > 1 and S % group == 0 and slab > band
                  and slab <= F_all) else 1

    if G > 1:
        # group-slab windows: `group` adjacent planes of the monotone grid
        # share ONE contiguous slab fetch (see SliceSetConfig).  The slab
        # reaches DOWN to the group's lowest per-plane window start, so it
        # covers a superset of each plane's band window; faces in the
        # extra coverage either cross (they would have been a flagged band
        # overflow — strictly better) or fail the crossing test.
        # Truncation at the top (slide > slab - band) is QC-flagged per
        # plane like a band overflow.  _slice_one consumes the shared slab
        # directly.
        W = slab
        glo = jnp.min(los.reshape(-1, G), axis=1)
        glo = jnp.minimum(glo, F_all - W)
        zs_g = zs.reshape(-1, G)
        st_g = starts.reshape(-1, G)

        def one_group(args):
            z_v, start_v, g0 = args
            slab_z = jax.lax.dynamic_slice_in_dim(sg.z_mm, g0, W, axis=0)
            below = jnp.maximum(g0 - 1, 0)
            cmx_below = sg.cummax_z_max[below]

            def one(z, start_w):
                c, cen, a, ta, over_c, open_e = _slice_one(
                    sg, g0, start_w, z, interp_num, max_chain, W,
                    compact=min(compact_k, band), zmax_w=slab_z,
                )
                miss = ((g0 > 0) & (cmx_below >= z)) | (start_w - g0 > W)
                return c, cen, a, ta, miss | over_c, open_e

            return jax.vmap(one)(z_v, start_v)

        outs = jax.lax.map(
            one_group, (zs_g, st_g, glo), batch_size=max(1, chunk // G)
        )
        contours, centroids, areas, total_areas, overflow, open_edges = (
            jax.tree.map(lambda x: x.reshape((S,) + x.shape[2:]), outs)
        )
        return SliceStack(contours, centroids, areas, total_areas, zs,
                          overflow, open_edges)

    def one(zlw):
        z, lo, start_w, overflow = zlw
        c, cen, a, ta, over_c, open_e = _slice_one(
            sg, lo, start_w, z, interp_num, max_chain, band,
            compact=min(compact_k, band),
        )
        return c, cen, a, ta, overflow | over_c, open_e

    contours, centroids, areas, total_areas, overflow, open_edges = (
        jax.lax.map(one, (zs, los, starts, win_over), batch_size=chunk)
    )
    return SliceStack(contours, centroids, areas, total_areas, zs, overflow,
                      open_edges)


def plane_section_points(verts, faces, origin, normal):
    """All intersection points of an arbitrarily-oriented plane with a mesh.

    Returns (points (F,3), crossed (F,)): one 3D point per crossed face (the
    oriented segment start), unordered — the equivalent of the vertex set of
    trimesh's section used by anatomic-neck plane_points
    (reference anatomic_neck.py:160-165).
    """
    n = jnp.asarray(normal)
    n = n / jnp.linalg.norm(n)
    d = verts @ n - jnp.asarray(origin) @ n
    d = jnp.where(d == 0.0, 1e-7, d)
    fd = d[faces]
    pos = fd > 0.0
    cross_edge = pos != jnp.roll(pos, -1, axis=1)
    crossed = jnp.sum(cross_edge, axis=1) == 2

    fv = verts[faces]                       # (F,3,3)
    fv_next = jnp.roll(fv, -1, axis=1)      # slot k edge: (v_k, v_{k+1})
    d_next = jnp.roll(fd, -1, axis=1)
    denom = fd - d_next
    denom = jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)
    t = (fd / denom)[..., None]
    p = fv + t * (fv_next - fv)             # (F,3,3) per-slot points

    slot_a = jnp.argmax(cross_edge, axis=1)
    rows = jnp.arange(faces.shape[0])
    points = p[rows, slot_a]
    return points, crossed


def compact_points(points, mask, out_n: int):
    """Pack masked rows to the front, fixed output size.

    Returns (packed (out_n, D), count).  Rows beyond `count` are zeros.
    """
    order = jnp.argsort(~mask, stable=True)[:out_n]
    packed = points[order]
    keep = mask[order]
    packed = jnp.where(keep[:, None], packed, 0.0)
    return packed, jnp.minimum(jnp.sum(mask), out_n)


def slice_raw_banded(
    sg: SortedGeom, z, band: int, max_chain: int = 2048,
    select: str = "largest", k: int = 512,
):
    """Banded single-plane raw loop (see slice_raw for semantics).

    Runs labelling/ordering on the (k,) compacted crossing set of a
    (band,) z-sorted window instead of the full padded face set —
    the full-set pointer doubling is ~2 log2(F) gather rounds over 40k
    faces, ~10x this cost.  Loop start = min original face index, matching
    the unbanded program's ordering.  Returns (RawLoop, overflow).

    `k` is clamped to the band (and the band to the face count): an
    unclamped k > band would leave _compact_slice's scatter slots
    [band, k) at their zero init, replicating window face 0 into the
    compacted set and corrupting loop labelling.
    """
    band = min(band, sg.z_min.shape[0])
    k = min(k, band)
    zmax_w, lo, start_w, overflow = _window_zmax(sg, z, band)
    crossed, start, end, succ, orig_c, over, _open = _compact_slice(
        sg, zmax_w, lo, start_w, z, k
    )
    lab = _label_loops(crossed, succ)
    area, centroid, count, mean_pt = _loop_stats(crossed, start, end, lab, k)
    if select == "largest":
        best = jnp.argmax(area[:k])
    elif select == "central":
        score = jnp.abs(mean_pt[:k, 0]) + jnp.abs(mean_pt[:k, 1])
        score = jnp.where(count[:k] >= 3, score, jnp.inf)
        best = jnp.argmin(score)
    else:
        raise ValueError(select)
    n_best = count[best]
    big = jnp.iinfo(jnp.int32).max
    min_orig = (
        jnp.full(k + 1, big, jnp.int32)
        .at[lab]
        .min(jnp.where(crossed, orig_c.astype(jnp.int32), big))
    )
    is_rep = crossed & (lab == best) & (orig_c == min_orig[lab])
    points = _order_loop(crossed, start, succ, lab, best, n_best, max_chain,
                         is_rep)
    return (
        RawLoop(points, n_best, area[best], centroid[best]),
        overflow | over,
    )


@functools.partial(jax.jit, static_argnames=("max_chain", "select"))
def slice_raw(
    verts, faces, neighbors, z, max_chain: int = 2048, select: str = "largest"
) -> RawLoop:
    """Single-plane section returning the raw ordered loop (unresampled).

    select='largest' picks the max-area loop (reference slice.py:52-60);
    select='central' picks the loop whose mean point is nearest the z axis
    (reference surgical_neck.py:40-50).
    """
    geom = face_geom(verts, faces, neighbors)
    F = geom.fvz.shape[0]
    crossed, start, end, succ, _ = _crossing_segments(geom, z)
    lab = _label_loops(crossed, succ)
    area, centroid, count, mean_pt = _loop_stats(crossed, start, end, lab, F)
    if select == "largest":
        best = jnp.argmax(area[:F])
    elif select == "central":
        score = jnp.abs(mean_pt[:F, 0]) + jnp.abs(mean_pt[:F, 1])
        score = jnp.where(count[:F] >= 3, score, jnp.inf)
        best = jnp.argmin(score)
    else:
        raise ValueError(select)
    n_best = count[best]
    points = _order_loop(crossed, start, succ, lab, best, n_best, max_chain)
    return RawLoop(points, n_best, area[best], centroid[best])
