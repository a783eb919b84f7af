"""1D signal ops: Savitzky-Golay, find_peaks, linear-kernel KDE, RBF CPD.

Dense fixed-shape JAX re-implementations of the scipy / sklearn / ruptures
routines the reference leans on (SURVEY.md §2.3):

  * savgol_filter(x, 10, 1)            reference bicipital_groove.py:107
  * scipy.signal.find_peaks(...,
      height, prominence, width)       bicipital_groove.py:113-118
  * sklearn KernelDensity('linear')    bicipital_groove.py:184-188
  * ruptures.KernelCPD('rbf'), 1 bkp   surgical_neck.py:31-34

find_peaks follows scipy's exact definitions: prominence bases via
previous/next strictly-greater element, tie-broken toward the peak; widths
at rel_height=0.5 with linear interpolation of the crossing points.  The
O(N^2) masked formulation trades FLOPs for full vectorization — N=512 per
contour, vmapped over slices and bones.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

# monotone-source row selection implementation (see fill_from_scatter):
# "gather" measured faster at pipeline shapes on the accelerator this was
# first tuned for; "scatter" kept for re-measurement via SHOULDER_FILL_IMPL
# (H100: not measured).
_FILL_IMPL = os.environ.get("SHOULDER_FILL_IMPL", "gather")

_BIG = jnp.inf


def savgol_filter(x, window: int, polyorder: int):
    """scipy.signal.savgol_filter with mode='interp' semantics.

    Supports the two configurations the reference uses: (10, 1) and (3, 1).
    For polyorder 1 the interior is a moving average over a window spanning
    [i - w//2, i + (w-1)//2]; the first/last w//2 (odd: (w-1)//2) samples are
    replaced by a linear fit over the first/last window.
    """
    if polyorder != 1:
        raise NotImplementedError("only polyorder=1 is used by the pipeline")
    x = jnp.asarray(x)
    n = x.shape[-1]
    half_lo = (window - 1) // 2      # samples to the left of center
    half_hi = window - 1 - half_lo   # to the right (even windows lean right)
    edge = window // 2

    # interior: moving average via cumsum
    c = jnp.cumsum(
        jnp.concatenate([jnp.zeros(x.shape[:-1] + (1,), x.dtype), x], axis=-1),
        axis=-1,
    )
    idx = jnp.arange(n)
    lo = jnp.clip(idx - half_lo, 0, n)
    hi = jnp.clip(idx + half_hi + 1, 0, n)
    interior = (jnp.take(c, hi, axis=-1) - jnp.take(c, lo, axis=-1)) / window

    # linear fit over the first/last `window` samples (static weights)
    t = np.arange(window)
    a = np.stack([t, np.ones(window)], axis=1)
    proj = np.linalg.pinv(a)  # (2, window)
    w_start = (a[:edge] @ proj).astype(np.float32)            # (edge, window)
    w_end = (a[window - edge:] @ proj).astype(np.float32)     # (edge, window)

    head = jnp.einsum("ew,...w->...e", jnp.asarray(w_start, x.dtype), x[..., :window])
    tail = jnp.einsum("ew,...w->...e", jnp.asarray(w_end, x.dtype), x[..., -window:])

    out = interior
    out = jnp.concatenate([head, out[..., edge:]], axis=-1)
    out = jnp.concatenate([out[..., :-edge], tail], axis=-1)
    return out


def _sparse_tables(x, levels: int):
    """Range min/max sparse tables over x.

    Returns (min_tab, amin_lo, amin_hi, max_tab), each (levels+1, n):
    level l covers the window [i, i + 2^l) (clamped at n, padded with
    +/-inf).  amin_lo breaks argmin ties toward the SMALLER index,
    amin_hi toward the LARGER — both tie directions are needed to match
    scipy's left/right base walks.
    """
    n = x.shape[0]
    inf = jnp.array(_BIG, x.dtype)
    mn = [x]
    mx = [x]
    a_lo = [jnp.arange(n, dtype=jnp.int32)]
    a_hi = [jnp.arange(n, dtype=jnp.int32)]
    for l in range(1, levels + 1):
        h = 1 << (l - 1)
        mn_r = jnp.concatenate([mn[-1][h:], jnp.full(h, inf)])
        mx_r = jnp.concatenate([mx[-1][h:], jnp.full(h, -inf)])
        al_r = jnp.concatenate(
            [a_lo[-1][h:], jnp.zeros(h, jnp.int32)]
        )
        ah_r = jnp.concatenate(
            [a_hi[-1][h:], jnp.zeros(h, jnp.int32)]
        )
        take_r_lo = mn_r < mn[-1]            # strict: ties stay left
        take_r_hi = mn_r <= mn[-1]           # ties go right
        a_lo.append(jnp.where(take_r_lo, al_r, a_lo[-1]))
        a_hi.append(jnp.where(take_r_hi, ah_r, a_hi[-1]))
        mn.append(jnp.minimum(mn[-1], mn_r))
        mx.append(jnp.maximum(mx[-1], mx_r))
    return (jnp.stack(mn), jnp.stack(a_lo), jnp.stack(a_hi), jnp.stack(mx))


def _floor_log2(length, levels: int):
    """floor(log2(length)) for integer length >= 1, branch-free."""
    l = jnp.zeros_like(length)
    for k in range(1, levels + 1):
        l = l + (length >= (1 << k)).astype(length.dtype)
    return l


def _peaks_core_rq(x, height: float, prominence: float, width: float):
    """find_peaks core via sparse-table range queries, O(n log n).

    Previous/next strictly-greater elements by binary descent on a
    range-max table, interval minima/bases by O(1) two-block range-min
    queries with scipy's tie directions, and the width crossing points by
    threshold descent on the range-min table.  The default core of
    find_peaks: on the H100 it ties the dense core (PERF.md), and it is
    the faster core on a CPU, where the O(n^2) masks blow the cache.
    """
    n = x.shape[0]
    levels = max(1, int(np.ceil(np.log2(n))))
    i = jnp.arange(n)

    left = jnp.concatenate([jnp.array([_BIG], x.dtype), x[:-1]])
    right = jnp.concatenate([x[1:], jnp.array([_BIG], x.dtype)])
    is_peak = (x > left) & (x > right)
    is_peak = is_peak & (x >= height)

    min_tab, amin_lo, amin_hi, max_tab = _sparse_tables(x, levels)

    def rng_min(lo, hi_incl, amin_tab):
        """(min, argmin) over [lo, hi_incl], per-element vectors."""
        length = hi_incl - lo + 1
        l = _floor_log2(jnp.maximum(length, 1), levels)
        s2 = hi_incl - (1 << l) + 1
        m1 = min_tab[l, lo]
        m2 = min_tab[l, s2]
        a1 = amin_tab[l, lo]
        a2 = amin_tab[l, s2]
        if amin_tab is amin_hi:  # ties toward the larger index
            take2 = m2 <= m1
        else:                    # ties toward the smaller index
            take2 = m2 < m1
        return jnp.minimum(m1, m2), jnp.where(take2, a2, a1)

    # previous strictly-greater element: binary descent of the exclusive
    # upper bound u over blocks [u - 2^l, u) whose max is <= x[p]
    u = i
    for l in range(levels, -1, -1):
        blk = 1 << l
        s = u - blk
        can = s >= 0
        bmax = max_tab[l, jnp.maximum(s, 0)]
        skip = can & (bmax <= x)
        u = jnp.where(skip, s, u)
    lb_bound = u - 1                               # -1 if none

    # next strictly-greater element: mirror, scanning right from p+1
    v = i + 1
    for l in range(levels, -1, -1):
        blk = 1 << l
        can = v + blk <= n
        bmax = max_tab[l, jnp.minimum(v, n - 1)]
        skip = can & (bmax <= x)
        v = jnp.where(skip, v + blk, v)
    rb_bound = v                                   # n if none

    # left interval (lb_bound, p]: min and largest argmin (ties toward the
    # peak, matching scipy's walk); right interval [p, rb_bound) mirrored
    lmin, lbase = rng_min(jnp.maximum(lb_bound + 1, 0), i, amin_hi)
    rmin, rbase = rng_min(i, jnp.minimum(rb_bound - 1, n - 1), amin_lo)

    prom = x - jnp.maximum(lmin, rmin)

    # widths at rel_height=0.5 (scipy default)
    wh = x - 0.5 * prom
    # left crossing: largest j in [lbase, p] with x[j] <= wh, found by
    # descending u over blocks whose min stays above the threshold (a
    # crossing always exists: x[lbase] <= wh by construction)
    u = i + 1
    for l in range(levels, -1, -1):
        blk = 1 << l
        s = u - blk
        can = s >= lbase
        bmin = min_tab[l, jnp.maximum(s, 0)]
        skip = can & (bmin > wh)
        u = jnp.where(skip, s, u)
    lj = jnp.clip(u - 1, 0, n - 1)
    ljn = jnp.clip(lj + 1, 0, n - 1)
    denom_l = x[ljn] - x[lj]
    frac_l = jnp.where(
        (x[lj] < wh) & (jnp.abs(denom_l) > 0),
        (wh - x[lj]) / jnp.where(denom_l == 0, 1.0, denom_l),
        0.0,
    )
    left_ip = jnp.where(x[lj] < wh, lj + frac_l, lj.astype(x.dtype))

    # right crossing: smallest j in [p, rbase] with x[j] <= wh
    v = i
    for l in range(levels, -1, -1):
        blk = 1 << l
        can = v + blk <= rbase + 1
        bmin = min_tab[l, jnp.minimum(v, n - 1)]
        skip = can & (bmin > wh)
        v = jnp.where(skip, v + blk, v)
    rj = jnp.clip(v, 0, n - 1)
    rjp = jnp.clip(rj - 1, 0, n - 1)
    denom_r = x[rjp] - x[rj]
    frac_r = jnp.where(
        (x[rj] < wh) & (jnp.abs(denom_r) > 0),
        (wh - x[rj]) / jnp.where(denom_r == 0, 1.0, denom_r),
        0.0,
    )
    right_ip = jnp.where(x[rj] < wh, rj - frac_r, rj.astype(x.dtype))

    widths = right_ip - left_ip

    ok = is_peak & (prom >= prominence) & (widths >= width)
    return ok, prom, widths, wh


def _peaks_core_dense_cand(x, height: float, prominence: float, width: float,
                           cand_cap: int | None = None):
    """find_peaks core via dense pairwise masks over compacted candidates,
    returned in CANDIDATE space: (cand, cvalid, ok_c, prom_c, widths_c,
    wh_c), candidates in ascending position order.

    One big fused elementwise program, `find_peaks(method="dense")` (on
    the H100 it measured level with the range-query core at the groove
    stage's shapes, PERF.md).  Only local maxima
    participate as mask rows: they are compacted to candidate slots
    first, so the masks are (C, n) instead of (n, n).  Strict local
    maxima are never adjacent (and the +inf edge pads exclude the ends),
    so ``n // 2 + 1`` slots hold EVERY possible candidate — the default
    cap is exact, not a truncation, keeping this core's output identical
    to the rq core and scipy on any input while still halving the mask
    work relative to (n, n).

    A caller may pass a smaller ``cand_cap`` when it knows its inputs are
    smooth (the mask work scales with the cap); maxima beyond the cap are
    then dropped POSITIONALLY (later positions lose), so the final tuple
    element is an overflow flag — () bool, true iff the input had more
    local maxima than slots and the result may therefore be truncated.
    Callers must surface it (QC flag / fallback), never swallow it.
    """
    n = x.shape[0]
    i = jnp.arange(n)

    left = jnp.concatenate([jnp.array([_BIG], x.dtype), x[:-1]])
    right = jnp.concatenate([x[1:], jnp.array([_BIG], x.dtype)])
    is_peak = (x > left) & (x > right)
    is_peak = is_peak & (x >= height)

    c = min(n // 2 + 1 if cand_cap is None else cand_cap, n)
    csum = jnp.cumsum(is_peak.astype(jnp.int32))
    dest = jnp.where(is_peak, csum - 1, c)
    cand = (
        jnp.zeros(c, jnp.int32)
        .at[dest]
        .set(i.astype(jnp.int32), mode="drop")
    )
    cvalid = jnp.arange(c) < csum[-1]
    overflow = csum[-1] > c

    # pairwise masks (c, n): axis 0 = candidate peak p, axis 1 = position j
    xp = x[cand][:, None]
    xj = x[None, :]
    jj = i[None, :]
    pp = cand[:, None]

    xc = x[cand]

    greater = xj > xp
    # previous strictly-greater element (exclusive), -1 if none
    lmask = greater & (jj < pp)
    lb_bound = jnp.max(jnp.where(lmask, jj, -1), axis=1)
    # next strictly-greater element, n if none
    rmask = greater & (jj > pp)
    rb_bound = jnp.min(jnp.where(rmask, jj, n), axis=1)

    # left interval (lb_bound, p]; min value, base = largest argmin (ties
    # toward the peak, matching scipy's walk)
    linterval = (jj > lb_bound[:, None]) & (jj <= pp)
    lvals = jnp.where(linterval, xj, _BIG)
    lmin = jnp.min(lvals, axis=1)
    lbase = jnp.max(jnp.where(lvals == lmin[:, None], jj, -1), axis=1)

    rinterval = (jj < rb_bound[:, None]) & (jj >= pp)
    rvals = jnp.where(rinterval, xj, _BIG)
    rmin = jnp.min(rvals, axis=1)
    rbase = jnp.min(jnp.where(rvals == rmin[:, None], jj, n), axis=1)

    prom_c = xc - jnp.maximum(lmin, rmin)

    # widths at rel_height=0.5 (scipy default)
    wh_c = xc - 0.5 * prom_c
    # left crossing: largest j in [lbase, p] with x[j] <= wh
    lcross_mask = (jj >= lbase[:, None]) & (jj <= pp) & (xj <= wh_c[:, None])
    lj = jnp.max(jnp.where(lcross_mask, jj, -1), axis=1)
    lj = jnp.clip(lj, 0, n - 1)
    # the crossing interpolation needs (x[lj], x[lj+1]) and (x[rj-1],
    # x[rj]): fetch each side as ONE (c, 2) row gather of a shift-paired
    # table instead of two flat scalar gathers apiece (same trick as
    # interp_ascending — these four gathers were most of the core's
    # remaining cost after the masks)
    pair_fwd = jnp.stack(
        [x, jnp.concatenate([x[1:], x[n - 1:]])], axis=1
    )                                   # row j = (x[j], x[min(j+1, n-1)])
    gl = pair_fwd[lj]
    x_lj, x_ljn = gl[:, 0], gl[:, 1]
    denom_l = x_ljn - x_lj
    frac_l = jnp.where(
        (x_lj < wh_c) & (jnp.abs(denom_l) > 0),
        (wh_c - x_lj) / jnp.where(denom_l == 0, 1.0, denom_l),
        0.0,
    )
    left_ip = jnp.where(x_lj < wh_c, lj + frac_l, lj.astype(x.dtype))

    rcross_mask = (jj <= rbase[:, None]) & (jj >= pp) & (xj <= wh_c[:, None])
    rj = jnp.min(jnp.where(rcross_mask, jj, n), axis=1)
    rj = jnp.clip(rj, 0, n - 1)
    pair_bwd = jnp.stack(
        [jnp.concatenate([x[:1], x[: n - 1]]), x], axis=1
    )                                   # row j = (x[max(j-1, 0)], x[j])
    gr = pair_bwd[rj]
    x_rjp, x_rj = gr[:, 0], gr[:, 1]
    denom_r = x_rjp - x_rj
    frac_r = jnp.where(
        (x_rj < wh_c) & (jnp.abs(denom_r) > 0),
        (wh_c - x_rj) / jnp.where(denom_r == 0, 1.0, denom_r),
        0.0,
    )
    right_ip = jnp.where(x_rj < wh_c, rj - frac_r, rj.astype(x.dtype))

    widths_c = right_ip - left_ip

    ok_c = cvalid & (prom_c >= prominence) & (widths_c >= width)
    return cand, cvalid, ok_c, prom_c, widths_c, wh_c, overflow


def _peaks_core_dense(x, height: float, prominence: float, width: float,
                      cand_cap: int | None = None):
    """(n,)-space view of the dense core (the rq core's convention) —
    kept for the scipy-oracle tests and any full-length callers; the hot
    path (find_peaks, method='dense') packs straight from candidate space
    and skips these four scatters (measured as most of the core's cost:
    the masks are dense elementwise work, the scatters are not)."""
    n = x.shape[0]
    cand, cvalid, ok_c, prom_c, widths_c, wh_c, _ovf = _peaks_core_dense_cand(
        x, height, prominence, width, cand_cap
    )
    safe = jnp.where(cvalid, cand, n)
    ok = jnp.zeros(n, bool).at[safe].set(ok_c, mode="drop")
    prom = jnp.zeros(n, x.dtype).at[safe].set(prom_c, mode="drop")
    widths = jnp.zeros(n, x.dtype).at[safe].set(widths_c, mode="drop")
    wh = jnp.zeros(n, x.dtype).at[safe].set(wh_c, mode="drop")
    return ok, prom, widths, wh


@functools.partial(
    jax.jit, static_argnames=("max_peaks", "method", "cand_cap")
)
def find_peaks(x, height: float, prominence: float, width: float,
               max_peaks: int = 16, method: str = "rq",
               cand_cap: int | None = None):
    """scipy.signal.find_peaks(height=, prominence=, width=) equivalent.

    Returns a dict of fixed-size (max_peaks,) arrays sorted by descending
    prominence, with `valid` marking real peaks:
      idx, prominences, widths, width_heights, valid, n_peaks, overflow.

    Two cores with identical outputs (both scipy-oracle tested): `rq`
    (O(n log n) sparse-table range queries, the default: exact on any
    input, with no cap) and `dense` (O(n^2) fused masks over compacted
    candidates).  On the H100 they tie at the groove stage's shapes
    (PERF.md).

    `cand_cap` (dense core only) bounds the candidate local-maxima slots;
    the default ``n // 2 + 1`` is exact on any input.  A smaller cap cuts
    the dominant (C, n) mask work proportionally but drops maxima beyond
    the cap positionally — `overflow` (() bool) is true whenever that
    happened and the result may be truncated; callers passing a cap MUST
    surface it (the pipeline routes it into a QC flag).
    """
    x = jnp.asarray(x)
    if method not in ("dense", "rq"):
        raise ValueError(f"find_peaks method {method!r}")

    if method == "dense":
        # pack straight from candidate space: candidates are in ascending
        # position order, so a stable argsort on -prominence ties by
        # position exactly like the (n,)-space pack below — without the
        # core's four (n,)-wide scatter-backs
        cand, cvalid, ok_c, prom_c, widths_c, wh_c, overflow = (
            _peaks_core_dense_cand(x, height, prominence, width, cand_cap)
        )
        ok_c = ok_c & cvalid
        c = cand.shape[0]
        if c < max_peaks:  # tiny inputs: pad candidate slots to max_peaks
            pad = max_peaks - c
            cand = jnp.concatenate([cand, jnp.zeros(pad, cand.dtype)])
            ok_c = jnp.concatenate([ok_c, jnp.zeros(pad, bool)])
            zf = jnp.zeros(pad, prom_c.dtype)
            prom_c = jnp.concatenate([prom_c, zf])
            widths_c = jnp.concatenate([widths_c, zf])
            wh_c = jnp.concatenate([wh_c, zf])
        score = jnp.where(ok_c, prom_c, -_BIG)
        order = jnp.argsort(-score)[:max_peaks]
        valid = ok_c[order]
        return {
            "idx": jnp.where(valid, cand[order], 0),
            "prominences": jnp.where(valid, prom_c[order], 0.0),
            "widths": jnp.where(valid, widths_c[order], 0.0),
            "width_heights": jnp.where(valid, wh_c[order], 0.0),
            "valid": valid,
            "n_peaks": jnp.sum(ok_c),
            "overflow": overflow,
        }

    ok, prom, widths, wh = _peaks_core_rq(x, height, prominence, width)

    # pack the top max_peaks by prominence
    score = jnp.where(ok, prom, -_BIG)
    order = jnp.argsort(-score)[:max_peaks]
    valid = ok[order]
    return {
        "idx": jnp.where(valid, order, 0),
        "prominences": jnp.where(valid, prom[order], 0.0),
        "widths": jnp.where(valid, widths[order], 0.0),
        "width_heights": jnp.where(valid, wh[order], 0.0),
        "valid": valid,
        "n_peaks": jnp.sum(ok),
        "overflow": jnp.zeros((), bool),  # the rq core is always exact
    }


def kde_linear_argmax(samples, sample_weights, grid):
    """argmax over `grid` of a linear-kernel KDE (bandwidth 1.0).

    sklearn KernelDensity(kernel='linear') density is proportional to
    sum_i max(0, 1 - |x - x_i|); the argmax is invariant to normalization
    (reference bicipital_groove.py:184-188).  `sample_weights` masks padded
    samples.
    """
    d = jnp.abs(grid[:, None] - samples[None, :])
    k = jnp.maximum(0.0, 1.0 - d) * sample_weights[None, :]
    dens = jnp.sum(k, axis=1)
    return grid[jnp.argmax(dens)], dens


def rbf_changepoint_1bkp(signal, valid=None, min_size: int = 2):
    """Exact single-breakpoint RBF-kernel changepoint detection.

    ruptures.KernelCPD(kernel='rbf').predict(n_bkps=1) equivalent
    (reference surgical_neck.py:31-34): gamma = 1 / median of off-diagonal
    pairwise squared distances; segment cost c(s,e) = (e-s) - S(s,e)/(e-s)
    where S is the Gram-block sum; minimize c(0,t) + c(t,n) over t.

    `valid` (bool mask) supports a padded signal; the breakpoint index is
    relative to the unpadded prefix.
    """
    x = jnp.asarray(signal, jnp.float32)
    n_total = x.shape[0]
    if valid is None:
        valid = jnp.ones(n_total, dtype=bool)
    n = jnp.sum(valid)

    d2 = (x[:, None] - x[None, :]) ** 2
    pair_ok = valid[:, None] & valid[None, :] & (
        jnp.arange(n_total)[:, None] != jnp.arange(n_total)[None, :]
    )
    # median over valid off-diagonal entries (masked): sort with +inf fill
    flat = jnp.where(pair_ok, d2, jnp.inf).ravel()
    m = jnp.sum(pair_ok)
    srt = jnp.sort(flat)
    lo = (m - 1) // 2
    hi = m // 2
    med = 0.5 * (srt[lo] + srt[hi])
    med = jnp.where(med > 0, med, 1.0)
    k = jnp.exp(-d2 / med) * pair_ok
    # diagonal of the RBF gram is 1 for valid entries
    k = k + jnp.diag(jnp.where(valid, 1.0, 0.0))

    # prefix sums of the gram for O(1) block sums
    csum = jnp.cumsum(jnp.cumsum(k, axis=0), axis=1)
    padded = jnp.zeros((n_total + 1, n_total + 1)).at[1:, 1:].set(csum)

    # block(s, e) = sum over K[s:e, s:e]
    #             = padded[e,e] - padded[s,e] - padded[e,s] + padded[s,s];
    # evaluated for all split points at once from the prefix table's
    # diagonal plus its 0th and (traced) nth row/column — pure vector
    # slices instead of ~8 scalar gathers per split under the vmap
    ts = jnp.arange(n_total)
    len1 = ts.astype(jnp.float32)
    len2 = (n - ts).astype(jnp.float32)
    diag = jnp.diagonal(padded)[:n_total]          # padded[t, t]
    row0 = padded[0, :n_total]                     # padded[0, t]
    col0 = padded[:n_total, 0]                     # padded[t, 0]
    rown = jax.lax.dynamic_slice_in_dim(padded, n, 1, axis=0)[0]
    coln = jax.lax.dynamic_slice_in_dim(padded, n, 1, axis=1)[:, 0]
    snn = jax.lax.dynamic_slice_in_dim(rown, n, 1)[0]
    s1 = diag - row0 - col0 + padded[0, 0]         # block(0, t)
    s2 = snn - coln[:n_total] - rown[:n_total] + diag   # block(t, n)
    cost = (
        len1 - s1 / jnp.maximum(len1, 1.0)
        + len2 - s2 / jnp.maximum(len2, 1.0)
    )
    ok = (ts >= min_size) & (ts <= n - min_size)
    cost = jnp.where(ok, cost, jnp.inf)
    return jnp.argmin(cost)


def fill_from_scatter(dest, rows, m, init_row, dense=False):
    """`out[j] = rows[max{k : dest[k] <= j}]`, `init_row` where that set is
    empty — monotone-source row selection.

    `dense=True` computes the rank as one dense (m, n) masked max-reduce
    — `rank[j] = max({k : 0 <= dest[k] <= j} | {-1})` — which
    is EXACTLY the scatter-max + cummax semantics for ARBITRARY `dest`
    (drops negatives and entries >= m like the scatter's drop mode).
    Same dense-for-scatter trade as ops.slicing._compact_slice's order;
    the m-row payload gather is unchanged.  An earlier count-based variant
    (`#{k : dest[k] <= j} - 1`) required `dest` non-decreasing — a
    precondition interp_ascending's call site silently violates on
    non-convex contours (theta in walk order is locally non-monotone),
    which shifted the polar image and moved retroversion ~1.4 deg on the
    CT A/B bone.  The masked max needs no precondition.

    Otherwise, two value-identical implementations picked by `_FILL_IMPL`:

    - "gather" (DEFAULT): scatter-max of k at slot dest[k], one cummax,
      then ONE m-row gather of the (n+1)-row padded table.  Also robust
      to a locally non-monotone `dest`.
    - "scatter": winner-scatter + log-depth last-valid associative scan,
      zero m-row gathers.  Requires `dest` non-decreasing (ties allowed;
      entries >= m dropped): within a tie group only the LAST k can win,
      so winners write unique slots.

    The scatter variant removes the m-row gather but carries the whole
    (m, C) row payload through log2(m) full-width select rounds, while
    the gather variant moves each row ONCE; on the accelerator this was
    first tuned for, the gather variant won.  Both kept for
    re-measurement on the H100 (not measured).
    """
    if dense:
        n = dest.shape[0]
        jj = jnp.arange(m, dtype=dest.dtype)
        kk = jnp.arange(n, dtype=jnp.int32)
        ok = (dest[None, :] <= jj[:, None]) & (dest[None, :] >= 0)
        rank = jnp.max(jnp.where(ok, kk[None, :], -1), axis=1)  # (m,)
        padded = jnp.concatenate([init_row[None, :], rows], axis=0)
        return padded[rank + 1]
    if _FILL_IMPL == "gather":
        n = dest.shape[0]
        rank = (
            jnp.full(m, -1, jnp.int32)
            .at[dest]
            .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
        )
        rank = jax.lax.cummax(rank)
        padded = jnp.concatenate([init_row[None, :], rows], axis=0)
        return padded[rank + 1]
    n = dest.shape[0]
    is_win = jnp.concatenate(
        [dest[1:] > dest[:-1], jnp.ones((1,), bool)]
    )
    slot = jnp.where(is_win, dest, m)
    buf = (
        jnp.zeros((m, rows.shape[1]), rows.dtype)
        .at[slot]
        .set(rows, mode="drop")
    )
    wrote = jnp.zeros((m,), bool).at[slot].set(True, mode="drop")

    def comb(a, b):
        va, ra = a
        vb, rb = b
        return va | vb, jnp.where(vb[:, None], rb, ra)

    valid, filled = jax.lax.associative_scan(comb, (wrote, buf))
    return jnp.where(valid[:, None], filled, init_row[None, :])


def interp_ascending(x, xp, fp, grid=None):
    """`jnp.interp(x, xp, fp)` for ASCENDING query points `x`.

    Value-identical to jnp.interp (same interval selection — searchsorted
    side='right' semantics — and the same guarded interpolation formula),
    but the binary search is replaced by a scatter-max + cummax rank: each
    source knot computes its first covering query from the uniform-grid
    inverse (queries from jnp.linspace are uniform to ~1 ulp; a +-1
    comparison step against the true query values makes the bucket exact),
    so the per-sample log2(n) serialized gather rounds — measured as the
    whole cost of the polar-image build — become one scatter and two row
    gathers.  Requires `xp` sorted ascending (jnp.interp's own contract)
    and `x` ascending (any monotone grid works; uniform just makes the
    initial estimate tight).

    `grid=(x0, step)`: the caller declares that `x[j] == x0 + j * step`
    BIT-EXACTLY (i.e. it built x with that very expression, not linspace).
    The +-1 correction then computes the grid values arithmetically and
    the (n, 2) pair_x row gather disappears.
    """
    x = jnp.asarray(x)
    xp = jnp.asarray(xp)
    fp = jnp.asarray(fp)
    m = x.shape[0]
    n = xp.shape[0]

    if grid is not None:
        x0, dt = grid
        x0 = jnp.asarray(x0, x.dtype)
        dt = jnp.asarray(dt, x.dtype)
    else:
        x0 = x[0]
        dt = (x[m - 1] - x0) / jnp.maximum(m - 1, 1)
    uniform = dt > 0.0

    # smallest j with x[j] >= xp[k], estimated from the uniform inverse
    # then corrected against the true grid values (two gathers, or pure
    # arithmetic when the caller guarantees the exact grid expression)
    est = jnp.ceil((xp - x0) / jnp.where(uniform, dt, 1.0))
    est = jnp.clip(est, 0.0, float(m)).astype(jnp.int32)
    est = jnp.where(uniform, est, jnp.where(xp <= x0, 0, m))
    if grid is not None:
        ef = est.astype(x.dtype)
        # x_pad[est] / x_pad[est-1] rebuilt with the caller's exact
        # expression (x0 + j*step); est == m reads the inf pad.  The
        # est-1 slot is only read under the est >= 1 guard below.
        g2_lo = x0 + (ef - 1.0) * dt
        g2_hi = jnp.where(est >= m, jnp.inf, x0 + ef * dt)
    else:
        x_pad = jnp.concatenate([x, jnp.full(1, jnp.inf, x.dtype)])
        # the +-1 correction needs x_pad[est-1] and x_pad[est]: fetch both
        # as ONE (n, 2) row gather of a shift-paired table instead of two
        # flat scalar gathers.  Row j holds (x_pad[j-1], x_pad[j]); row
        # 0's left slot is never used (the est >= 1 mask already guards
        # it).
        pair_x = jnp.stack(
            [jnp.concatenate([x_pad[:1], x_pad[:m]]), x_pad], axis=1
        )                                               # (m+1, 2)
        g2 = pair_x[est]
        g2_lo, g2_hi = g2[:, 0], g2[:, 1]
    lo_ok = (est >= 1) & (g2_lo >= xp)
    hi_bad = g2_hi < xp
    b = jnp.where(lo_ok, est - 1, jnp.where(hi_bad, est + 1, est))

    # the old rank construction (scatter-max of k at slot b[k], cummax,
    # then gather pair[clip(rank, 0, n-2)]) selected, at every query j,
    # the pair row of max{k : b[k] <= j}.  fill_from_scatter computes the
    # same selection with NO m-row gather: knot k's source row is
    # (table[min(k, n-2)], table[min(k, n-2)+1]) — contiguous shifts of
    # the knot table — and b is non-decreasing exactly when the +-1
    # correction above is exact, the same precondition the rank scatter
    # already required.  Queries before every knot keep row 0 (rank -1
    # -> clip to 0), the init row.
    table = jnp.stack([xp, fp], axis=1)
    left = jnp.concatenate([table[: n - 1], table[n - 2 : n - 1]], axis=0)
    right = jnp.concatenate([table[1:], table[n - 1 :]], axis=0)
    src_rows = jnp.concatenate([left, right], axis=1)   # (n, 4)
    g = fill_from_scatter(b, src_rows, m, src_rows[0], dense=True)
    g0, g1 = g[:, 0:2], g[:, 2:4]
    df = g1[:, 1] - g0[:, 1]
    dx = g1[:, 0] - g0[:, 0]
    delta = x - g0[:, 0]
    epsilon = np.spacing(np.finfo(np.float32).eps)
    dx0 = jnp.abs(dx) <= epsilon
    f = jnp.where(
        dx0, g0[:, 1], g0[:, 1] + (delta / jnp.where(dx0, 1.0, dx)) * df
    )
    f = jnp.where(x < xp[0], fp[0], f)
    f = jnp.where(x > xp[n - 1], fp[n - 1], f)
    return f
