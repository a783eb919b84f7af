"""Articular-surface segmentation over the 512x512 polar-radius image.

The reference segments the humeral-head articular surface with an ONNX
UNet-CRF over a polar radius image (reference anatomic_neck.py:62-85).  The
UNet weights are absent from the reference snapshot (SURVEY.md §2.2), so
this module provides:

  * `sphere_segment` — a classical, dense robust-sphere segmenter:
    the humeral head is near-spherical (the same assumption behind the
    reference's radius-of-curvature metric, bone_props.py:118-148), so the
    articular surface is the set of surface points within a tolerance of a
    robustly-fit sphere.  Iteratively-reweighted algebraic sphere fits ->
    pure jnp.linalg, vmappable.
  * the Flax UNet lives in shoulder_tpu.models.unet and can be swapped in
    via PipelineConfig once trained (shoulder_tpu/models/unet.py).

Both produce a float mask (rows, cols) in {0,1} with the reference's
mask>0 convention.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _longest_cyclic_run_per_row(mask):
    """Keep only the longest contiguous cyclic run of True in each row.

    Gather-free formulation (the original rolled each row to its first
    False and scatter-counted run ids): each position's run is described
    by the nearest False on either side, both computed with directional
    cumulative extrema — pure elementwise math plus log-depth scans along
    the row.  The winning run maximizes (length, -cyclic start order), the
    same run the rolled run-id/argmax formulation selected: ties break
    toward the run encountered first when scanning from the first False
    (cyclically), and a wrapped run starts at its tail segment's start.
    """
    n = mask.shape[-1]
    m = mask
    i = jnp.arange(n)
    neg = jnp.where(~m, i, -1)
    prev_false = jax.lax.cummax(neg, axis=m.ndim - 1)           # -1 if none
    pos = jnp.where(~m, i, n)
    next_false = jax.lax.cummin(pos, axis=m.ndim - 1,
                                reverse=True)                    # n if none
    runlen = next_false - prev_false - 1                         # valid at m
    # cyclic wrap: when both ends are True, the first and last linear runs
    # are one run (head length + tail length); its start is the tail's
    first_false = jnp.min(pos, axis=-1, keepdims=True)           # n if all T
    last_false = jnp.max(neg, axis=-1, keepdims=True)            # -1 if none
    has_false = first_false < n
    wrap = has_false & m[..., :1] & m[..., -1:]
    head_len = first_false
    tail_len = n - 1 - last_false
    wrap_len = head_len + tail_len
    in_head = m & (i < first_false)
    in_tail = m & (i > last_false)
    in_wrap = wrap & (in_head | in_tail)
    runlen = jnp.where(in_wrap, wrap_len, runlen)
    start = jnp.where(in_wrap, last_false + 1, prev_false + 1)
    # cyclic order of the run start, counted from the first False: the
    # rolled formulation enumerates runs in this order and argmax takes
    # the first max, so ties prefer the smallest cyclic start
    start_cyc = jnp.where(has_false, (start - first_false) % n, 0)
    key = jnp.where(m, runlen * (n + 1) + (n - start_cyc), -1)
    best = jnp.max(key, axis=-1, keepdims=True)
    return m & (key == best) & (best >= 0)


def sphere_segment(
    points,
    iters: int = 12,
    tol_mm: float = 2.0,
    init_top_rows: float = 0.3,
    init_mask=None,
    support_mask=None,
    support_tol_factor: float = 3.0,
    support_min_disagree: float = 0.05,
    support_max_disagree: float = 0.35,
    support_min_recall: float = 0.5,
    support_rescue_max_frac: float = 0.12,
):
    """Segment the articular surface by robust sphere consensus.

    Four robustness stages (each measured against exact generative
    ground truth, tools/eval_accuracy.py): a RANSAC init (minimal 4-point
    sphere hypotheses, Tukey-scored so the zero-residual dome beats
    shell-grazing imposters); a Tukey-weighted IRLS refinement at
    0.5*tol; a signed "first departure" cut per theta column at the
    anatomic-neck recess (or osteophyte ridge) so shell-crossing
    tuberosity flanks cannot rejoin the mask below the rim; and a
    longest-cyclic-run cleanup so each row keeps a single articular arc.

    Args:
      points: (R, C, 3) surface points in the OBB frame; row 0 is the most
        proximal slice (top of the head).
      iters: IRLS refinement iterations after the RANSAC init.
      tol_mm: base tolerance in mm; strict inliers use 0.6x this.
      init_top_rows: initial inlier band as a fraction of rows from the top
        (the top of the head is articular by construction).
      init_mask: optional (R, C) {0,1} initial inlier set overriding the
        top-rows heuristic.  The UNet segmenter path passes its predicted
        mask here: the CNN provides the unary proposal and this consensus
        pass is the geometric-consistency refinement (the analog of the
        reference's CRF stage, anatomic_neck.py:62 "unetcrf").
      support_mask: optional (R, C) {0,1} CNN evidence that participates in
        the FINAL mask, not just the seed: points the CNN marks articular
        stay in the mask up to ``support_tol_factor * tol_mm`` from the
        consensus sphere.  This un-tethers the articular boundary from the
        strict sphere-inlier family — flattened or eroded domes (real
        arthritic anatomy, the case the reference's arthritic-tuned CNN
        handled, anatomic_neck.py:61-76) deviate several mm from the best
        sphere, and without support they would be clipped out.  The bound
        keeps CNN false positives from leaking down the shaft (those sit
        far outside any head-sized sphere).
      support_tol_factor: residual bound multiplier for supported points.
      support_min_recall: plausibility gate — the support term engages
        only if the CNN mask covers at least this fraction of the strict
        sphere-consensus inliers.  See the inline comment at the gate.
      support_min_disagree: the support term engages only when the CNN
        PERSISTENTLY disagrees with the strict consensus — i.e. the
        fraction of CNN-articular pixels outside the cleaned strict mask
        exceeds this threshold.  On healthy heads an in-domain CNN and
        the sphere agree closely, so the gate stays off and the output is
        bit-identical to the plain consensus (golden stability); a
        flattened dome produces a coherent disagreement sector and turns
        the support on — subject to the plausibility/rescue gate below.
      support_max_disagree: upper disagreement bound of the plausibility
        gate (see the inline comment at the gate): beyond it the CNN is
        distrusted wholesale unless the rescue condition holds.
      support_rescue_max_frac: rescue condition — when the cleaned strict
        mask covers less than this fraction of the image (the collapsed-
        consensus regime on flattened/osteophytic heads), the recall and
        max-disagree tests are waived and the bounded support engages.

    Returns (mask (R, C) float {0,1}, radius, center, mean_resid).
    mean_resid is measured over the final mask — widened masks on deformed
    heads legitimately raise it, which is the QC signal's purpose.
    """
    r, c = points.shape[0], points.shape[1]
    pts = points.reshape(-1, 3)

    def fit(w):
        # mean-center for f32 conditioning (see fits.fit_sphere)
        mean = jnp.sum(pts * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1)
        q = pts - mean
        a = jnp.concatenate(
            [2.0 * q, jnp.ones((q.shape[0], 1), q.dtype)], axis=1
        )
        f = jnp.sum(q**2, axis=1)
        aw = a * w[:, None]
        # normal equations (4x4) are far cheaper than lstsq on 262k rows
        ata = aw.T @ a
        atf = aw.T @ f
        sol = jnp.linalg.solve(ata + 1e-6 * jnp.eye(4), atf)
        center = sol[:3] + mean
        radius = jnp.sqrt(jnp.maximum(sol[3] + jnp.sum(sol[:3] ** 2), 1e-9))
        return radius, center

    # hypothesis-selection row prior: the articular surface is PROXIMAL
    # (rows are top-down).  Scores decay to 0.2x over rows 0.45R..0.75R so
    # a sphere hugging sub-rim metaphysis bands cannot outvote the dome —
    # on a noisy voxelized surface an r-too-small imposter otherwise beats
    # the true sphere at EVERY Tukey scale (measured: imposter 2539 vs
    # truth 2377 at 0.35*tol on the 2 mm-voxel CT A/B bone; with the row
    # prior the truth family wins at every scale tried).  Selection-only:
    # the IRLS below still weighs all rows equally.
    row_idx = jnp.repeat(jnp.arange(r), c).astype(pts.dtype)
    t_row = jnp.clip((row_idx - 0.45 * r) / (0.30 * r), 0.0, 1.0)
    w_row = 1.0 - 0.8 * t_row * t_row * (3.0 - 2.0 * t_row)

    def tukey_score(radius, center, scale):
        resid = jnp.abs(jnp.linalg.norm(pts - center, axis=1) - radius)
        u = jnp.minimum(resid / scale, 1.0)
        return jnp.sum(w_row * (1.0 - u**2) ** 2)

    # ---- RANSAC init: minimal 4-point sphere hypotheses from the
    # articular-rich top rows.  A single least-squares init is ~50%
    # contaminated (tuberosities / neck recess) and lands the IRLS in a
    # compromise basin it cannot escape; a clean minimal hypothesis scores
    # the whole exact dome.  The Tukey-weighted score (scale 0.35*tol)
    # rewards the near-zero-residual articular patch over an imposter
    # sphere that merely grazes many slices in thin crossing bands (a
    # plain inlier COUNT prefers the imposter).  Fixed key: deterministic.
    n_hyp = 128
    top_n = int(0.4 * r) * c
    key = jax.random.PRNGKey(17)
    idx = jax.random.randint(key, (n_hyp, 4), 0, top_n)
    quads = pts[idx]                                   # (H, 4, 3)

    def sphere4(q):
        a4 = jnp.concatenate([2.0 * q, jnp.ones((4, 1), q.dtype)], axis=1)
        f4 = jnp.sum(q**2, axis=1)
        sol = jnp.linalg.solve(a4, f4)
        cen = sol[:3]
        rad = jnp.sqrt(jnp.maximum(sol[3] + jnp.sum(cen**2), 1e-9))
        return rad, cen

    h_rad, h_cen = jax.vmap(sphere4)(quads)
    # the CNN proposal (if any) and the top-rows LSQ compete as two more
    # hypotheses under the same objective score
    row_of = jnp.repeat(jnp.arange(r), c)
    w_heur = (row_of < int(init_top_rows * r)).astype(pts.dtype)
    extra = [fit(w_heur)]
    if init_mask is not None:
        w_seed = init_mask.reshape(-1).astype(pts.dtype)
        w_seed = jnp.where(jnp.sum(w_seed) < 32, w_heur, w_seed)
        extra.append(fit(w_seed))
    h_rad = jnp.concatenate([h_rad, jnp.stack([e[0] for e in extra])])
    h_cen = jnp.concatenate([h_cen, jnp.stack([e[1] for e in extra])])

    def pick_best(score_scale):
        """Best hypothesis under the Tukey score at the given scale."""

        def score_one(rad_cen):
            rad, cen = rad_cen
            ok = jnp.isfinite(rad) & jnp.all(jnp.isfinite(cen)) \
                & (rad > 10.0) & (rad < 45.0)
            s = tukey_score(rad, cen, score_scale)
            return jnp.where(ok, s, -1.0)

        # lax.map keeps peak memory at one residual vector per step (a
        # full vmap would materialize (H, R*C) floats)
        scores = jax.lax.map(score_one, (h_rad, h_cen), batch_size=16)
        best = jnp.argmax(scores)
        return h_rad[best], h_cen[best]

    def basin_sigma(radius, center):
        """Tukey-weighted RMS residual at the FIXED 0.5*tol scale."""
        sres = jnp.linalg.norm(pts - center, axis=1) - radius
        u_f = jnp.minimum(jnp.abs(sres) / (0.5 * tol_mm), 1.0)
        w_f = (1.0 - u_f**2) ** 2
        sigma = jnp.sqrt(
            jnp.sum(w_f * sres**2) / jnp.maximum(jnp.sum(w_f), 1.0)
        )
        return jnp.minimum(sigma, 0.5 * tol_mm)

    def pick_and_refine(score_scale, irls_scale):
        """Hypothesis selection + Tukey IRLS at the given scales.

        Returns the refined sphere, its signed residuals, and the
        weighted-RMS residual scale of its own Tukey basin.
        """
        radius, center = pick_best(score_scale)

        # Tukey-weighted IRLS: soft weights keep the fit anchored to the
        # dominant low-residual dome instead of re-admitting
        # shell-grazing tuberosity bands the way a hard threshold does.
        def body(carry, _):
            radius, center = carry
            resid = jnp.abs(
                jnp.linalg.norm(pts - center, axis=1) - radius
            )
            u = jnp.minimum(resid / irls_scale, 1.0)
            w_new = (1.0 - u**2) ** 2
            w_new = jnp.where(jnp.sum(w_new) < 32, w_heur, w_new)
            return fit(w_new), None

        (radius, center), _ = jax.lax.scan(
            body, (radius, center), None, length=iters
        )
        sres = jnp.linalg.norm(pts - center, axis=1) - radius   # signed
        # basin noise, ALWAYS measured at the fixed 0.5*tol scale: tying
        # the measurement to irls_scale feeds back (wider scale -> larger
        # sigma -> wider scale) and inflated the cut thresholds ~2x
        sigma = basin_sigma(radius, center)
        return radius, center, sres, sigma

    # ---- noise-adaptive two-round selection.  Round A runs at the
    # exact-truth-tuned tight scales (0.35/0.5 * tol), which reward the
    # near-zero-residual dome over shell-grazing imposters.  On rough
    # surfaces (a 2 mm-voxel marching-tets CT mesh measures ~0.3-0.5 mm
    # basin RMS vs ~0.02-0.05 mm for exact/scanned meshes) NO hypothesis
    # has a near-zero basin, the tight score is blind, and round A lands
    # on an imposter (CT A/B failure: radius 23.5 vs 26, neckshaft off
    # 32 deg).  Round B re-scores every hypothesis and re-runs the IRLS
    # at scales widened to the measured basin noise — the large true
    # dome then outscores the imposter's thin bands.  On clean surfaces
    # the floors win, round B's scales equal round A's, and the result
    # is identical (golden stability).
    #
    # Round A measures sigma from the best-scoring RAW hypothesis
    # (no IRLS — the advisor-flagged cost fix): on clean meshes a
    # minimal 4-point hypothesis from the dome already has a near-zero
    # basin so the floors still win identically; on rough meshes the
    # raw-hypothesis sigma reads the same surface roughness the refined
    # sphere would (validated by the CT A/B test, tests/test_ct_path.py).
    sigma_a = basin_sigma(*pick_best(0.35 * tol_mm))
    score_b = jnp.maximum(0.35 * tol_mm, 4.5 * sigma_a)
    irls_b = jnp.maximum(0.5 * tol_mm, 4.5 * sigma_a)
    radius, center, sres, sigma = pick_and_refine(score_b, irls_b)
    resid = jnp.abs(sres)

    neg_thr = jnp.maximum(0.4 * tol_mm, 3.0 * sigma)
    pos_thr = jnp.maximum(1.25 * tol_mm, 4.5 * sigma)
    in_thr = jnp.maximum(0.6 * tol_mm, 3.0 * sigma)

    # anatomic-neck dip truncation: the articular surface ENDS where the
    # surface first leaves the sphere shell going distally — the neck
    # recess (sres dives negative) or a marginal osteophyte ridge (sres
    # spikes positive).  Any surface that merely CROSSES the shell lower
    # down (tuberosity flanks) re-enters the inlier band and, without this
    # cut, leaks the mask below the true rim.  Two consecutive rows must
    # agree so scan noise cannot truncate the dome early.
    sres2 = sres.reshape(r, c)
    leave = (sres2 < -neg_thr) | (sres2 > pos_thr)
    leave = leave & jnp.concatenate(
        [leave[1:], jnp.zeros((1, c), bool)], axis=0
    )
    first_leave = jnp.where(
        leave.any(axis=0), jnp.argmax(leave, axis=0), r
    )
    above_rim = (jnp.arange(r)[:, None] < first_leave[None, :]).reshape(-1)

    inlier = (resid < in_thr) & above_rim
    if support_mask is not None:
        # gate statistics are measured against the CLEANED strict mask
        # (the longest cyclic run per row — exactly what the sphere-only
        # arm would output), not the raw inlier set: raw inliers include
        # disconnected shell-grazing fragments that inflate the strict
        # fraction and hide a collapsed consensus from the rescue test
        # (observed: cleaned arthritic masks of 4-9% of the image while
        # the raw set cleared the rescue threshold).
        strict = _longest_cyclic_run_per_row(
            inlier.reshape(r, c)
        ).reshape(-1)
        sup = support_mask.reshape(-1) > 0.5
        disagree = jnp.sum(sup & ~strict) / jnp.maximum(jnp.sum(sup), 1)
        # fail-safe plausibility gate (round-4 regression fix): an
        # out-of-domain CNN produces a mask that persistently disagrees —
        # which used to be the ONLY engagement condition, so garbage
        # support pixels within support_tol of the shell (tuberosity
        # flanks below the rim) leaked in and biased healthy neck-shaft
        # by ~-25 deg (VERDICT r4 weak #3).  The CNN now earns the right
        # to widen the mask only by looking PLAUSIBLE against the sphere
        # family (tools/debug_support_gate.py prints these statistics):
        #   * recall: it must cover the strict consensus dome — a mask
        #     that misses the dome is mis-domained (measured stale-CNN
        #     recall 0.68-0.99, so this alone is insufficient, but it
        #     rejects under-segmenting failures);
        #   * disagree UPPER bound: genuine arthritic flattening adds a
        #     bounded coherent sector beyond the strict inliers
        #     (flattening affects one flank of the cap), while the
        #     measured out-of-domain CNN claims 42-62% of its own mask
        #     beyond the consensus on HEALTHY bones — anything that far
        #     from the sphere family is distrusted wholesale and the
        #     output degrades gracefully to the plain consensus.
        recall = jnp.sum(sup & strict) / jnp.maximum(jnp.sum(strict), 1)
        # rescue branch: on strongly deformed heads the strict consensus
        # itself COLLAPSES (the first-departure cut truncates at the
        # flattening onset / osteophyte ridge; measured strict masks of
        # 4-9% of the image on arthritic bones vs 13-17% healthy).  Then
        # `disagree` is huge for ANY correct mask — the plausibility gate
        # above would lock out exactly the case the CNN exists to fix
        # (the arthritic-capable CNN role, reference anatomic_neck.py:61).
        # When the strict set is implausibly small for an articular dome,
        # the recall/disagree tests (both measured against that broken
        # set) are waived and the bounded-residual support engages.
        strict_frac = jnp.sum(strict) / strict.shape[0]
        plausible = (
            (disagree < support_max_disagree)
            & (recall > support_min_recall)
        )
        rescue = strict_frac < support_rescue_max_frac
        # (a "takeover" variant — replacing the consensus entirely with
        # the CNN mask cut by a sphere fit to the CNN's own pixels when
        # recall vs the collapsed consensus is near zero — was measured
        # and REJECTED: flattened-cap masks balloon any sphere fit,
        # robust or not, and the downstream rim plane then flips side /
        # retroversion on 2 of 8 arthritic bones.  The bounded union
        # below keeps the consensus dome as the anchor instead.)
        engage = (disagree > support_min_disagree) & (plausible | rescue)
        inlier = strict | (
            engage & sup & (resid < support_tol_factor * tol_mm)
        )
    raw = inlier.reshape(r, c)
    mask = _longest_cyclic_run_per_row(raw)
    mean_resid = jnp.sum(jnp.where(mask.reshape(-1), resid, 0.0)) / jnp.maximum(
        jnp.sum(mask), 1
    )
    return mask.astype(points.dtype), radius, center, mean_resid
