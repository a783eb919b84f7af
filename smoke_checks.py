"""End-to-end checks of the landmark pipeline on an NVIDIA GPU.

Each phase drives the pipeline through the entry points a user calls, at
the full resolution of `DEFAULT_CONFIG` (200x100 full, 600x512 proximal,
200x500 distal stacks, the UNet segmenter, the RF groove classifier), on
seeded exact-truth synthetic bones (io/testdata.py), and compares what
comes out with a plain reference: the numpy slicer, scipy's find_peaks, a
numpy forest descent, the same program on the CPU backend, and the
generator's own anatomy.  A failed comparison raises AssertionError after
the numbers are printed.

`chip_smoke.py` runs the phases in order; the `gpu`-marked tests
(tests/test_gpu.py) call the same functions.
"""

from __future__ import annotations

import subprocess
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from shoulder_tpu.config import DEFAULT_CONFIG, PipelineConfig

# healthy recovery bounds of the accuracy gate (tests/test_accuracy_gate.py)
HEALTHY_BOUNDS = dict(ns=3.0, rv=4.0, rad=1.5, mean_ns=2.0, mean_rv=2.0)
# GPU vs CPU per-bone agreement.  Both backends run the same float32
# program, but reductions and scatter-adds sum in other orders (atomics on
# the GPU) and the bf16 UNet rounds its activations differently, which
# moves a few mask pixels; the sphere consensus absorbs those, so the
# metrics agree far inside the generator-recovery bounds.  0.05 deg / mm
# is the tolerance the earlier accelerator's sharded-parity check used.
CROSS_DEVICE_TOL = dict(deg=0.05, mm=0.05)
# UNet mask disagreement between devices: bf16 keeps ~3 significant
# digits, and a pixel whose logit sits that close to 0 can flip.  Two XLA
# graphs of the same model on one CPU disagreed on 1e-4 of the pixels.
UNET_MASK_TOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ device
def require_gpu() -> jax.Device:
    """The first JAX device, which must be a GPU; raises otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this check never runs on the CPU"
        )
    return dev


def card_lines() -> list[str]:
    """`name, power.limit` per card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def cpu_device() -> jax.Device:
    return jax.devices("cpu")[0]


def check_precision() -> None:
    """float32 matmuls must not drop to TF32 (set by `import shoulder_tpu`)."""
    prec = jax.config.jax_default_matmul_precision
    log(f"[precision] jax_default_matmul_precision = {prec}")
    assert prec == "highest", prec


# ------------------------------------------------------------ data
def healthy_cohort(n: int, seed: int):
    from shoulder_tpu.io.testdata import exact_truth_cohorts

    return exact_truth_cohorts(n, seed=seed, arthritic=False)[0]


def _obb_verts(spec) -> np.ndarray:
    t = np.asarray(spec.obb_transform, np.float32)
    v = np.asarray(spec.vertices, np.float32)
    return (v @ t[:3, :3].T + t[:3, 3]).astype(np.float32)


def _proximal_zs(spec, cfg: PipelineConfig) -> np.ndarray:
    """Head-to-neck planes: the proximal stack's span on a synthetic bone."""
    z_lo, z_hi = float(spec.z_bounds[0]), float(spec.z_bounds[1])
    top = cfg.z_inset * z_hi
    return np.linspace(top, z_hi - 0.22 * (z_hi - z_lo),
                       cfg.proximal.zslice_num).astype(np.float32)


# ------------------------------------------------------------ phase 1
def check_slice_stack(spec, cfg: PipelineConfig = DEFAULT_CONFIG):
    """The proximal stack (600 planes x 512 points) against the numpy
    oracle host/slicing_np.py.  Returns the device stack."""
    from shoulder_tpu.host import slicing_np
    from shoulder_tpu.ops import slicing

    v = _obb_verts(spec)
    faces = np.asarray(spec.faces, np.int32)
    nbr = np.asarray(spec.neighbors, np.int32)
    zs = _proximal_zs(spec, cfg)
    n_pts = cfg.proximal.interp_num
    st = slicing.slice_stack(
        v, faces, nbr, zs, n_pts, cfg.max_chain, 150, cfg.proximal.band,
        compact_k=cfg.slice_compact_k,
    )
    contours, areas, cents, over = map(
        np.asarray, (st.contours, st.areas, st.centroids, st.overflow))
    assert contours.shape == (zs.shape[0], n_pts, 2), contours.shape
    v64 = v.astype(np.float64)
    d_area = d_cent = d_cont = 0.0
    for i, z in enumerate(zs):
        loop = slicing_np.largest_loop(
            slicing_np.cross_section(v64, faces, nbr, float(z)))
        ref = slicing_np.resample_polygon(
            slicing_np.close_loop(loop["points"]), n_pts)
        d_area = max(d_area, abs(areas[i] - loop["area"]) / abs(loop["area"]))
        d_cent = max(d_cent, float(np.abs(cents[i] - loop["centroid"]).max()))
        d_cont = max(d_cont, float(np.abs(contours[i] - ref).max()))
    log(f"[slice_stack] {zs.shape[0]}x{n_pts} proximal stack vs numpy "
        f"oracle: max rel area err {d_area:.2e} (tol 1e-4), max centroid "
        f"err {d_cent:.2e} mm (tol 1e-3), max contour err {d_cont:.2e} mm "
        f"(tol 2e-3; float32 plane crossings vs float64), overflow planes "
        f"{int(over.sum())}")
    assert not over.any()
    assert d_area < 1e-4 and d_cent < 1e-3 and d_cont < 2e-3
    return st


def _groove_profiles(st, cfg: PipelineConfig) -> np.ndarray:
    """The rolled, smoothed radius profiles the groove stage peaks on."""
    from shoulder_tpu.ops import signal as sig
    from shoulder_tpu.pipeline import landmarks as L

    n = st.zs.shape[0]
    s, e = L._cutoff_bounds(n, cfg.groove_cutoff)
    _, r = jax.vmap(L._to_polar_start)(st.contours[s:e], st.centroids[s:e])
    r0 = r - jnp.mean(r, axis=1, keepdims=True)
    radius = np.asarray(sig.savgol_filter(-r0, cfg.groove_savgol_window,
                                          cfg.groove_savgol_polyorder))
    shift = np.argmin(radius, axis=1)
    return np.stack([np.roll(row, -k) for row, k in zip(radius, shift)])


def check_find_peaks(st, cfg: PipelineConfig = DEFAULT_CONFIG) -> None:
    """Both find_peaks cores on the groove-stage profiles against scipy."""
    import scipy.signal

    from shoulder_tpu.ops import signal as sig

    prof = _groove_profiles(st, cfg)
    kw = dict(height=cfg.groove_peak_height,
              prominence=cfg.groove_peak_prominence,
              width=cfg.groove_peak_width)
    refs = [scipy.signal.find_peaks(row.astype(np.float64), **kw)
            for row in prof]
    for method in ("dense", "rq"):
        out = jax.jit(jax.vmap(lambda x: sig.find_peaks(
            x, kw["height"], kw["prominence"], kw["width"], max_peaks=64,
            method=method)))(prof)
        out = {k: np.asarray(v) for k, v in out.items()}
        d_prom = d_width = 0.0
        n_peaks = 0
        for i, (ref_idx, ref_prop) in enumerate(refs):
            ok = out["valid"][i]
            idx = out["idx"][i][ok]
            o = np.argsort(idx)
            assert idx[o].tolist() == ref_idx.tolist(), (method, i)
            n_peaks += len(ref_idx)
            if len(ref_idx):
                d_prom = max(d_prom, float(np.abs(
                    out["prominences"][i][ok][o] - ref_prop["prominences"]
                ).max()))
                d_width = max(d_width, float(np.abs(
                    out["widths"][i][ok][o] - ref_prop["widths"]).max()))
        log(f"[find_peaks:{method}] {prof.shape[0]} groove profiles x "
            f"{prof.shape[1]}: {n_peaks} peaks, same indices as scipy; max "
            f"prominence err {d_prom:.2e} (tol 1e-4), max width err "
            f"{d_width:.2e} (tol 1e-3)")
        assert d_prom < 1e-4 and d_width < 1e-3


def check_unet(st, cfg: PipelineConfig = DEFAULT_CONFIG) -> None:
    """The plain-JAX UNet on a 512x512 polar image: card against CPU."""
    from shoulder_tpu.models import unet
    from shoulder_tpu.pipeline import landmarks as L

    image, _ = L._anp_image_points(st, jnp.float32(0.0), cfg)
    x = np.asarray(image)[None, :, :, None]
    params = unet.load_default_params()
    fn = jax.jit(unet.apply)
    dev = np.asarray(fn(params, x))
    with jax.default_device(cpu_device()):
        ref = np.asarray(fn(params, x))
    disagree = float(np.mean((dev > 0) != (ref > 0)))
    log(f"[unet] {x.shape[1]}x{x.shape[2]} polar image, bf16 convs: mask "
        f"disagreement {disagree:.2e} of pixels (tol {UNET_MASK_TOL:.0e}), "
        f"max |logit diff| {float(np.abs(dev - ref).max()):.3f}, mask "
        f"fraction {float(np.mean(dev > 0)):.3f}")
    assert np.isfinite(dev).all()
    assert disagree <= UNET_MASK_TOL


def _forest_np(p, x) -> np.ndarray:
    """Plain numpy descent of the forest tables (ONNX BRANCH_LEQ)."""
    feat, thr = np.asarray(p.feature), np.asarray(p.value)
    tc, fc = np.asarray(p.true_child), np.asarray(p.false_child)
    t = np.arange(feat.shape[0])[None, :]
    rows = np.arange(x.shape[0])[:, None]
    idx = np.zeros((x.shape[0], feat.shape[0]), np.int64)
    for _ in range(p.max_depth):
        xv = x[rows, np.clip(feat[t, idx], 0, x.shape[1] - 1)]
        idx = np.where(xv <= thr[t, idx], tc[t, idx], fc[t, idx])
    proba = np.asarray(p.leaf_weights, np.float64)[t, idx].sum(axis=1)
    if p.binary_complement:
        proba[:, 0] = 1.0 - proba[:, 1]
    return proba


def check_forest(seed: int, n_rows: int = 8 * 330 * 7) -> None:
    """Forest descent at the groove stage's batch-8 row count vs numpy."""
    from shoulder_tpu.models import forest

    p = forest.load_params()
    x = np.random.default_rng(seed).normal(
        size=(n_rows, 9)).astype(np.float32)
    dev = np.asarray(forest.predict_proba(p, x))
    ref = _forest_np(p, x)
    err = float(np.abs(dev - ref).max())
    log(f"[forest] {n_rows}x9 samples, {p.feature.shape[0]} trees: max "
        f"|proba diff| vs numpy {err:.2e} (tol 1e-5, float32 leaf sums)")
    assert err < 1e-5


def phase_kernels(seed: int, cfg: PipelineConfig = DEFAULT_CONFIG) -> None:
    check_precision()
    _, _, specs, _ = healthy_cohort(1, seed)
    st = check_slice_stack(specs[0], cfg)
    check_find_peaks(st, cfg)
    check_unet(st, cfg)
    check_forest(seed)


# ------------------------------------------------------------ phase 2
def within_bounds(truth, side, ns, rv, rad,
                  bounds=HEALTHY_BOUNDS) -> list[str]:
    """What misses the generator's truth by a bound or more (empty if
    nothing does)."""
    bad = []
    if side != truth["side"]:
        bad.append(f"side {side} != {truth['side']}")
    if abs(ns - truth["neck_shaft_deg"]) >= bounds["ns"]:
        bad.append(f"neckshaft {ns:.2f} vs {truth['neck_shaft_deg']:.2f}")
    if abs(rv - truth["retroversion_deg"]) >= bounds["rv"]:
        bad.append(f"retroversion {rv:.2f} vs "
                   f"{truth['retroversion_deg']:.2f}")
    if abs(rad - truth["head_radius"]) >= bounds["rad"]:
        bad.append(f"radius {rad:.2f} vs {truth['head_radius']:.2f}")
    return bad


def phase_facade(seed: int, cfg: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """The one-bone planning workflow through `shoulder_tpu.Humerus`."""
    import shoulder_tpu
    from shoulder_tpu.arthroplasty import HumeralHeadOsteotomy
    from shoulder_tpu.io import stl

    names, meshes, _, truths = healthy_cohort(2, seed)
    times = {}
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for name, (v, f) in zip(names, meshes):
            paths.append(Path(td) / f"{name}.stl")
            stl.write_stl(paths[-1], v, f)
        firsts = []
        for path in paths:
            t0 = time.perf_counter()
            hum = shoulder_tpu.Humerus(path, config=cfg)
            t1 = time.perf_counter()
            hum.canal.axis()
            firsts.append((t1 - t0, time.perf_counter() - t1))
        times["ingest_s"] = firsts[1][0]
        times["first_landmark_cold_s"] = firsts[0][1]
        times["first_landmark_warm_s"] = firsts[1][1]
        times["compile_s"] = firsts[0][1] - firsts[1][1]

        hum.apply_csys_canal_transepiconylar()
        ax = np.asarray(hum.canal.axis())
        d = ax[1] - ax[0]
        d = d / np.linalg.norm(d)
        te = np.asarray(hum.trans_epiconylar.axis())
        anp = np.asarray(hum.anatomic_neck.points())
        bg = np.asarray(hum.bicipital_groove.axis())
        side, rv = hum.side(), float(hum.retroversion())
        ns, rad = float(hum.neckshaft()), float(hum.radius_curvature())
        ost = HumeralHeadOsteotomy(hum)
        head, shaft = ost.resect_mesh()
    log(f"[facade] side {side}, retroversion {rv:.2f} (truth "
        f"{truths[1]['retroversion_deg']:.2f}), neckshaft {ns:.2f} (truth "
        f"{truths[1]['neck_shaft_deg']:.2f}), radius {rad:.2f} (truth "
        f"{truths[1]['head_radius']:.2f}); canal axis dir "
        f"{np.round(d, 4).tolist()}; {anp.shape[0]} anatomic-neck points; "
        f"resected head {len(head.faces)} / shaft {len(shaft.faces)} tris")
    assert abs(abs(d[2]) - 1) < 1e-3, "canal axis not on z after csys"
    assert te.shape == (2, 3) and bg.shape == (2, 3) and anp.shape[0] > 100
    assert np.isfinite(te).all() and np.isfinite(bg).all()
    assert len(head.faces) > 0 and len(shaft.faces) > 0
    bad = within_bounds(truths[1], side, ns, rv, rad)
    assert not bad, bad
    return times


# ------------------------------------------------------------ phase 3
def bone_metrics(lm, i):
    """(side, neck-shaft, retroversion, radius) of bone `i` of a batch."""
    return ("left" if bool(lm.side_is_left[i]) else "right",
            float(lm.neckshaft[i]), float(lm.retroversion[i]),
            float(lm.radius_curvature[i]))


def phase_batch(seed: int, n: int = 8, reps: int = 5,
                cfg: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """Batch-`n` healthy bones through compute_landmarks_batch: recovery,
    GPU vs CPU, GPU run-to-run, and the first timings."""
    from shoulder_tpu.pipeline import batch as B

    _, _, specs, truths = healthy_cohort(n, seed)
    bones = B.stack_bones(specs)
    t0 = time.perf_counter()
    lm = jax.block_until_ready(
        B.compute_landmarks_batch(bones, cfg=cfg, chunk=150))
    first = time.perf_counter() - t0
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lm2 = jax.block_until_ready(
            B.compute_landmarks_batch(bones, cfg=cfg, chunk=150))
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    # None on the CPU backend, which has no device allocator stats
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    a, b = B.landmarks_to_numpy(lm), B.landmarks_to_numpy(lm2)

    errs = {"ns": [], "rv": [], "rad": []}
    for i, t in enumerate(truths):
        side, ns, rv, rad = bone_metrics(a, i)
        errs["ns"].append(ns - t["neck_shaft_deg"])
        errs["rv"].append(rv - t["retroversion_deg"])
        errs["rad"].append(rad - t["head_radius"])
        bad = within_bounds(t, side, ns, rv, rad)
        assert not bad, (i, bad)
    errs = {k: np.asarray(v) for k, v in errs.items()}
    log(f"[batch] {n} healthy bones: max |err| neckshaft "
        f"{np.abs(errs['ns']).max():.2f} / retroversion "
        f"{np.abs(errs['rv']).max():.2f} deg / radius "
        f"{np.abs(errs['rad']).max():.2f} mm; mean err "
        f"{errs['ns'].mean():+.2f} / {errs['rv'].mean():+.2f} deg "
        f"(bounds {HEALTHY_BOUNDS})")
    assert abs(errs["ns"].mean()) < HEALTHY_BOUNDS["mean_ns"]
    assert abs(errs["rv"].mean()) < HEALTHY_BOUNDS["mean_rv"]

    rerun = max(float(np.nanmax(np.abs(
        np.asarray(getattr(a, f)) - np.asarray(getattr(b, f)))))
        for f in ("neckshaft", "retroversion", "radius_curvature"))
    log(f"[batch] GPU run-to-run: max per-metric difference {rerun:.3e} "
        f"over {n} bones")

    k = 2
    with jax.default_device(cpu_device()):
        c = B.landmarks_to_numpy(
            B.compute_landmarks_batch(B.stack_bones(specs[:k]), cfg=cfg,
                                      chunk=150))
    worst = {"deg": 0.0, "mm": 0.0}
    for i in range(k):
        gs, gns, grv, grad = bone_metrics(a, i)
        cs, cns, crv, crad = bone_metrics(c, i)
        assert gs == cs, (i, gs, cs)
        worst["deg"] = max(worst["deg"], abs(gns - cns), abs(grv - crv))
        worst["mm"] = max(worst["mm"], abs(grad - crad))
    log(f"[batch] GPU vs CPU on {k} bones: side identical, max angle diff "
        f"{worst['deg']:.3e} deg (tol {CROSS_DEVICE_TOL['deg']}), max "
        f"radius diff {worst['mm']:.3e} mm (tol {CROSS_DEVICE_TOL['mm']})")
    assert worst["deg"] <= CROSS_DEVICE_TOL["deg"]
    assert worst["mm"] <= CROSS_DEVICE_TOL["mm"]
    return dict(first_call_s=first, p50_s=p50, lat_s=lat,
                bones_per_s=n / p50, peak_bytes_in_use=peak,
                rerun_max_diff=rerun)


# ------------------------------------------------------------ phase 4
def phase_cohort(seed: int, n_each: int = 8, batch_size: int = 8,
                 cfg: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """Half healthy, half arthritic STLs streamed through process_cohort."""
    from shoulder_tpu import cohort
    from shoulder_tpu.io import stl
    from shoulder_tpu.io.testdata import exact_truth_cohorts

    paths, truths = [], []
    with tempfile.TemporaryDirectory() as td:
        for names, meshes, _, tr in exact_truth_cohorts(n_each, seed=seed):
            for name, (v, f), t in zip(names, meshes, tr):
                paths.append(Path(td) / f"{name}.stl")
                stl.write_stl(paths[-1], v, f)
                truths.append(t)
        t0 = time.perf_counter()
        res = cohort.process_cohort(paths, config=cfg,
                                    batch_size=batch_size)
        wall = time.perf_counter() - t0
    assert len(res) == len(paths)
    finite = all(np.isfinite([r["retroversion_deg"], r["neckshaft_deg"],
                              r["radius_curvature_mm"]]).all() for r in res)
    sides = sum(r["side"] == t["side"] for r, t in zip(res, truths))
    log(f"[cohort] {len(res)} STLs ({n_each} healthy + {n_each} arthritic), "
        f"batch {batch_size}: all finite {finite}, sides correct "
        f"{sides}/{len(res)}, wall {wall:.1f} s incl. compile")
    assert finite and sides == len(res)
    return dict(wall_s=wall)


# ------------------------------------------------------------ four cards
def _placement(name, arr) -> str:
    parts = [f"{s.device.id}:{tuple(s.data.shape)}"
             for s in arr.addressable_shards]
    return f"{name} shards -> " + ", ".join(parts)


_COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "reduce-scatter",
                "collective-permute")


def _collective_ops(compiled) -> int:
    """Collective instructions in a compiled program's optimized HLO."""
    import re

    pat = r"\b(?:" + "|".join(_COLLECTIVES) + r")(?:-start)?\("
    return len(re.findall(pat, compiled.as_text()))


def _check_cohort_stats(lm, sh, mesh, n_dev: int) -> float:
    """cohort_stats (psum over the mesh) vs numpy moments of the gathered
    metrics; returns the worst moment difference."""
    from shoulder_tpu.parallel import mesh as pmesh

    stats = {k: float(v) for k, v in pmesh.cohort_stats(lm, mesh).items()}
    err = 0.0
    for name, f in (("retroversion", "retroversion"),
                    ("neckshaft", "neckshaft"),
                    ("radius", "radius_curvature")):
        x = np.asarray(getattr(sh, f), np.float64)
        err = max(err, abs(stats[f"mean_{name}"] - np.nanmean(x)),
                  abs(stats[f"std_{name}"] - np.nanstd(x)))
        assert stats[f"n_{name}"] == np.isfinite(x).sum()
    left = float(np.mean(np.asarray(sh.side_is_left)))
    assert abs(stats["left_fraction"] - left) < 1e-6, (stats, left)
    log(f"[four] cohort_stats (psum over {n_dev} cards) vs numpy moments: "
        f"max |diff| {err:.2e} (tol 1e-3), left fraction "
        f"{stats['left_fraction']:.3f} vs {left:.3f}")
    assert err < 1e-3
    return err


def phase_four(seed: int, n_dev: int = 4, n: int = 8, reps: int = 3,
               cfg: PipelineConfig = DEFAULT_CONFIG) -> None:
    """Bone-sharded batch over a 1-D mesh of `n_dev` cards against the
    one-card batched program, plus the psum cohort statistics.

    Every step logs as it ends, with the seconds since the phase began,
    so a stall shows where it is.  The collective runs first on toy
    values: a card-to-card link that cannot start fails in seconds, not
    after the landmark program's compile."""
    from types import SimpleNamespace

    from jax.sharding import NamedSharding, PartitionSpec as P

    from shoulder_tpu.models import forest
    from shoulder_tpu.parallel import mesh as pmesh
    from shoulder_tpu.pipeline import batch as B

    t_start = time.perf_counter()

    def step(msg: str) -> None:
        log(f"[four] {time.perf_counter() - t_start:7.1f} s  {msg}")

    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}"
    mesh = pmesh.bone_mesh(devs[:n_dev])

    x = np.arange(n, dtype=np.float32) + 100.0
    toy = dict(retroversion=x, neckshaft=x, radius_curvature=x,
               side_is_left=x > 103.5)
    _check_cohort_stats(SimpleNamespace(**pmesh.shard_bones(toy, mesh)),
                        SimpleNamespace(**toy), mesh, n_dev)
    step("toy psum answered on every card")

    _, _, specs, truths = healthy_cohort(n, seed)
    wire = B.stack_wire(specs)
    rf = forest.load_params()
    wire_dev = jax.block_until_ready(pmesh.shard_bones(wire, mesh))
    rf_dev = jax.device_put(rf, NamedSharding(mesh, P()))
    step(f"{n} bones drawn and sharded; " + _placement("input verts",
                                                      wire_dev.verts))

    fn = pmesh.sharded_landmark_fn(mesh, cfg=cfg, wire=True)
    compiled = fn.lower(wire_dev, rf_dev).compile()
    n_coll = _collective_ops(compiled)
    step(f"sharded program compiled; {n_coll} collective instructions")
    assert n_coll == 0, "the bone-sharded program must not talk across cards"
    lm = jax.block_until_ready(compiled(wire_dev, rf_dev))
    step("first sharded run done; " + _placement("output neckshaft",
                                                lm.neckshaft))
    assert len({s.device for s in lm.neckshaft.addressable_shards}) == n_dev
    assert all(s.data.shape[0] == n // n_dev
               for s in lm.neckshaft.addressable_shards)
    lat_sh = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(wire_dev, rf_dev))
        lat_sh.append(time.perf_counter() - t0)
    sh = B.landmarks_to_numpy(lm)

    wire_one, rf_one = jax.device_put(wire, devs[0]), jax.device_put(rf,
                                                                     devs[0])
    one_dev = jax.block_until_ready(
        B.compute_landmarks_wire(wire_one, rf_one, cfg=cfg))
    step("one-card program compiled and run")
    lat_one = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(B.compute_landmarks_wire(wire_one, rf_one,
                                                       cfg=cfg))
        lat_one.append(time.perf_counter() - t0)
    one = B.landmarks_to_numpy(one_dev)
    worst = {"deg": 0.0, "mm": 0.0}
    for i, t in enumerate(truths):
        gs, gns, grv, grad = bone_metrics(sh, i)
        os_, ons, orv, orad = bone_metrics(one, i)
        assert gs == os_ == t["side"], (i, gs, os_, t["side"])
        worst["deg"] = max(worst["deg"], abs(gns - ons), abs(grv - orv))
        worst["mm"] = max(worst["mm"], abs(grad - orad))
    step(f"sharded vs one-card on {n} bones: sides identical and correct, "
         f"max angle diff {worst['deg']:.3e} deg, max radius diff "
         f"{worst['mm']:.3e} mm (tol {CROSS_DEVICE_TOL})")
    assert worst["deg"] <= CROSS_DEVICE_TOL["deg"]
    assert worst["mm"] <= CROSS_DEVICE_TOL["mm"]

    _check_cohort_stats(lm, sh, mesh, n_dev)
    step(f"batch-{n} warm p50 of {reps}: {n_dev} cards "
         f"{np.median(lat_sh) * 1e3:.2f} ms, one card "
         f"{np.median(lat_one) * 1e3:.2f} ms")
