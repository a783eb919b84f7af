"""Pipeline + facade integration tests (tiny config on the CPU mesh).

The real-fixture full-resolution validation lives in
tests/test_reference_fixtures.py (slow, opt-in via RUN_SLOW=1).
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

from shoulder_tpu.config import tiny_config
from shoulder_tpu.io import ingest, stl
from shoulder_tpu.io.testdata import synthetic_humerus
from shoulder_tpu.pipeline import batch as B


@pytest.fixture(scope="module")
def tiny_cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def synth_spec(tiny_cfg):
    rng = np.random.default_rng(0)
    v, f = synthetic_humerus(rng_transform=rng, n_rings=60, n_theta=48)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "bone.stl")
        stl.write_stl(p, v, f)
        return ingest.load_bone(p, config=tiny_cfg)


@pytest.fixture(scope="module")
def landmarks(synth_spec, tiny_cfg):
    bt = B.stack_bones([synth_spec])
    lm = B.compute_landmarks_batch(bt, cfg=tiny_cfg, chunk=16)
    return B.landmarks_to_numpy(lm)


def test_pipeline_shapes_and_finiteness(landmarks, tiny_cfg):
    lm = landmarks
    assert lm.canal_axis.shape == (1, 2, 3)
    assert lm.te_axis.shape == (1, 2, 3)
    assert np.isfinite(lm.canal_axis).all()
    assert np.isfinite(lm.neckshaft).all()
    assert np.isfinite(lm.radius_curvature).all()
    assert int(lm.sn_n[0]) > 3
    assert int(lm.anp_n[0]) > 10


def test_canal_axis_points_proximal(landmarks, synth_spec):
    # OBB +z is proximal (head end); canal axis row 0 must be the proximal
    # endpoint (reference canal.py:66-78).  Axis is stored in CT space —
    # map it to the OBB frame and compare z.
    lm = landmarks
    assert np.isfinite(lm.canal_axis).all()
    m = np.asarray(synth_spec.obb_transform)
    ax_obb = lm.canal_axis[0] @ m[:3, :3].T + m[:3, 3]
    assert ax_obb[0, 2] > ax_obb[1, 2]
    # the two endpoints span the cutoff-window length along the fit line
    assert np.linalg.norm(ax_obb[0] - ax_obb[1]) > 1.0


def test_batch_consistency_vs_single(synth_spec, tiny_cfg):
    bt1 = B.stack_bones([synth_spec])
    bt3 = B.stack_bones([synth_spec] * 3)
    lm1 = B.landmarks_to_numpy(B.compute_landmarks_batch(bt1, cfg=tiny_cfg, chunk=16))
    lm3 = B.landmarks_to_numpy(B.compute_landmarks_batch(bt3, cfg=tiny_cfg, chunk=16))
    for i in range(3):
        assert lm3.neckshaft[i] == pytest.approx(lm1.neckshaft[0], abs=1e-3)
        assert lm3.radius_curvature[i] == pytest.approx(
            lm1.radius_curvature[0], abs=1e-3
        )
        assert np.allclose(lm3.canal_axis[i], lm1.canal_axis[0], atol=1e-2)


def test_wire_format_matches_direct(synth_spec, tiny_cfg, landmarks):
    """The uint16 wire format is a lossless re-encoding: decode
    reproduces BoneTensors exactly (incl. the -1 neighbor sentinel on
    padding rows) and the wire pipeline reproduces the direct pipeline."""
    import jax

    wire = B.stack_wire([synth_spec])
    bt = jax.tree.map(np.asarray, B.stack_bones([synth_spec]))
    dec = jax.tree.map(np.asarray, B.decode_wire(jax.device_put(wire)))
    assert np.array_equal(dec.faces, bt.faces)
    assert np.array_equal(dec.neighbors, bt.neighbors)
    assert np.array_equal(dec.face_orig, bt.face_orig)
    assert np.array_equal(dec.verts, bt.verts)
    assert dec.obb_transform == pytest.approx(bt.obb_transform)
    assert float(dec.cutoff_lo[0]) == pytest.approx(float(bt.cutoff_lo[0]))

    lm = B.landmarks_to_numpy(
        B.compute_landmarks_wire(wire, cfg=tiny_cfg, chunk=16)
    )
    assert lm.neckshaft[0] == pytest.approx(landmarks.neckshaft[0], abs=1e-4)
    assert np.allclose(lm.canal_axis, landmarks.canal_axis, atol=1e-3)
    assert np.allclose(lm.anp_plane_normal, landmarks.anp_plane_normal,
                       atol=1e-4)


def test_sharded_equals_unsharded(synth_spec, tiny_cfg):
    import jax

    from shoulder_tpu.parallel import mesh as pmesh
    from shoulder_tpu.models import forest
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = len(jax.devices())
    assert n == 8
    mesh = pmesh.bone_mesh()
    bt = B.stack_bones([synth_spec] * n)
    ref = B.landmarks_to_numpy(B.compute_landmarks_batch(bt, cfg=tiny_cfg, chunk=16))

    sharded = pmesh.shard_bones(bt, mesh)
    rf = jax.device_put(forest.load_params(), NamedSharding(mesh, P()))
    fn = pmesh.sharded_landmark_fn(mesh, cfg=tiny_cfg, chunk=16)
    out = fn(sharded, rf)
    out = jax.tree.map(np.asarray, out)
    assert np.allclose(out.neckshaft, ref.neckshaft, atol=1e-3)
    assert np.allclose(out.canal_axis, ref.canal_axis, atol=1e-2)

    # the wire-format sharded program (the cohort runner's path) agrees
    wire = pmesh.shard_bones(B.stack_wire([synth_spec] * n), mesh)
    fn_w = pmesh.sharded_landmark_fn(mesh, cfg=tiny_cfg, chunk=16, wire=True)
    out_w = jax.tree.map(np.asarray, fn_w(wire, rf))
    assert np.allclose(out_w.neckshaft, ref.neckshaft, atol=1e-3)
    assert np.allclose(out_w.canal_axis, ref.canal_axis, atol=1e-2)

    # cohort_stats is a real SPMD collective: psum in the jaxpr, values
    # equal to host nan-aware statistics over the same batch
    jaxpr = str(jax.make_jaxpr(
        pmesh._cohort_stats_fn(mesh),
    )(out.retroversion, out.neckshaft, out.radius_curvature,
      out.side_is_left))
    assert "psum" in jaxpr
    stats = pmesh.cohort_stats(out, mesh)
    assert float(stats["mean_neckshaft"]) == pytest.approx(
        float(np.nanmean(ref.neckshaft)), abs=1e-3
    )
    assert float(stats["std_neckshaft"]) == pytest.approx(
        float(np.nanstd(ref.neckshaft)), abs=1e-3
    )
    assert int(stats["n_neckshaft"]) == n
    assert float(stats["left_fraction"]) == pytest.approx(
        float(np.mean(ref.side_is_left)), abs=1e-6
    )


def test_facade_readme_flow(synth_spec, tiny_cfg, tmp_path):
    import shoulder_tpu

    # write the spec's source mesh and run the published quickstart flow
    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)
    tf = hum.apply_csys_canal_transepiconylar()
    assert tf.shape == (4, 4)
    canal = hum.canal.axis()
    te = hum.trans_epiconylar.axis()
    anp = hum.anatomic_neck.points()
    bg = hum.bicipital_groove.axis()
    assert canal.shape == (2, 3) and te.shape == (2, 3) and bg.shape == (2, 3)
    assert anp.shape[1] == 3 and len(anp) > 10
    # canal is the csys z-axis
    d = canal[0] - canal[1]
    d /= np.linalg.norm(d)
    assert np.allclose(np.abs(d), [0, 0, 1], atol=1e-4)
    assert np.allclose(canal.mean(0), 0, atol=1e-3)
    # metrics are callables returning floats / str
    assert hum.side() in ("left", "right")
    assert np.isfinite(hum.retroversion())
    assert np.isfinite(hum.neckshaft())
    assert hum.radius_curvature() > 0
    # plot
    plot = shoulder_tpu.Plot(hum)
    html = plot.figure.to_html()
    assert "mesh3d" in html and "Canal" in html


def test_facade_csys_roundtrip(synth_spec, tiny_cfg, tmp_path):
    import shoulder_tpu

    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)
    a0 = hum.canal.axis().copy()
    hum.apply_csys_canal_transepiconylar()
    a1 = hum.canal.axis().copy()
    assert not np.allclose(a0, a1)
    hum.apply_csys_ct()
    a2 = hum.canal.axis().copy()
    assert np.allclose(a0, a2, atol=1e-4)
    # custom csys from CT
    rng = np.random.default_rng(1)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    tf = np.eye(4)
    tf[:3, :3] = rot
    tf[:3, 3] = [5.0, -2.0, 1.0]
    hum.apply_csys_custom(tf)
    a3 = hum.canal.axis()
    assert np.allclose(a3, a0 @ rot.T + tf[:3, 3], atol=1e-4)


def test_osteotomy_offsets(synth_spec, tiny_cfg, tmp_path):
    import shoulder_tpu

    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)
    ost = shoulder_tpu.HumeralHeadOsteotomy(hum)
    assert ost.neckshaft_rel == pytest.approx(0.0, abs=1e-4)
    assert ost.retroversion_rel == pytest.approx(0.0, abs=1e-4)
    ost.offest_neckshaft(5.0)
    assert ost.neckshaft_rel == pytest.approx(5.0, abs=1e-4)
    ost.offset_retroversion(4.0)
    assert ost.retroversion_rel == pytest.approx(4.0, abs=1e-3)
    with pytest.raises(ValueError):
        ost.offset_depth(1.0, "bogus")
    head, rest = ost.resect_mesh()
    assert len(head.faces) > 50 and len(rest.faces) > 50
    assert len(head.faces) + len(rest.faces) > len(hum.mesh.faces)


def test_proximal_humerus_variant(tiny_cfg, tmp_path):
    import shoulder_tpu

    rng = np.random.default_rng(3)
    v, f = synthetic_humerus(
        rng_transform=rng, n_rings=60, n_theta=48, proximal_only=True
    )
    p = tmp_path / "prox.stl"
    stl.write_stl(p, v, f)
    ph = shoulder_tpu.ProximalHumerus(p, config=tiny_cfg)
    assert not hasattr(ph, "trans_epiconylar")
    assert not hasattr(ph, "retroversion")
    assert ph.side() in ("left", "right")
    assert np.isfinite(ph.neckshaft())
    assert ph.canal.axis().shape == (2, 3)
    ph.apply_csys_canal_articular()
    assert ph.transform.shape == (4, 4)


def test_unet_segmenter_plumbing(synth_spec, tiny_cfg):
    """segmenter='unet' path compiles and produces finite outputs with a
    randomly initialized UNet (quality comes from training; this guards the
    wiring)."""
    import dataclasses

    import jax

    from shoulder_tpu.models import forest, unet
    from shoulder_tpu.pipeline.landmarks import compute_landmarks

    cfg = dataclasses.replace(tiny_cfg, segmenter="unet")
    params = unet.init_params(jax.random.PRNGKey(0))
    bt = B.bone_tensors(synth_spec)
    lm = compute_landmarks(
        bt, forest.load_params(), proximal=False, cfg=cfg, chunk=16,
        seg_params=params,
    )
    lm = B.landmarks_to_numpy(lm)
    assert np.isfinite(lm.neckshaft)
    assert np.isfinite(lm.anp_plane_normal).all()


def test_cohort_api(synth_spec, tiny_cfg, tmp_path):
    from shoulder_tpu import cohort

    p1 = tmp_path / "a.stl"
    p2 = tmp_path / "b.stl"
    stl.write_stl(p1, synth_spec.vertices_raw, synth_spec.faces_raw)
    stl.write_stl(p2, synth_spec.vertices_raw, synth_spec.faces_raw)
    res = cohort.process_cohort([p1, p2], config=tiny_cfg, chunk=16)
    assert len(res) == 2
    assert res[0]["side"] in ("left", "right")
    assert res[0]["retroversion_deg"] == pytest.approx(
        res[1]["retroversion_deg"], abs=1e-3
    )
    summ = cohort.cohort_summary(res)
    assert summ["n"] == 2
    assert np.isfinite(summ["neckshaft_mean"])

    # streamed batches (batch_size 2 over 3 bones -> a padded short batch)
    # must match the single-batch results bone for bone
    p3 = tmp_path / "c.stl"
    stl.write_stl(p3, synth_spec.vertices_raw, synth_spec.faces_raw)
    res3 = cohort.process_cohort(
        [p1, p2, p3], config=tiny_cfg, chunk=16, batch_size=2
    )
    assert len(res3) == 3
    for r in res3:
        assert r["neckshaft_deg"] == pytest.approx(
            res[0]["neckshaft_deg"], abs=1e-3
        )


def test_open_edges_qc(synth_spec, tiny_cfg, tmp_path):
    """A torn (non-watertight) mesh must raise qc_open_edges, and a healthy
    bone sharing its batch must be unaffected (per-bone failure isolation,
    SURVEY.md §5).  The reference's only guard is a load-time warning
    (mesh.py:24-27); the truncated contours themselves go unflagged."""
    v, f = np.asarray(synth_spec.vertices_raw), np.asarray(synth_spec.faces_raw)
    cent = v[f].mean(axis=1)
    seed = cent[len(f) // 2]
    scale = np.linalg.norm(v.max(0) - v.min(0))
    keep = np.linalg.norm(cent - seed, axis=1) > 0.04 * scale
    assert 3 < (~keep).sum() < len(f) // 4
    p = tmp_path / "torn.stl"
    stl.write_stl(p, v, f[keep])
    with pytest.warns(UserWarning, match="not watertight"):
        spec_torn = ingest.load_bone(p, config=tiny_cfg)

    bt = B.stack_bones([synth_spec, spec_torn])
    lm = B.landmarks_to_numpy(B.compute_landmarks_batch(bt, cfg=tiny_cfg,
                                                        chunk=16))
    assert bool(lm.qc_open_edges[1])
    assert not bool(lm.qc_open_edges[0])
    solo = B.landmarks_to_numpy(
        B.compute_landmarks_batch(B.stack_bones([synth_spec]), cfg=tiny_cfg,
                                  chunk=16)
    )
    assert lm.neckshaft[0] == pytest.approx(float(solo.neckshaft[0]),
                                            abs=1e-3)


def test_landmark_params_honored(synth_spec, tiny_cfg, tmp_path):
    """Non-default reference-API parameters must change the outputs
    (canal.py:19, bicipital_groove.py:26) instead of being silently
    ignored, and they STICK: later default-argument calls reuse them
    (the reference caches the first call's window, canal.py:31)."""
    import shoulder_tpu

    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)

    pts_default = hum.canal.points().copy()
    ax_default = hum.canal.axis().copy()
    pts_narrow = hum.canal.points(cutoff_pcts=(0.45, 0.65)).copy()
    ax_narrow = hum.canal.axis(cutoff_pcts=(0.45, 0.65)).copy()
    # a narrower window keeps fewer centroids and shortens the axis span
    assert len(pts_narrow) < len(pts_default)
    assert (np.linalg.norm(ax_narrow[0] - ax_narrow[1])
            < np.linalg.norm(ax_default[0] - ax_default[1]))
    # sticky: a default-args call reuses the custom window (reference
    # first-call caching), it does NOT reset to defaults
    assert np.allclose(hum.canal.points(), pts_narrow, atol=1e-5)
    # a DIFFERENT explicit window recomputes (documented divergence from
    # the reference's ignore-after-first-call)
    pts_other = hum.canal.points(cutoff_pcts=(0.40, 0.70)).copy()
    assert len(pts_other) != len(pts_narrow)

    hum2 = shoulder_tpu.Humerus(p, config=tiny_cfg)
    bg_default = hum2.bicipital_groove.points().copy()
    # deg_window reaches the pipeline config, triggers a recompute, and
    # sticks across later default-argument calls (on this clean synthetic
    # groove the wider argmin window lands on the same minimum, so assert
    # the plumbing, not a value change)
    hum2.bicipital_groove.points(deg_window=21)
    assert hum2._effective_cfg().groove_deg_window == 21.0
    bg_cut = hum2.bicipital_groove.points(cutoff_pcts=(0.3, 0.6)).copy()
    assert hum2._effective_cfg().groove_deg_window == 21.0  # sticky
    assert hum2._effective_cfg().groove_cutoff == (0.3, 0.6)
    assert len(bg_cut) != len(bg_default) or not np.allclose(
        bg_cut[: len(bg_default)], bg_default
    )


def test_custom_window_survives_apply_csys(synth_spec, tiny_cfg, tmp_path):
    """Regression (VERDICT r2 weak #2): the internal canal.axis() call
    inside apply_csys_* passes default args and must NOT wipe a user's
    custom canal window — the csys must be built FROM the custom-window
    landmarks, and a later default-args read must round-trip them."""
    import shoulder_tpu

    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)

    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)
    pts_custom = hum.canal.points((0.45, 0.65)).copy()
    hum.apply_csys_canal_articular()
    # the override is still in force and the cache was not rebuilt with
    # default windows
    assert hum._effective_cfg().canal_cutoff == (0.45, 0.65)
    pts_after = hum.canal.points()
    assert len(pts_after) == len(pts_custom)
    hum.apply_csys_ct()
    assert np.allclose(hum.canal.points(), pts_custom, atol=1e-5)

    # and the csys itself must differ from the default-window csys when the
    # windows give different canal axes
    hum_d = shoulder_tpu.Humerus(p, config=tiny_cfg)
    tf_default = hum_d.apply_csys_canal_articular().copy()
    hum_c = shoulder_tpu.Humerus(p, config=tiny_cfg)
    hum_c.canal.points((0.45, 0.65))
    tf_custom = hum_c.apply_csys_canal_articular().copy()
    ax_d = hum_d._landmarks()["canal_axis"]
    ax_c = hum_c._landmarks()["canal_axis"]
    if not np.allclose(ax_d, ax_c, atol=1e-6):
        assert not np.allclose(tf_default, tf_custom, atol=1e-8)


def test_validate_eager_construction(synth_spec, tiny_cfg, tmp_path):
    """validate=True restores the reference's eager-failure timing
    (surgical_neck.py:19): landmarks are computed before the ctor returns.
    The default stays lazy (PARITY.md 'Construction eagerness')."""
    import shoulder_tpu

    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    lazy = shoulder_tpu.Humerus(p, config=tiny_cfg)
    assert lazy._lm_cache is None
    eager = shoulder_tpu.Humerus(p, config=tiny_cfg, validate=True)
    assert eager._lm_cache is not None
    assert np.isfinite(eager.neckshaft())


def test_canal_get_transform(synth_spec, tiny_cfg, tmp_path):
    """Canal.get_transform maps the canal axis onto z through the origin
    and is orthonormal (reference canal.py:88-124)."""
    import shoulder_tpu

    p = tmp_path / "synth.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)
    tf = hum.canal.get_transform()
    assert tf.shape == (4, 4)
    r = tf[:3, :3]
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-8)
    ax = hum.canal.axis()
    mapped = ax @ r.T + tf[:3, 3]
    # canal direction -> +z, midpoint -> origin
    d = mapped[0] - mapped[1]
    d /= np.linalg.norm(d)
    assert np.allclose(d, [0, 0, 1], atol=1e-6)
    assert np.allclose(mapped.mean(0), 0, atol=1e-6)


def test_slice_accessor_facade(synth_spec, tiny_cfg, tmp_path):
    import shoulder_tpu

    p = tmp_path / "s.stl"
    stl.write_stl(p, synth_spec.vertices_raw, synth_spec.faces_raw)
    hum = shoulder_tpu.Humerus(p, config=tiny_cfg)
    fs = hum.full_slices
    n = tiny_cfg.full.zslice_num
    cut = (0.35, 0.75)
    zs = fs.zs(cut)
    areas = fs.areas1(cut)
    cents = fs.centroids(cut)
    ixy = fs.ixy(cut)
    assert len(zs) == len(areas) == len(cents) == len(ixy)
    assert ixy.shape[1:] == (2, tiny_cfg.full.interp_num)
    assert (areas > 0).all()
    # quirk parity: itr is cartesian; itr_start_even_theta == itr_start
    assert np.allclose(fs.itr(cut), fs.ixy(cut))
    assert np.allclose(fs.itr_start_even_theta(cut), fs.itr_start(cut))
    # polar consistency: r == |centered xy|
    pol = fs.itr_centered_start(cut)
    xyc = fs.ixy_centered(cut)
    r = np.hypot(xyc[:, 0], xyc[:, 1])
    assert np.allclose(np.sort(pol[:, 1], axis=1), np.sort(r, axis=1),
                       atol=1e-5)
    # proximal + distal stacks exist
    assert hum.proximal_slices.zs((0.2, 0.75)).shape[0] > 0
    assert hum.distal_slices.zs((0.8, 0.99)).shape[0] > 0


def test_process_cohort_empty():
    """An empty cohort returns [] instead of erroring inside the
    streaming setup (no executor, no RF-param load)."""
    from shoulder_tpu.cohort import process_cohort

    assert process_cohort([]) == []
