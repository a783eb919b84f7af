"""Device slice kernel vs the exact numpy oracle.

Both implementations start each loop at its minimum face index and walk the
same successor map, so ordered contours must agree to float32 precision.
"""

import numpy as np
import pytest

from shoulder_tpu.host import slicing_np
from shoulder_tpu.io import stl
from shoulder_tpu.ops import slicing

from conftest import reference_stl


def _prep(verts, faces):
    nb, wt = stl.edge_face_adjacency(faces)
    assert wt
    return (
        verts.astype(np.float32),
        faces.astype(np.int32),
        nb.astype(np.int32),
    )


def _oracle_contour(verts, faces, nb, z, interp_num):
    loops = slicing_np.cross_section(verts.astype(np.float64), faces, nb, z)
    loop = slicing_np.largest_loop(loops)
    closed = slicing_np.close_loop(loop["points"])
    return slicing_np.resample_polygon(closed, interp_num), loop


@pytest.mark.parametrize("rel_z", [0.15, 0.35, 0.5, 0.75, 0.9])
def test_stack_matches_oracle_synthetic(synthetic_bone, rel_z):
    verts, faces = synthetic_bone
    v32, f32, nb = _prep(verts, faces)
    zlo, zhi = verts[:, 2].min(), verts[:, 2].max()
    z = float(zlo + rel_z * (zhi - zlo))

    stack = slicing.slice_stack(v32, f32, nb, np.array([z], np.float32), 64)
    contour = np.asarray(stack.contours[0])
    oracle, loop = _oracle_contour(verts, faces, nb, z, 64)

    assert np.asarray(stack.areas[0]) == pytest.approx(loop["area"], rel=1e-4)
    assert np.allclose(np.asarray(stack.centroids[0]), loop["centroid"], atol=1e-3)
    assert np.allclose(contour, oracle, atol=2e-3)


def test_stack_matches_oracle_reference_bone():
    p = reference_stl("humerus_left.stl")
    verts, faces, nb, _ = stl.load_indexed(p)
    v32, f32, nb32 = _prep(verts, faces)
    zlo, zhi = verts[:, 2].min(), verts[:, 2].max()
    zs = np.linspace(zlo + 0.05 * (zhi - zlo), zhi - 0.05 * (zhi - zlo), 9)

    stack = slicing.slice_stack(
        v32, f32, nb32, zs.astype(np.float32), 100
    )
    for i, z in enumerate(zs):
        oracle, loop = _oracle_contour(verts, faces, nb, float(z), 100)
        assert np.asarray(stack.areas[i]) == pytest.approx(
            loop["area"], rel=1e-3
        ), f"slice {i}"
        assert np.allclose(
            np.asarray(stack.contours[i]), oracle, atol=5e-3
        ), f"slice {i}"


def test_raw_loop_matches_oracle(synthetic_bone):
    verts, faces = synthetic_bone
    v32, f32, nb = _prep(verts, faces)
    z = float(np.mean(verts[:, 2]))
    raw = slicing.slice_raw(v32, f32, nb, np.float32(z), select="largest")
    loops = slicing_np.cross_section(verts, faces, nb, z)
    loop = slicing_np.largest_loop(loops)
    n = int(raw.n)
    assert n == loop["points"].shape[0]
    assert np.allclose(np.asarray(raw.points[:n]), loop["points"], atol=2e-3)


def test_raw_banded_small_band_clamps_k(synthetic_bone):
    """band < k must not corrupt the compacted set (ADVICE r2: unclamped
    k left scatter slots [band, k) at zero, duplicating window face 0)."""
    verts, faces = synthetic_bone
    v32, f32, nb = _prep(verts, faces)
    z = float(np.mean(verts[:, 2]))
    sg = slicing.sorted_geom(v32, f32, nb)
    full = slicing.slice_raw(v32, f32, nb, np.float32(z), select="largest")
    raw, overflow = slicing.slice_raw_banded(
        sg, np.float32(z), band=256, k=512
    )
    if not bool(overflow):
        n = int(raw.n)
        assert n == int(full.n)
        assert np.allclose(
            np.asarray(raw.points[:n]), np.asarray(full.points[:n]), atol=2e-3
        )


def test_raw_central_selection():
    # two disjoint solids at one z: central selection must pick the one
    # nearer the z-axis even though it is smaller
    def box(extents, center):
        e = np.asarray(extents) / 2.0
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        ) * e + np.asarray(center)
        quads = [
            (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
            (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
        ]
        faces = []
        for a, b, c, d in quads:
            faces.append([a, b, c])
            faces.append([a, c, d])
        return corners, np.array(faces)

    v1, f1 = box([2, 2, 2], [0.5, 0, 0])       # near axis, small
    v2, f2 = box([8, 8, 2], [30.0, 0, 0])      # far away, big
    verts = np.vstack([v1, v2])
    faces = np.vstack([f1, f2 + 8])
    nb, _ = stl.edge_face_adjacency(faces)
    raw = slicing.slice_raw(
        verts.astype(np.float32), faces.astype(np.int32), nb.astype(np.int32),
        np.float32(0.0), select="central",
    )
    pts = np.asarray(raw.points[: int(raw.n)])
    assert np.all(np.abs(pts[:, 0]) < 3.0)  # picked the near-axis box

    raw2 = slicing.slice_raw(
        verts.astype(np.float32), faces.astype(np.int32), nb.astype(np.int32),
        np.float32(0.0), select="largest",
    )
    pts2 = np.asarray(raw2.points[: int(raw2.n)])
    assert np.all(pts2[:, 0] > 20.0)  # picked the big box


def test_stack_batched_vmap_consistency(synthetic_bone):
    import jax

    verts, faces = synthetic_bone
    v32, f32, nb = _prep(verts, faces)
    zlo, zhi = float(verts[:, 2].min()), float(verts[:, 2].max())
    zs = np.linspace(zlo + 5, zhi - 5, 8).astype(np.float32)

    single = slicing.slice_stack(v32, f32, nb, zs, 64)

    vb = np.stack([v32, v32])
    fb = np.stack([f32, f32])
    nbb = np.stack([nb, nb])
    zsb = np.stack([zs, zs])
    batched = jax.vmap(
        lambda v, f, n, z: slicing.slice_stack(v, f, n, z, 64)
    )(vb, fb, nbb, zsb)
    assert np.allclose(
        np.asarray(batched.contours[0]), np.asarray(single.contours), atol=1e-5
    )
    assert np.allclose(
        np.asarray(batched.contours[1]), np.asarray(single.contours), atol=1e-5
    )


def test_walk_path_matches_doubling(synthetic_bone):
    """The doubling path's loop walk reproduces the numpy oracle's walk
    over a whole stack: same largest loop, same start face, same order."""
    verts, faces = synthetic_bone
    v32, f32, nb = _prep(verts, faces)
    zlo, zhi = verts[:, 2].min(), verts[:, 2].max()
    zs = np.linspace(zlo + 5, zhi - 5, 24).astype(np.float32)

    a = slicing.slice_stack(v32, f32, nb, zs, 64, 2048, 8, 1024)
    # overflowed slices (band too small near the synthetic end caps) are
    # QC-flagged and excluded
    ok = ~np.asarray(a.overflow)
    assert ok.sum() >= 20
    for i in np.flatnonzero(ok):
        oracle, loop = _oracle_contour(verts, faces, nb, float(zs[i]), 64)
        assert np.asarray(a.areas)[i] == pytest.approx(loop["area"],
                                                       rel=1e-4)
        assert np.allclose(np.asarray(a.centroids)[i], loop["centroid"],
                           atol=1e-3)
        assert np.allclose(np.asarray(a.contours)[i], oracle, atol=2e-3)


def test_group_slab_matches_per_plane(synthetic_bone):
    """group>1 (shared slab windows) must match the per-plane window path
    bit-for-bit on non-overflowed slices."""
    verts, faces = synthetic_bone
    v32, f32, nb = _prep(verts, faces)
    zlo, zhi = verts[:, 2].min(), verts[:, 2].max()
    # plane spacing dense enough that a group-of-8 window slide fits the
    # slab allowance (production stacks are denser still); a too-coarse
    # grid would only exercise the slab-truncation QC flag
    zs = np.linspace(zhi - 5, zlo + 5, 48).astype(np.float32)

    a = slicing.slice_stack(v32, f32, nb, zs, 64, 2048, 8, 1024)
    g = slicing.slice_stack(v32, f32, nb, zs, 64, 2048, 8, 1024,
                            group=8, slab=12288)
    ok = ~(np.asarray(a.overflow) | np.asarray(g.overflow))
    assert ok.sum() >= 40
    assert np.array_equal(np.asarray(a.contours)[ok],
                          np.asarray(g.contours)[ok])
    assert np.array_equal(np.asarray(a.areas)[ok], np.asarray(g.areas)[ok])


def test_presorted_matches_device_sort(synthetic_bone):
    """sorted_geom(face_orig=...) on ingest-presorted faces must reproduce
    the device-sorted stack exactly (same contours/areas/QC)."""
    from shoulder_tpu.io import ingest

    verts, faces = synthetic_bone
    spec = ingest.spec_from_arrays(
        "t", verts.astype(np.float64), faces.astype(np.int32),
        stl.edge_face_adjacency(faces)[0].astype(np.int32), True,
    )
    t32 = spec.obb_transform.astype(np.float32)
    v_obb = spec.vertices @ t32[:3, :3].T + t32[:3, 3]
    zs = np.linspace(v_obb[:, 2].max() - 5, v_obb[:, 2].min() + 5,
                     16).astype(np.float32)

    import jax.numpy as jnp

    # reconstruct the original (STL-order) layout: the device-sort baseline
    # must see UNSORTED faces so its orig ids are original indices, exactly
    # what face_orig preserves through the ingest pre-sort
    order = spec.face_orig
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=order.dtype)
    faces_u = spec.faces[inv]
    nbr_u = np.where(spec.neighbors >= 0,
                     order[np.clip(spec.neighbors, 0, None)], -1)[inv]

    sg_dev = slicing.sorted_geom(jnp.asarray(v_obb), jnp.asarray(faces_u),
                                 jnp.asarray(nbr_u))
    sg_pre = slicing.sorted_geom(jnp.asarray(v_obb), jnp.asarray(spec.faces),
                                 jnp.asarray(spec.neighbors),
                                 face_orig=jnp.asarray(spec.face_orig))
    a = slicing.slice_stack(v_obb, faces_u, nbr_u, zs, 64,
                            2048, 8, 1024, sg=sg_dev)
    b = slicing.slice_stack(v_obb, spec.faces, spec.neighbors, zs, 64,
                            2048, 8, 1024, sg=sg_pre)
    ok = ~(np.asarray(a.overflow) | np.asarray(b.overflow))
    assert ok.sum() >= 12
    assert np.array_equal(np.asarray(a.contours)[ok],
                          np.asarray(b.contours)[ok])
    assert np.array_equal(np.asarray(a.areas)[ok], np.asarray(b.areas)[ok])
