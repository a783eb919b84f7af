"""Batched per-stage wall-time profile of the landmark pipeline.

Companion to profile_pipeline.py (single bone): vmaps each stage over a
replicated batch, so per-stage scaling (batch 8 vs 64 — PERF.md's
sub-linearity chase) and the roofline ledger's stage times come from the
same tool.  Stage boundaries match profile_pipeline.py; timings are the
min over repeats, each ending in block_until_ready.

Run:  python tools/profile_batch.py [batch] [stl_path]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import jax
    import jax.numpy as jnp

    from shoulder_tpu.config import DEFAULT_CONFIG as cfg
    from shoulder_tpu.io import ingest
    from shoulder_tpu.models import forest
    from shoulder_tpu.ops import slicing
    from shoulder_tpu.pipeline import batch as B
    from shoulder_tpu.pipeline import landmarks as L

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    stl_path = (
        sys.argv[2]
        if len(sys.argv) > 2
        else "/root/reference/tests/test_bones/humerus_left.stl"
    )
    spec = ingest.load_bone(stl_path)
    bones = jax.block_until_ready(
        jax.device_put(B.stack_bones([spec] * batch))
    )
    rf = jax.block_until_ready(jax.device_put(forest.load_params()))

    ledger = []

    def timeit(name, fn, *args, reps=3):
        f = jax.jit(fn)
        t0 = time.time()
        out = jax.block_until_ready(f(*args))
        tc = time.time() - t0
        times = []
        for _ in range(reps):
            t0 = time.time()
            out = jax.block_until_ready(f(*args))
            times.append(time.time() - t0)
        dt = min(times)
        ledger.append((name, dt))
        print(f"{name:26s} compile {tc:6.1f}s   exec {dt * 1e3:8.1f} ms"
              f"   ({dt / batch * 1e3:6.1f} ms/bone)", flush=True)
        return out

    from shoulder_tpu.utils import geometry as geom

    verts_obb = jax.block_until_ready(jax.jit(jax.vmap(
        lambda v, t: geom.transform_pts(v, t)
    ))(bones.verts, bones.obb_transform))
    sg = timeit("0 sorted_geom", jax.vmap(slicing.sorted_geom),
                verts_obb, bones.faces, bones.neighbors, bones.face_orig)

    def bt_i(i):
        return jax.tree.map(lambda x: x[i], bones)

    def stack_fn(interp_num, band, n_z, z_from, z_to):
        def one(v, f, nbr, sg1, zmax, zmin):
            zs = jnp.linspace(z_from(zmax, zmin), z_to(zmax, zmin), n_z)
            return slicing.slice_stack(
                v, f, nbr, zs, interp_num, cfg.max_chain, 150, band, sg=sg1
            )
        return jax.vmap(one)

    full = timeit(
        "A slice_stack 200x100",
        stack_fn(cfg.full.interp_num, cfg.full.band, cfg.full.zslice_num,
                 lambda zx, zn: cfg.z_inset * zx,
                 lambda zx, zn: cfg.z_inset * zn),
        verts_obb, bones.faces, bones.neighbors, sg, bones.z_max,
        bones.z_min,
    )

    def neck_one(f_stack, bone, sg1):
        return L._surgical_neck(f_stack, bone, False, cfg, cfg.max_chain,
                                sg=sg1)

    neck = timeit("B surgical_neck", jax.vmap(neck_one), full, bones, sg)
    neck_z = neck[0]

    def prox_one(v, f, nbr, sg1, zmax, nz):
        zs = jnp.linspace(cfg.z_inset * zmax, nz, cfg.proximal.zslice_num)
        return slicing.slice_stack(
            v, f, nbr, zs, cfg.proximal.interp_num, cfg.max_chain, 150,
            cfg.proximal.band, sg=sg1,
        )

    prox = timeit("C slice_stack 600x512", jax.vmap(prox_one),
                  verts_obb, bones.faces, bones.neighbors, sg, bones.z_max,
                  neck_z)

    canal = timeit(
        "D canal",
        jax.vmap(lambda f_stack, bone: L._canal(f_stack, bone, False, cfg)),
        full, bones,
    )

    groove = timeit(
        "E groove",
        jax.vmap(lambda p, bone, c: L._groove(p, bone, c, rf, cfg,
                                              chunk=16)),
        prox, bones, canal[2],
    )

    # E drill-down: peaks-vs-forest split for the sub-linearity chase
    def peaks_only(p):
        cents = p.centroids
        n = p.zs.shape[0]
        s, e = L._cutoff_bounds(n, cfg.groove_cutoff)
        theta, r = jax.vmap(L._to_polar_start)(
            p.contours[s:e], cents[s:e]
        )
        r0 = r - jnp.mean(r, axis=1, keepdims=True)
        from shoulder_tpu.ops import signal as sig

        def one(row):
            radius = sig.savgol_filter(-row, cfg.groove_savgol_window,
                                       cfg.groove_savgol_polyorder)
            rolled = jnp.roll(radius, -jnp.argmin(radius))
            pk = sig.find_peaks(rolled, cfg.groove_peak_height,
                                cfg.groove_peak_prominence,
                                cfg.groove_peak_width,
                                max_peaks=cfg.max_peaks_per_slice)
            return pk["idx"], pk["valid"]

        return jax.lax.map(one, r0, batch_size=16)

    timeit("E1 find_peaks only", jax.vmap(peaks_only), prox)

    anp = timeit(
        "F anatomic_neck",
        jax.vmap(lambda p, bone, t: L._anatomic_neck(p, bone, t, cfg)),
        prox, bones, groove[2],
    )

    def dist_one(v, f, nbr, sg1, zmin):
        zs = jnp.linspace(cfg.z_inset * zmin, 0.0, cfg.distal.zslice_num)
        return slicing.slice_stack(
            v, f, nbr, zs, cfg.distal.interp_num, cfg.max_chain, 150,
            cfg.distal.band, sg=sg1,
        )

    dist = timeit("G slice_stack 200x500", jax.vmap(dist_one),
                  verts_obb, bones.faces, bones.neighbors, sg, bones.z_min)

    timeit(
        "G2 transepicondylar",
        jax.vmap(lambda d, bone, c, a: L._transepicondylar(d, bone, c, a,
                                                           cfg)),
        dist, bones, canal[2], anp[5],
    )

    full_t = timeit(
        "FULL batch",
        lambda b, r: B.compute_landmarks_batch(b, r, chunk=50),
        bones, rf, reps=4,
    )
    del full_t
    ssum = sum(dt for _, dt in ledger[:-1])
    print(f"\nstage sum {ssum * 1e3:8.1f} ms vs FULL "
          f"{ledger[-1][1] * 1e3:8.1f} ms (overlap/fusion differences "
          f"expected)")


if __name__ == "__main__":
    main()
