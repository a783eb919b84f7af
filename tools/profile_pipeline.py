"""Per-stage wall-time profile of the landmark pipeline on the current device.

The observability tool promised by SURVEY.md §5 (the reference has none):
synchronous timing per stage (each ends in block_until_ready).

Run:  python tools/profile_pipeline.py [stl_path]
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
    from shoulder_tpu.utils import geometry as geom

    stl_path = (
        sys.argv[1]
        if len(sys.argv) > 1
        else "/root/reference/tests/test_bones/humerus_left.stl"
    )
    spec = ingest.load_bone(stl_path)
    bt = jax.block_until_ready(jax.device_put(B.bone_tensors(spec)))
    rf = jax.block_until_ready(jax.device_put(forest.load_params()))

    def timeit(name, fn, *args):
        f = jax.jit(fn)
        t0 = time.time()
        out = jax.block_until_ready(f(*args))
        tc = time.time() - t0
        times = []
        for _ in range(2):
            t0 = time.time()
            out = jax.block_until_ready(f(*args))
            times.append(time.time() - t0)
        print(f"{name:26s} compile+run {tc:6.1f}s   exec {min(times):7.3f}s")
        return out

    verts_obb = jax.block_until_ready(
        jax.jit(lambda b: geom.transform_pts(b.verts, b.obb_transform))(bt)
    )
    zs_full = jnp.linspace(
        cfg.z_inset * bt.z_max, cfg.z_inset * bt.z_min, cfg.full.zslice_num
    )
    zs_dist = jnp.linspace(
        cfg.z_inset * bt.z_min, 0.0, cfg.distal.zslice_num
    )

    def stack(v, z, n):
        return slicing.slice_stack(
            v, bt.faces, bt.neighbors, z, n, cfg.max_chain, 50,
            cfg.proximal.band,
        )

    full = timeit("A slice_stack 200x100",
                  lambda v, z: stack(v, z, cfg.full.interp_num),
                  verts_obb, zs_full)
    neck = timeit("B surgical_neck",
                  lambda f: L._surgical_neck(f, bt, False, cfg, cfg.max_chain),
                  full)
    zs_prox = jnp.linspace(cfg.z_inset * bt.z_max, neck[0],
                           cfg.proximal.zslice_num)
    prox = timeit("C slice_stack 600x512",
                  lambda v, z: stack(v, z, cfg.proximal.interp_num),
                  verts_obb, zs_prox)
    canal = timeit("D canal", lambda f: L._canal(f, bt, False, cfg), full)
    groove = timeit("E groove",
                    lambda p, c: L._groove(p, bt, c, rf, cfg, chunk=16),
                    prox, canal[2])
    anp = timeit("F anatomic_neck",
                 lambda p, t: L._anatomic_neck(p, bt, t, cfg),
                 prox, groove[2])
    dist = timeit("G slice_stack 200x500",
                  lambda v, z: stack(v, z, cfg.distal.interp_num),
                  verts_obb, zs_dist)
    timeit("G2 transepicondylar",
           lambda d, c, a: L._transepicondylar(d, bt, c, a, cfg),
           dist, canal[2], anp[5])
    timeit("FULL compute_landmarks",
           lambda b, r: L.compute_landmarks(b, r, cfg=cfg, chunk=50),
           bt, rf)


if __name__ == "__main__":
    main()
