"""Print the support-gate statistics the UNet path feeds sphere_segment.

For a few exact-truth synthetic bones (healthy + arthritic), runs the
pipeline up to the polar image, evaluates the UNet unary, the plain sphere
consensus, and reports: unary area fraction, strict-inlier fraction,
recall (unary coverage of strict inliers), precision (strict inliers in
unary), disagree fraction — the numbers the fail-safe plausibility gate
(models/segment.sphere_segment support_min_recall) decides on.

Run:  python tools/debug_support_gate.py [n]
      python tools/debug_support_gate.py bone1.stl [bone2.stl ...]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from shoulder_tpu.utils.platform import force_cpu  # noqa: E402

force_cpu()

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from shoulder_tpu.config import DEFAULT_CONFIG as cfg
    from shoulder_tpu.io import ingest, stl
    from shoulder_tpu.io.testdata import synthetic_humerus
    from shoulder_tpu.models import forest, segment
    from shoulder_tpu.models import unet as unet_mod
    from shoulder_tpu.ops import slicing
    from shoulder_tpu.pipeline import batch as B
    from shoulder_tpu.pipeline import landmarks as L
    from shoulder_tpu.utils import geometry as geom

    seg_params = unet_mod.load_default_params()
    rf = forest.load_params()
    stl_args = [a for a in sys.argv[1:] if a.endswith(".stl")]
    n = (int(sys.argv[1])
         if len(sys.argv) > 1 and not stl_args else 2)

    def stats_one(bt):
        verts_obb = geom.transform_pts(bt.verts, bt.obb_transform)
        sg = slicing.sorted_geom(verts_obb, bt.faces, bt.neighbors)
        zs_full = jnp.linspace(
            cfg.z_inset * bt.z_max, cfg.z_inset * bt.z_min,
            cfg.full.zslice_num,
        )
        full = slicing.slice_stack(
            verts_obb, bt.faces, bt.neighbors, zs_full,
            cfg.full.interp_num, cfg.max_chain, 50, cfg.full.band, sg=sg,
        )
        neck_z, _, _, _ = L._surgical_neck(full, bt, False, cfg,
                                           cfg.max_chain, sg=sg)
        zs_prox = jnp.linspace(
            cfg.z_inset * bt.z_max, neck_z, cfg.proximal.zslice_num
        )
        prox = slicing.slice_stack(
            verts_obb, bt.faces, bt.neighbors, zs_prox,
            cfg.proximal.interp_num, cfg.max_chain, 50, cfg.proximal.band,
            sg=sg,
        )
        _, _, canal_axis, _, _ = L._canal(full, bt, False, cfg)
        _, _, bg_theta, _, _ = L._groove(prox, bt, canal_axis, rf, cfg,
                                         chunk=16)
        image, pts = L._anp_image_points(prox, bg_theta, cfg)
        unary = unet_mod.segment_image(seg_params, image)
        unary = segment._longest_cyclic_run_per_row(unary > 0.5).astype(
            image.dtype
        )
        m_sphere, rad, cen, _ = segment.sphere_segment(
            pts, cfg.sphere_seg_iters, cfg.sphere_seg_tol_mm,
            cfg.sphere_seg_init_top_rows,
        )
        m_unet, rad_u, cen_u, _ = segment.sphere_segment(
            pts, cfg.sphere_seg_iters, cfg.sphere_seg_tol_mm,
            cfg.sphere_seg_init_top_rows, init_mask=unary,
            support_mask=unary,
            support_tol_factor=cfg.sphere_seg_support_tol,
            support_min_disagree=cfg.sphere_seg_support_min_disagree,
            support_max_disagree=cfg.sphere_seg_support_max_disagree,
            support_min_recall=cfg.sphere_seg_support_min_recall,
            support_rescue_max_frac=cfg.sphere_seg_support_rescue_frac,
        )
        sup = unary.reshape(-1) > 0.5
        strict = m_sphere.reshape(-1) > 0.5
        out = m_unet.reshape(-1) > 0.5
        inter = jnp.sum(sup & strict)
        return jnp.stack([
            jnp.mean(sup.astype(jnp.float32)),
            jnp.mean(strict.astype(jnp.float32)),
            jnp.mean(out.astype(jnp.float32)),
            inter / jnp.maximum(jnp.sum(strict), 1),   # recall
            inter / jnp.maximum(jnp.sum(sup), 1),      # precision
            jnp.sum(sup & ~strict) / jnp.maximum(jnp.sum(sup), 1),
            rad, rad_u,
        ])

    run = jax.jit(jax.vmap(stats_one))

    if stl_args:
        specs = [ingest.load_bone(p) for p in stl_args]
        bones = B.stack_bones(specs)
        out = np.asarray(run(bones))
        print("\n== fixtures ==")
        print("   unary%  strict%  final%   recall  precis  disagree "
              "  r_sph   r_unet")
        for path, row in zip(stl_args, out):
            print("  " + "  ".join(f"{v:6.3f}" for v in row)
                  + f"  {Path(path).name}")
        return

    rng = np.random.default_rng(123)
    for kind in ("healthy", "arthritic"):
        specs = []
        i = 0
        while len(specs) < n:
            i += 1
            p = dict(
                length=float(rng.uniform(250, 310)),
                head_radius=float(rng.uniform(20, 27)),
                neck_shaft_deg=float(rng.uniform(125.0, 145.0)),
                retroversion_deg=float(rng.uniform(15.0, 40.0)),
                side="left" if rng.random() < 0.5 else "right",
            )
            deg = dict(
                head_flattening=float(rng.uniform(0.12, 0.3)),
                osteophyte_amp=float(rng.uniform(0.5, 2.5)),
                surface_noise=float(rng.uniform(0.2, 0.6)),
            ) if kind == "arthritic" else {}
            v, f = synthetic_humerus(rng_transform=rng, **p, **deg)
            nbr, wt = stl.edge_face_adjacency(f)
            try:
                specs.append(ingest.spec_from_arrays(
                    f"d{i}", v.astype(np.float32), f.astype(np.int32),
                    nbr, wt,
                ))
            except ValueError:
                continue
        bones = B.stack_bones(specs)
        out = np.asarray(run(bones))
        print(f"\n== {kind} ==")
        print("   unary%  strict%  final%   recall  precis  disagree "
              "  r_sph   r_unet")
        for row in out:
            print("  " + "  ".join(f"{v:6.3f}" for v in row))


if __name__ == "__main__":
    main()
