"""Generate an in-domain training corpus for the articular UNet.

Round-1's segmenter was trained on images synthesized directly in polar
space, which left a domain gap vs the images the pipeline actually builds
(groove-anchored roll, real OBB orientation, surgical-neck-windowed z range,
interp/normalization quirks).  This tool closes the gap by generating
randomized synthetic humeri (shoulder_tpu.io.testdata, including arthritic
deformations) and running each through the REAL pipeline stages to produce
its polar-radius image, with exact generative supervision: bones are built
in the identity frame, so each pixel's 3D point maps analytically to a
(ring, theta) cell of the generator's articular-flag grid — the label
lookup runs on device and the per-batch readback is ONE packed transfer.

Output .npz: images (N,512,512) float16, masks (N,512,512) uint8.

Run:  python tools/make_unet_corpus.py out.npz [n_bones] [seed]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

BATCH = 8
N_RINGS, N_THETA = 160, 128


def _random_params(rng, arth_frac: float = 0.5):
    p = dict(
        length=rng.uniform(240.0, 320.0),
        shaft_radius=rng.uniform(9.0, 13.0),
        head_radius=rng.uniform(19.0, 28.0),
        neck_shaft_deg=rng.uniform(120.0, 150.0),
        retroversion_deg=rng.uniform(8.0, 45.0),
        # anatomical groove azimuth (coupled to retroversion, like the
        # generator's default) with +-20 deg jitter: the image roll anchor
        # varies in training without making the bone non-anatomical
        groove_theta_deg=None,
        _groove_jitter=rng.uniform(-20.0, 20.0),
        groove_depth=rng.uniform(1.5, 3.5),
        groove_width_deg=rng.uniform(10.0, 18.0),
        epicondyle_half_width=rng.uniform(24.0, 34.0),
        side=("left" if rng.random() < 0.5 else "right"),
    )
    # a fraction of the corpus carries arthritic deformations (BASELINE
    # config 4); the default 0.5 mixes evenly, a higher arth_frac builds
    # arthritic-weighted corpora (the hard regime for the segmenter)
    if rng.random() < arth_frac:
        p.update(
            head_flattening=rng.uniform(0.0, 0.28),
            osteophyte_amp=rng.uniform(0.0, 2.5),
            surface_noise=rng.uniform(0.0, 0.5),
        )
    return p


def build_corpus(n_bones: int, seed: int = 0, out_path=None,
                 arth_frac: float = 0.5):
    import jax
    import jax.numpy as jnp

    from shoulder_tpu.config import DEFAULT_CONFIG as cfg
    from shoulder_tpu.io import ingest, stl
    from shoulder_tpu.io import testdata
    from shoulder_tpu.io.testdata import synthetic_humerus
    from shoulder_tpu.models import forest
    from shoulder_tpu.ops import slicing
    from shoulder_tpu.pipeline import batch as B
    from shoulder_tpu.pipeline import landmarks as L
    from shoulder_tpu.pipeline import packing
    from shoulder_tpu.utils import geometry as geom

    rf = forest.load_params()

    def extract_one(bt, label_grid, length, z_top, neck_frac):
        """The pipeline's exact polar-image build (landmarks._anatomic_neck
        input path) + on-device generative label lookup.

        The window bottom is set explicitly from `neck_frac` (fraction of
        the build-frame length) instead of the surgical-neck changepoint:
        on the synthetic area curves the 1-bkp CPD can land inside the
        dome, which would yield dome-only images — the lower mask edge
        (the thing the UNet must learn, PARITY round-1 failure mode) would
        never appear in training.  Randomizing neck_frac doubles as
        window-depth augmentation.
        """
        verts_obb = geom.transform_pts(bt.verts, bt.obb_transform)
        zs_full = jnp.linspace(
            cfg.z_inset * bt.z_max, cfg.z_inset * bt.z_min,
            cfg.full.zslice_num,
        )
        full = slicing.slice_stack(
            verts_obb, bt.faces, bt.neighbors, zs_full,
            cfg.full.interp_num, cfg.max_chain, 50, cfg.full.band,
        )
        neck_ct = jnp.stack([jnp.zeros(()), jnp.zeros(()),
                             neck_frac * length])
        neck_z = geom.transform_pts(neck_ct[None, :], bt.obb_transform)[0, 2]
        zs_prox = jnp.linspace(
            cfg.z_inset * bt.z_max, neck_z, cfg.proximal.zslice_num
        )
        prox = slicing.slice_stack(
            verts_obb, bt.faces, bt.neighbors, zs_prox,
            cfg.proximal.interp_num, cfg.max_chain, 50, cfg.proximal.band,
        )
        _, _, canal_axis, _, _ = L._canal(full, bt, False, cfg)
        _, _, bg_theta, _, _ = L._groove(prox, bt, canal_axis, rf, cfg,
                                         chunk=16)

        # the pipeline's exact anatomic-neck polar image build
        image, pts = L._anp_image_points(prox, bg_theta, cfg)

        # identity build frame: pixel -> (ring, theta) grid cell
        pts_ct = geom.transform_pts(
            pts.reshape(-1, 3), geom.inv_transform(bt.obb_transform)
        )
        z0 = jnp.clip(pts_ct[:, 2], 0.0, z_top)
        ring = jnp.clip(
            jnp.round(z0 / z_top * (N_RINGS - 1)).astype(jnp.int32),
            0, N_RINGS - 1,
        )
        th = jnp.arctan2(pts_ct[:, 1], pts_ct[:, 0])
        col = jnp.round(
            (th + jnp.pi) / (2 * jnp.pi) * N_THETA
        ).astype(jnp.int32) % N_THETA
        mask = label_grid[ring, col].reshape(image.shape)
        return image, mask

    extract = jax.jit(jax.vmap(extract_one))

    # warm the D2H channel before any big program (see bench.py)
    _ = float(np.asarray(jax.jit(jnp.sum)(jnp.ones(8))))

    rng = np.random.default_rng(seed)
    images, masks = [], []
    i = 0
    while len(images) < n_bones:
        specs, grids, lengths, ztops, fracs_in = [], [], [], [], []
        while len(specs) < BATCH:
            i += 1
            params = _random_params(rng, arth_frac)
            jitter = params.pop("_groove_jitter")
            params["groove_theta_deg"] = (
                320.0 - params["retroversion_deg"] + jitter
            )
            v, f, label = synthetic_humerus(
                return_head_label=True, n_rings=N_RINGS, n_theta=N_THETA,
                **params,
            )
            nbr, watertight = stl.edge_face_adjacency(f)
            try:
                spec = ingest.spec_from_arrays(
                    f"synth{i}", v.astype(np.float32), f.astype(np.int32),
                    nbr, watertight,
                )
            except ValueError:
                continue  # exceeds padding; resample
            specs.append(spec)
            grids.append(
                label[: N_RINGS * N_THETA]
                .reshape(N_RINGS, N_THETA)
                .astype(np.float32)
            )
            lengths.append(np.float32(params["length"]))
            ztops.append(np.float32(testdata.truth_geometry(
                **{k: v for k, v in params.items()
                   if k in ("length", "head_radius", "neck_shaft_deg",
                            "retroversion_deg", "side")}
            )["z_top"]))
            fracs_in.append(np.float32(rng.uniform(0.68, 0.86)))
        bones = B.stack_bones(specs)
        im_b, mk_b = packing.fetch(
            extract(bones, jnp.asarray(np.stack(grids)),
                    jnp.asarray(np.stack(lengths)),
                    jnp.asarray(np.stack(ztops)),
                    jnp.asarray(np.stack(fracs_in)))
        )
        fracs = []
        for im, mk in zip(np.asarray(im_b), np.asarray(mk_b)):
            frac = float(mk.mean())
            fracs.append(round(frac, 3))
            if not np.isfinite(im).all() or not (0.05 < frac < 0.95):
                continue  # degenerate extraction; resampled next batch
            images.append(im.astype(np.float16))
            masks.append(mk.astype(np.uint8))
        print(f"[corpus] {len(images)}/{n_bones} fracs={fracs}", flush=True)
        if out_path is not None and images:  # incremental checkpoint
            np.savez_compressed(
                out_path, images=np.stack(images), masks=np.stack(masks)
            )
    images, masks = images[:n_bones], masks[:n_bones]
    return np.stack(images), np.stack(masks)


def main():
    out = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 192
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    arth_frac = float(sys.argv[4]) if len(sys.argv) > 4 else 0.5
    images, masks = build_corpus(n, seed, out_path=out, arth_frac=arth_frac)
    np.savez_compressed(out, images=images, masks=masks)
    print(f"wrote {out}: {images.shape}")


if __name__ == "__main__":
    main()
