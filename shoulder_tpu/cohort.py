"""Cohort processing: many bones, one program.

The high-level batched interface the reference's validation scripts loop
one-at-a-time over (reference tests/validate_health.py:5-14,
validate_arthritic.py:5-19): ingest on the host, vmapped (optionally
mesh-sharded) pipeline executions on device, packed readbacks, results as
plain dicts per bone.

Large cohorts run in fixed-size batches with the NEXT batch's host ingest
(STL parse, OBB, head detection) prefetched on a worker thread while the
device executes the current one — the stage pipelining SURVEY.md §2.4
plans in place of device pipeline-parallelism.  Fixed batch shapes also
reuse one compiled program for any cohort size.  The best batch size on
the H100 is not measured yet (ROADMAP 1.3).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np

from shoulder_tpu.config import DEFAULT_CONFIG, PipelineConfig

# the per-bone result dict below reads ONLY these Landmarks fields; the
# cohort readback packs just them (~40 floats/bone) instead of the full
# Landmarks (~40k floats/bone: canal/sn/bg/anp point clouds)
SUMMARY_FIELDS = (
    "side_is_left", "retroversion", "neckshaft", "radius_curvature",
    "neck_z", "canal_axis", "te_axis", "bg_axis", "anp_plane_point",
    "anp_plane_normal", "qc_rf_pos_frac", "qc_mask_area_frac",
    "qc_sphere_resid", "qc_canal_fit_rms", "qc_slice_overflow",
    "qc_peak_overflow", "qc_open_edges",
)


def _summary_tree(lm):
    return {f: getattr(lm, f) for f in SUMMARY_FIELDS}


def _prep_chunk(paths, proximal, config, device_mesh, batch_n):
    """Worker-thread stage: ingest + host wire-stack + start the H2D.

    Runs on the prefetch thread so the STL parse/OBB CPU work AND the
    batch's host-to-device transfer (jax.device_put is async) both overlap
    the device's execution of the previous batch.  Short batches pad with a
    repeat of the last bone.
    """
    import jax

    from shoulder_tpu.io import ingest
    from shoulder_tpu.pipeline import batch as B

    specs = [
        ingest.load_bone(p, proximal=proximal, config=config) for p in paths
    ]
    n_real = len(specs)
    padded = specs + [specs[-1]] * (batch_n - n_real)
    wire = B.stack_wire(padded)
    if device_mesh is not None:
        from shoulder_tpu.parallel import mesh as pmesh

        wire_dev = pmesh.shard_bones(wire, device_mesh)
    else:
        wire_dev = jax.device_put(wire)
    return specs, wire_dev, n_real


def process_cohort(
    stl_paths: Sequence,
    proximal: bool = False,
    config: PipelineConfig = DEFAULT_CONFIG,
    device_mesh=None,
    chunk: int = 150,
    batch_size: int = 8,
) -> list[dict]:
    """Run the full landmark pipeline over a cohort of STL files.

    Returns one dict per bone: name, side, retroversion, neckshaft,
    radius_curvature, canal/TE/groove axes (CT frame), neck_z, and QC.
    With `device_mesh` (jax.sharding.Mesh) each batch shards over devices.
    `batch_size` fixes the compiled batch shape; the cohort streams
    through it with ingest + H2D prefetch (short batches pad with a
    repeat of the last bone, results de-padded).
    """
    import jax

    from shoulder_tpu.models import forest
    from shoulder_tpu.pipeline import batch as B

    if not len(stl_paths):
        return []
    rf = forest.load_params()
    if device_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from shoulder_tpu.parallel import mesh as pmesh

        n_dev = device_mesh.devices.size
        batch_size = max(batch_size, n_dev)
        batch_size += (-batch_size) % n_dev
        rf_dev = jax.device_put(rf, NamedSharding(device_mesh, P()))
        fn = pmesh.sharded_landmark_fn(
            device_mesh, proximal=proximal, cfg=config, chunk=chunk,
            wire=True,
        )
    else:
        rf_dev = jax.device_put(rf)

        def fn(w, r):
            return B.compute_landmarks_wire(
                w, r, proximal=proximal, cfg=config, chunk=chunk
            )

    path_chunks = [
        list(stl_paths[i:i + batch_size])
        for i in range(0, len(stl_paths), batch_size)
    ]

    from shoulder_tpu.pipeline import packing

    specs, lms = [], []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(
            _prep_chunk, path_chunks[0], proximal, config, device_mesh,
            batch_size,
        )
        pending = None  # previous batch: (packed device buffer, lm, n_real)
        for ci, paths in enumerate(path_chunks):
            chunk_specs, wire_dev, n_real = fut.result()
            if ci + 1 < len(path_chunks):
                # prefetch the next batch's ingest + H2D while the device
                # runs this one
                fut = ex.submit(
                    _prep_chunk, path_chunks[ci + 1], proximal, config,
                    device_mesh, batch_size,
                )
            lm = _summary_tree(fn(wire_dev, rf_dev))
            # jit dispatch is async.  Enqueue this batch's single-buffer
            # pack right behind its own compute (the device queue is FIFO,
            # so packing the PREVIOUS batch here would wait out this
            # batch's whole program), then pull the previous batch's
            # already-computed packed buffer to the host while this
            # batch executes — readback no longer idles the device
            # between batches, and only the summary fields travel.
            packed = packing._pack_jitted(lm)
            if pending is not None:
                lms.append(_unpack_batch(*pending))
            pending = (packed, lm, n_real)
            specs.extend(chunk_specs)
        lms.append(_unpack_batch(*pending))

    lm = jax_tree_concat(lms)

    out = []
    for i, spec in enumerate(specs):
        out.append(
            {
                "name": spec.name,
                "side": "left" if bool(lm["side_is_left"][i]) else "right",
                "retroversion_deg": float(lm["retroversion"][i]),
                "neckshaft_deg": float(lm["neckshaft"][i]),
                "radius_curvature_mm": float(lm["radius_curvature"][i]),
                "neck_z": float(lm["neck_z"][i]),
                "canal_axis_ct": np.asarray(lm["canal_axis"][i]),
                "te_axis_ct": np.asarray(lm["te_axis"][i]),
                "bg_axis_ct": np.asarray(lm["bg_axis"][i]),
                "anp_plane_point_ct": np.asarray(lm["anp_plane_point"][i]),
                "anp_plane_normal_ct": np.asarray(
                    lm["anp_plane_normal"][i]
                ),
                "qc": {
                    "rf_pos_frac": float(lm["qc_rf_pos_frac"][i]),
                    "mask_area_frac": float(lm["qc_mask_area_frac"][i]),
                    "sphere_resid_mm": float(lm["qc_sphere_resid"][i]),
                    "canal_fit_rms_mm": float(lm["qc_canal_fit_rms"][i]),
                    "slice_band_overflow": bool(
                        lm["qc_slice_overflow"][i]
                    ),
                    "peak_capacity_overflow": bool(
                        lm["qc_peak_overflow"][i]
                    ),
                    "open_edges": bool(lm["qc_open_edges"][i]),
                },
            }
        )
    return out


def _unpack_batch(packed, lm, n_real):
    """Blocking D2H of one batch's packed summary buffer -> numpy tree."""
    from shoulder_tpu.pipeline import packing

    return packing.unpack(np.asarray(packed), lm), n_real


def jax_tree_concat(lms):
    """Concatenate per-batch numpy result trees, dropping each batch's pad."""
    import jax

    trimmed = [
        jax.tree.map(lambda x: np.asarray(x)[:n], lm) for lm, n in lms
    ]
    return jax.tree.map(lambda *xs: np.concatenate(xs), *trimmed)


def cohort_summary(results: list[dict]) -> dict:
    """Aggregate stats over a processed cohort."""
    retro = np.array([r["retroversion_deg"] for r in results])
    ns = np.array([r["neckshaft_deg"] for r in results])
    rad = np.array([r["radius_curvature_mm"] for r in results])
    return {
        "n": len(results),
        "retroversion_mean": float(np.nanmean(retro)),
        "retroversion_std": float(np.nanstd(retro)),
        "neckshaft_mean": float(np.nanmean(ns)),
        "neckshaft_std": float(np.nanstd(ns)),
        "radius_mean": float(np.nanmean(rad)),
        "left_fraction": float(
            np.mean([r["side"] == "left" for r in results])
        ),
        "qc_flags": int(
            sum(r["qc"]["slice_band_overflow"] or r["qc"]["open_edges"]
                or r["qc"]["peak_capacity_overflow"]
                for r in results)
        ),
    }
