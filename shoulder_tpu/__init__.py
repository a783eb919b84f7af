"""shoulder_tpu: a JAX 3D shoulder-anatomy inference framework.

From-scratch JAX/XLA re-design of the capabilities of
gregspangenberg/shoulder (see SURVEY.md): STL in, anatomic landmarks,
patient coordinate systems, clinical metrics, osteotomy planning and
plotting out — vmappable over bone batches and shardable over a mesh of
GPUs.

Public API mirrors the reference package surface
(reference src/shoulder/__init__.py:1-5).
"""

import jax as _jax

# Geometry correctness requires true f32 matmuls: an unpinned f32 x f32
# matmul may run at reduced precision (bfloat16 passes on the XLA CPU,
# TF32 on a GPU's tensor cores), which costs ~0.05 mm on bone-scale
# coordinates.  The pipeline's matmuls are tiny (Nx3 transforms, Nx2
# projections), so full precision is free; the UNet opts into bf16
# explicitly in its convolutions.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache: the first process pays the
# full-resolution compile, every later process deserializes it
# (JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.jax_cache/<machine>;
# see utils/platform.enable_compilation_cache; SHOULDER_TPU_CACHE=off opts
# out).
from shoulder_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache as _enable_cache,
)

_enable_cache()

__version__ = "1.0.0"
__all__ = ["Humerus", "ProximalHumerus", "Plot", "HumeralHeadOsteotomy"]

_EXPORTS = {
    "Humerus": "shoulder_tpu.bone",
    "ProximalHumerus": "shoulder_tpu.bone",
    "HumeralHeadOsteotomy": "shoulder_tpu.arthroplasty",
    "Plot": "shoulder_tpu.plotting",
}


def __getattr__(name):  # lazy: avoids importing jax-heavy modules for tools
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(name)
