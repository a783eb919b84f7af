"""Process-level JAX setup: the persistent compile cache and a CPU pin.

`enable_compilation_cache` runs when `shoulder_tpu` is imported.
`force_cpu` is for host-side tools and tests only; no library path
calls it.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache (gitignored): a fixed path, because the path is
# part of what makes a later process find the entries
CACHE_ROOT = Path(__file__).resolve().parents[2] / ".jax_cache"


def _machine_key() -> str:
    """Stable key for the host's ISA feature set.

    XLA:CPU AOT executables bake in the *compile* machine's vector ISA;
    deserializing one on a host with different features can execute
    illegal instructions (observed as a "could lead to execution errors
    such as SIGILL" loader warning when a home-dir cache was shared
    across machine types).  Keying the cache dir by the CPU flag set
    makes a cross-machine hit impossible.  GPU executables are keyed by
    XLA itself (the device kind is part of the cache key).
    """
    import hashlib
    import platform as _pf

    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    h = hashlib.sha256(f"{_pf.machine()}|{feats}".encode()).hexdigest()[:12]
    return f"{_pf.machine()}-{h}"


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already caches there and
    nothing is set in code.  Otherwise the cache goes to the fixed
    `<checkout>/.jax_cache/<machine-key>`.  `SHOULDER_TPU_CACHE=off`
    disables it (the test suite does).  Returns the directory in use, or
    None when disabled.  JAX's own persistence gates (min compile time,
    entry size) are left untouched.
    """
    if os.environ.get("SHOULDER_TPU_CACHE", "").lower() in (
            "0", "off", "none", "disable"):
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache_dir = CACHE_ROOT / _machine_key()
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
    except OSError:  # read-only checkout: run uncached
        return None
    jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    return str(cache_dir)


def force_cpu(num_devices: int = 1) -> None:
    """Pin this process to `num_devices` CPU devices (tools and tests).

    Best called before the first backend query; a process whose CPU
    backend is already up with too few devices has its backends rebuilt.
    """
    import jax.extend.backend as jeb

    jax.config.update("jax_platforms", "cpu")
    if num_devices > 1:
        try:
            jax.config.update("jax_num_cpu_devices", num_devices)
        except RuntimeError:  # backends already initialized
            if len(jax.devices()) < num_devices:
                jeb.clear_backends()
                jax.config.update("jax_num_cpu_devices", num_devices)
