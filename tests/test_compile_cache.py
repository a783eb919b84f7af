"""Unit tests for the persistent compile cache (utils/platform).

`JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own and nothing is set
in code; otherwise the cache lives at a fixed, gitignored path inside
the checkout, keyed by the host CPU's feature set (a cache shared across
machine types can deserialize XLA:CPU executables compiled for another
ISA, SIGILL class).
"""

import os


def test_machine_key_is_stable_and_wellformed():
    from shoulder_tpu.utils.platform import _machine_key

    k1, k2 = _machine_key(), _machine_key()
    assert k1 == k2                      # deterministic on one host
    arch, h = k1.rsplit("-", 1)
    assert arch                          # platform.machine() prefix
    assert len(h) == 12 and all(c in "0123456789abcdef" for c in h)


def test_cache_dir_is_machine_keyed_and_env_gated(tmp_path, monkeypatch):
    import jax

    from shoulder_tpu.utils import platform as plat

    # the suite runs with the disk cache DISABLED (conftest: the cache
    # WRITE path is the root cause of the round-4 suite segfault);
    # restore whatever dir was configured so this test cannot re-enable
    # cache writes for the rest of the suite
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("SHOULDER_TPU_CACHE", raising=False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = plat.enable_compilation_cache()
        assert d is not None
        assert d.endswith(plat._machine_key())
        assert os.path.isdir(d)

        monkeypatch.setenv("SHOULDER_TPU_CACHE", "off")
        assert plat.enable_compilation_cache() is None
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert plat.enable_compilation_cache() is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_env_cache_dir_is_honoured_and_nothing_set(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; no config is
    written in code."""
    import jax

    from shoulder_tpu.utils import platform as plat

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("SHOULDER_TPU_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert plat.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_default_cache_dir_is_fixed_inside_checkout(monkeypatch):
    """Unset: a fixed, machine-keyed, gitignored path in the checkout."""
    from pathlib import Path

    import jax

    from shoulder_tpu.utils import platform as plat

    repo = Path(__file__).resolve().parents[1]
    assert plat.CACHE_ROOT == repo / ".jax_cache"
    assert ".jax_cache/" in (repo / ".gitignore").read_text().splitlines()
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("SHOULDER_TPU_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d1 = plat.enable_compilation_cache()
        d2 = plat.enable_compilation_cache()
        assert d1 == d2 == str(repo / ".jax_cache" / plat._machine_key())
        assert jax.config.jax_compilation_cache_dir == d1
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
