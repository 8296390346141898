"""Persistent compile-cache placement (utils/compile_cache.py)."""

import jax

from dmmt_jpeg_encoder.utils import compile_cache


def test_env_var_set_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_var_unset_uses_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        want = str(compile_cache.REPO_ROOT / ".jax_cache")
        assert got == want
        assert jax.config.jax_compilation_cache_dir == want
        assert (compile_cache.REPO_ROOT / "dmmt_jpeg_encoder").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
