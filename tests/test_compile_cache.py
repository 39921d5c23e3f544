"""The entry points' persistent compilation cache location."""

import os

import jax

from orb_slam3_noted_tpu.utils import compile_cache as cc

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cc.enable_compile_cache()
        assert path == os.path.join(CHECKOUT, ".jax_cache")
        assert os.path.isabs(path)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.cache_dir() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
