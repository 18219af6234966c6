"""The compile-cache helper: $JAX_COMPILATION_CACHE_DIR when set (and then
nothing else is set), else a fixed directory inside the checkout."""

import os

import jax

from miniraytracer_tpu.utils import compile_cache as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = cc.enable_compile_cache()
        assert d == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_from_environment_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
