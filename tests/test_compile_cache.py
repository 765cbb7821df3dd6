"""The compile-cache rule every script shares (utils/runtime.py)."""

import pathlib

import jax

from geometricmultigridpressuresolver_tpu.utils import runtime as cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_environment_directory_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_directory_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = cache.enable_compile_cache()
        assert cache.enable_compile_cache() == first
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    path = pathlib.Path(first)
    assert path.parent == ROOT
    assert f"{path.name}/" in (ROOT / ".gitignore").read_text().split()
