"""The compilation-cache rule: JAX_COMPILATION_CACHE_DIR wins as set;
otherwise the cache lives at <checkout>/.jax_cache."""

import os

import jax
import pytest

from iq_tool_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_kept(monkeypatch, tmp_path, restore_cache_dir):
    """JAX reads the variable itself; enable() sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/as/jax/read/it")
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/as/jax/read/it"


def test_checkout_dir_without_env(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
