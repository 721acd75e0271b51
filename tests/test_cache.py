"""Compile-cache directory policy (`util/cache.py`)."""

from pathlib import Path

import jax
import pytest

from sirius_tpu.util.cache import setup_compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    # the CPU suite runs without a persistent cache (see conftest.py)
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_var_is_honoured(monkeypatch, tmp_path, restore_cache_dir):
    want = tmp_path / "xla-cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(want))
    assert setup_compile_cache() == str(want)
    assert jax.config.jax_compilation_cache_dir == str(want)
    assert want.is_dir()


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = setup_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert setup_compile_cache() == path
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()
