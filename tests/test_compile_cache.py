"""Persistent compile-cache placement (mitsuba_tpu/compile_cache.py)."""
import os

import jax
import pytest

from mitsuba_tpu import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_default_is_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_environment_wins(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_cache_dir_is_ignored_by_git():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
