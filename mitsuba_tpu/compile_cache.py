"""Where compiled XLA programs persist between processes.

`enable()` keeps JAX's persistent compilation cache in
$JAX_COMPILATION_CACHE_DIR when that is set (JAX reads the variable
itself, so nothing is set in code), and otherwise in `.jax_cache` at the
root of the checkout. Call it before the first compilation.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
