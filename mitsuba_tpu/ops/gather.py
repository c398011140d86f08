"""Table-row fetch for shading data.

All per-hit table fetches (materials, emitters, face vertices) route
through `fetch_rows`, a plain row gather. `fetch_packed` concatenates
several tables that share an index so one gather serves them all.

Differentiability: a gather's gradient scatters the cotangent rows back
onto the table entries that were read.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def fetch_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """table: (T, K) float32; idx: (N,) int32 -> (N, K)."""
    return table[idx]


def fetch_packed(tables: list, idx: jax.Array) -> list:
    """Fetch rows of several (T, k_i) tables at the same indices with ONE
    gather; returns the per-table slices."""
    widths = [tab.shape[1] for tab in tables]
    packed = jnp.concatenate(tables, axis=1)
    out = fetch_rows(packed, idx)
    slices = []
    pos = 0
    for w in widths:
        slices.append(out[:, pos:pos + w])
        pos += w
    return slices
