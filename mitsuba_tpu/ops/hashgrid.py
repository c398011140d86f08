"""Uniform hash grid for photon / point queries.

Replacement for the reference's balanced point kd-tree photon map
(include/mitsuba/render/photonmap.h:36, kNN/radius queries :98-133): a
kd-tree's pointer-chasing kNN is hostile to lockstep batches, so photons
are instead binned into a spatial hash, sorted by cell hash (one
argsort), and range queries walk the 27 neighbor cells with fixed-size
windows into the sorted array. Everything is dense, masked, and divergence-
free; hash collisions only add candidates that the radius test rejects.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class HashGrid(NamedTuple):
    order: jax.Array        # (P,) permutation sorting photons by cell hash
    sorted_hash: jax.Array  # (P,) cell hash per sorted photon (int32; -1 pad)
    cell_size: jax.Array    # () float
    table_size: int


def _cell_hash(ix, iy, iz, table_size: int):
    """Spatial hash of integer cell coords (Teschner et al. constants)."""
    h = (
        ix.astype(jnp.uint32) * jnp.uint32(73856093)
        ^ iy.astype(jnp.uint32) * jnp.uint32(19349663)
        ^ iz.astype(jnp.uint32) * jnp.uint32(83492791)
    )
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


def build(pos: jax.Array, valid: jax.Array, cell_size, table_size: int = 1 << 18
          ) -> HashGrid:
    """Sort points by cell hash. Invalid points sort to the end (hash -1 is
    encoded as table_size so they stay out of every query window)."""
    grid = jnp.floor(pos / cell_size).astype(jnp.int32)
    h = _cell_hash(grid[:, 0], grid[:, 1], grid[:, 2], table_size)
    h = jnp.where(valid, h, jnp.int32(table_size))
    order = jnp.argsort(h)
    return HashGrid(
        order=order.astype(jnp.int32),
        sorted_hash=h[order],
        cell_size=jnp.asarray(cell_size, jnp.float32),
        table_size=table_size,
    )


def query_sum(grid: HashGrid, pos: jax.Array, q: jax.Array, radius: jax.Array,
              reduce_fn, init, window: int = 64):
    """Accumulate over all points within `radius` of each query point.

    reduce_fn(carry, idx, mask) -> carry: called for (Q, window) blocks of
    candidate *original* point indices with a validity mask; it must gather
    its own payloads. `radius` may be per-query (Q,).

    Walks the 3x3x3 neighbor cells; each cell contributes up to `window`
    sorted candidates (photon-dense cells beyond the window are dropped —
    size the grid cell ~ the query radius so cells hold few points; the
    truncation count is returned for monitoring).
    """
    base = jnp.floor(q / grid.cell_size).astype(jnp.int32)
    carry = init
    truncated = jnp.zeros((), jnp.int32)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    for dx, dy, dz in offsets:
        h = _cell_hash(base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz,
                       grid.table_size)
        start = jnp.searchsorted(grid.sorted_hash, h, side="left").astype(jnp.int32)
        end = jnp.searchsorted(grid.sorted_hash, h, side="right").astype(jnp.int32)
        truncated = truncated + jnp.sum((end - start) > window)
        idx_w = start[:, None] + jnp.arange(window, dtype=jnp.int32)[None, :]
        in_cell = idx_w < end[:, None]
        idx_w = jnp.minimum(idx_w, grid.order.shape[0] - 1)
        pidx = grid.order[idx_w]                       # (Q, W) original ids
        d = pos[pidx] - q[:, None, :]
        r2 = jnp.sum(d * d, axis=-1)
        mask = in_cell & (r2 <= (radius * radius)[:, None])
        carry = reduce_fn(carry, pidx, mask)
    return carry, truncated
