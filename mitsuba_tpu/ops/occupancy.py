"""Occupancy-map approximate visibility (the fork's OccupancyMap).

Analog of src/integrators/testOM/myOM.h:10-33: the fork
voxelizes the scene into a 256^3 bit grid and ray-marches it with __m128i
SSE rows to answer shadow queries approximately (biased but much cheaper
than kd-tree traversal, used by the myPath2_OM / LVCBPT_OM variants).

Here the grid is a dense uint8 volume (plain gathers; bit-packing would
save device memory but costs shift/mask ALU per step) and the march is a fixed-count
stepped DDA over the whole wavefront — every lane advances in lockstep,
inactive lanes are masked.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct


@struct.dataclass
class OccupancyMap:
    grid: jax.Array       # (R, R, R) uint8, 1 = occupied
    box_min: jax.Array    # (3,)
    inv_extent: jax.Array  # (3,) 1 / (box_max - box_min)
    res: int = struct.field(pytree_node=False, default=128)


def build(vertices: np.ndarray, indices: np.ndarray, res: int = 128,
          samples_per_edge: int = 2) -> OccupancyMap:
    """Host-side voxelization: each triangle is covered by a barycentric
    sample grid fine enough that adjacent samples land in neighboring
    voxels (conservative for triangles up to ~voxel size per sample step).
    """
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    lo = vertices.min(0) - 1e-4
    hi = vertices.max(0) + 1e-4
    extent = np.maximum(hi - lo, 1e-9)
    voxel = extent / res

    grid = np.zeros((res, res, res), np.uint8)
    p0 = vertices[indices[:, 0]]
    p1 = vertices[indices[:, 1]]
    p2 = vertices[indices[:, 2]]
    # per-triangle sampling density ~ its size in voxels
    e1 = p1 - p0
    e2 = p2 - p0
    steps = np.maximum(
        np.ceil(
            np.maximum(np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1))
            / voxel.min()
        ).astype(np.int64) * samples_per_edge,
        1,
    )
    max_steps = int(steps.max())
    # batch triangles by their step count bucket to bound work
    for s in np.unique(steps):
        sel = steps == s
        a = np.linspace(0, 1, int(s) + 1)
        bu, bv = np.meshgrid(a, a, indexing="ij")
        keep = bu + bv <= 1.0 + 1e-9
        bu, bv = bu[keep], bv[keep]
        pts = (
            p0[sel][:, None, :]
            + e1[sel][:, None, :] * bu[None, :, None]
            + e2[sel][:, None, :] * bv[None, :, None]
        ).reshape(-1, 3)
        cell = np.clip(((pts - lo) / voxel).astype(np.int64), 0, res - 1)
        grid[cell[:, 0], cell[:, 1], cell[:, 2]] = 1

    return OccupancyMap(
        grid=jnp.asarray(grid),
        box_min=jnp.asarray(lo),
        inv_extent=jnp.asarray(1.0 / extent),
        res=res,
    )


def occluded(occ: OccupancyMap, o: jax.Array, d: jax.Array, tmax: jax.Array,
             skip_near_frac: float = 0.02) -> jax.Array:
    """Approximate any-hit: march `res`-proportional fixed steps through the
    grid; blocked if any interior sample lands in an occupied voxel.

    skip_near_frac trims both segment ends (the voxels containing the
    endpoints are occupied by the origin/target surfaces themselves — the
    reference's OM marching skips endpoint cells the same way).
    """
    res = occ.res
    n_steps = res  # ~1 sample per voxel along the longest axis
    t0 = tmax * skip_near_frac
    t1 = tmax * (1.0 - skip_near_frac)
    dt = (t1 - t0) / n_steps
    # normalized grid coords: x in [0, res)
    base = (o - occ.box_min[None, :]) * occ.inv_extent[None, :] * res
    step = d * occ.inv_extent[None, :] * res

    def body(i, blocked):
        t = t0 + dt * (i + 0.5)
        pos = base + step * t[:, None]
        cell = jnp.clip(pos.astype(jnp.int32), 0, res - 1)
        inside = jnp.all((pos >= 0) & (pos < res), axis=-1)
        occ_hit = occ.grid[cell[:, 0], cell[:, 1], cell[:, 2]] > 0
        return blocked | (occ_hit & inside)

    blocked = jax.lax.fori_loop(0, n_steps, body, jnp.zeros(o.shape[:1], bool))
    return blocked


def attach(scene, res: int = 128):
    """Build + attach to the scene pytree (used when cfg.occupancy_shadows)."""
    om = build(np.asarray(scene.vertices), np.asarray(scene.indices), res=res)
    return scene.replace(occupancy=om)
