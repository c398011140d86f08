"""Stackless threaded-BVH traversal over ray wavefronts.

The device-side half of scene/bvh.py: each ray carries a single int32 node
cursor; visiting a node either descends (cursor = left child = 2i+1) when
the slab test passes, or jumps to the precomputed miss link. Leaves test
their LEAF_SIZE triangles in one vectorized step. All rays advance in
lockstep inside one lax.while_loop — the wavefront analog of the
reference's Havran traversal + SSE packets (skdtree.cpp:135,241), with no
recursion and no per-ray stack: every step is plain array work that XLA
compiles for any platform.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..scene.bvh import BVH, LEAF_SIZE
from .intersect import BARY_EPS, Intersection, SHADOW_EPS


def _slab_test(bmin, bmax, o, inv_d, t_best):
    """Ray-AABB slab test. All args (N,3)/(N,). Returns hit mask (N,).

    The per-axis min/max swap erases box inversion, so EMPTY padding
    nodes (bmin=+big, bmax=-big) would register as hits for every ray —
    on a heavily padded tree (power-of-two leaf cap) that degenerates
    traversal into visiting every pad leaf (round-2 bunny pathology:
    ~15k wasted node visits per ray). The explicit validity term culls
    them.

    Each box is widened by a relative hair first: a ray running exactly
    along a box face (a zero direction component, origin on the face
    plane — common on axis-aligned meshes) would otherwise get its slab
    exit at t = 0 from the clamped 1/d and skip triangles it hits."""
    pad = 1e-6 * (1.0 + jnp.maximum(jnp.abs(bmin), jnp.abs(bmax)))
    t0 = (bmin - pad - o) * inv_d
    t1 = (bmax + pad - o) * inv_d
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    t_enter = jnp.max(tmin, axis=-1)
    t_exit = jnp.min(tmax, axis=-1)
    valid = bmin[..., 0] <= bmax[..., 0]
    return (t_enter <= t_exit) & (t_exit > SHADOW_EPS) & (t_enter < t_best) \
        & valid


def _leaf_tris(scene, bvh: BVH, leaf_id):
    """Gather the LEAF_SIZE triangles of each ray's leaf: (N, LEAF, 3) x3.
    Padded slots (-1) get degenerate far-away triangles. leaf_id is clamped:
    internal-node lanes pass a negative id whose result is masked out."""
    leaf_id = jnp.clip(leaf_id, 0, bvh.n_leaves - 1)
    base = leaf_id * LEAF_SIZE
    tidx = bvh.tri_order[base[:, None] + jnp.arange(LEAF_SIZE)[None, :]]  # (N,L)
    pad = tidx < 0
    tsafe = jnp.maximum(tidx, 0)
    i = scene.indices[tsafe]                  # (N,L,3)
    v = scene.vertices
    p0 = v[i[..., 0]]
    e1 = v[i[..., 1]] - p0
    e2 = v[i[..., 2]] - p0
    far = jnp.asarray([3.0e37, 3.0e37, 3.0e37])
    p0 = jnp.where(pad[..., None], far, p0)
    e1 = jnp.where(pad[..., None], 0.0, e1)
    e2 = jnp.where(pad[..., None], 0.0, e2)
    return p0, e1, e2, tsafe


def _tri_hits(o, d, p0, e1, e2, eps=SHADOW_EPS):
    """Moller-Trumbore for (N, L) triangle sets. Returns (t, u, v, hit)."""
    pvec = jnp.cross(d[:, None, :], e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    bad = jnp.abs(det) < 1e-12
    inv_det = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, det))
    tvec = o[:, None, :] - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS) & (t > eps) & ~bad
    return t, u, v, hit


def closest_hit(scene, bvh: BVH, o, d, tmax=None) -> Intersection:
    """Closest hit with the same bit-packed (t, lane) min-reduce as the
    brute path (ops/intersect.py): no argmin and no per-lane fancy
    indexing in the loop body. Barycentrics are recomputed by
    surface_interaction from the winning triangle."""
    from .intersect import LANE_MASK, MISS

    n = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n,), m.INF)
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)
    n_int = bvh.n_internal
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, LEAF_SIZE), 1)
    miss_key = (jax.lax.bitcast_convert_type(MISS, jnp.int32)
                | jnp.int32(LANE_MASK))

    def cond(state):
        node = state[0]
        return jnp.any(node >= 0)

    def body(state):
        node, best_key, best_base = state
        live = node >= 0
        nsafe = jnp.maximum(node, 0)
        bmin = bvh.aabb_min[nsafe]
        bmax = bvh.aabb_max[nsafe]
        best_t = jax.lax.bitcast_convert_type(
            best_key & jnp.int32(~LANE_MASK), jnp.float32)
        box_hit = _slab_test(bmin, bmax, o, inv_d, best_t) & live
        is_leaf = nsafe >= n_int

        # Leaf: test triangles (only meaningful where box_hit & is_leaf).
        leaf_id = nsafe - n_int
        p0, e1, e2, _ = _leaf_tris(scene, bvh, leaf_id)
        t, _, _, hit = _tri_hits(o, d, p0, e1, e2)
        hit = hit & (t < best_t[:, None]) & (t < tmax[:, None]) \
            & (box_hit & is_leaf)[:, None]
        t = jnp.where(hit, t, MISS)
        key = (jax.lax.bitcast_convert_type(t, jnp.int32)
               & jnp.int32(~LANE_MASK)) | lanes
        ckey = jnp.min(key, axis=1)
        better = ckey < best_key
        base = jnp.clip(leaf_id, 0, bvh.n_leaves - 1) * LEAF_SIZE
        best_key = jnp.where(better, ckey, best_key)
        best_base = jnp.where(better, base, best_base)

        descend = box_hit & ~is_leaf
        miss = bvh.miss_link[nsafe]
        nxt = jnp.where(descend, 2 * nsafe + 1, miss)
        node = jnp.where(live, nxt, node)
        return node, best_key, best_base

    state = (
        jnp.zeros((n,), jnp.int32),
        jnp.full((n,), miss_key, jnp.int32),
        jnp.zeros((n,), jnp.int32),
    )
    _, best_key, best_base = jax.lax.while_loop(cond, body, state)
    best_t = jax.lax.bitcast_convert_type(
        best_key & jnp.int32(~LANE_MASK), jnp.float32)
    valid = best_t < MISS
    slot = jnp.clip(best_base + (best_key & LANE_MASK), 0,
                    bvh.tri_order.shape[0] - 1)
    prim = bvh.tri_order[slot]
    prim = jnp.where(valid & (prim >= 0), prim, 0)
    z = jnp.zeros((n,), best_t.dtype)
    return Intersection(
        valid=valid,
        t=jnp.where(valid, best_t, m.INF),
        prim=prim,
        b1=z,
        b2=z,
    )


def any_hit(scene, bvh: BVH, o, d, tmax) -> jax.Array:
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)
    n_int = bvh.n_internal
    limit = tmax * (1.0 - SHADOW_EPS)

    def cond(state):
        node, blocked = state
        return jnp.any(node >= 0)

    def body(state):
        node, blocked = state
        live = node >= 0
        nsafe = jnp.maximum(node, 0)
        bmin = bvh.aabb_min[nsafe]
        bmax = bvh.aabb_max[nsafe]
        box_hit = _slab_test(bmin, bmax, o, inv_d, limit) & live
        is_leaf = nsafe >= n_int
        leaf_id = nsafe - n_int
        p0, e1, e2, tsafe = _leaf_tris(scene, bvh, leaf_id)
        t, _, _, hit = _tri_hits(o, d, p0, e1, e2)
        hit = hit & (t < limit[:, None]) & (box_hit & is_leaf)[:, None]
        if scene.has_null:
            # null-interface (medium boundary) tris don't block shadows
            hit = hit & scene.tri_opaque[tsafe]
        blocked = blocked | jnp.any(hit, axis=1)

        descend = box_hit & ~is_leaf
        miss = bvh.miss_link[nsafe]
        nxt = jnp.where(descend, 2 * nsafe + 1, miss)
        # blocked rays stop traversing
        node = jnp.where(live & ~blocked, nxt, jnp.where(blocked, -1, node))
        return node, blocked

    state = (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), bool))
    _, blocked = jax.lax.while_loop(cond, body, state)
    return blocked
