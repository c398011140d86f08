"""BVH build (host-side, vectorized numpy) for large meshes.

Replacement for the reference's SAH kd-tree builder
(src/librender/gkdtree.h:958 buildInternal, parallel TreeBuilder pool
gkdtree.h:1040-1063, Havran traversal skdtree.cpp:135): instead of a
pointer-based SAH tree with recursive traversal, we build an *implicit
complete binary BVH* over Morton-sorted triangles:

  * triangles sorted by 30-bit Morton code of their centroid (the LBVH
    idea — SURVEY.md §2.6 item 4);
  * leaves are fixed-size chunks of the sorted order, padded to a power of
    two, so the tree is a complete heap: children of node i are 2i+1/2i+2,
    no pointers stored;
  * traversal on device is *stackless* via precomputed miss-links
    (threaded BVH): each ray carries one int32 node cursor — uniform
    control flow, the reference's SSE packet traversal (skdtree.cpp:241)
    widened to the whole wavefront.

Build is O(n log n) fully vectorized numpy — the analog of the reference's
multi-threaded min-max binning, but as array ops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

LEAF_SIZE = 4


@struct.dataclass
class BVH:
    """Device arrays. M = 2L-1 heap nodes over L leaves; leaf i covers
    sorted-triangle chunk [i*LEAF_SIZE, (i+1)*LEAF_SIZE)."""

    aabb_min: jax.Array    # (M,3)
    aabb_max: jax.Array    # (M,3)
    miss_link: jax.Array   # (M,) int32: node to visit when skipping/leaving
    tri_order: jax.Array   # (L*LEAF_SIZE,) int32 original tri id (or -1 pad)
    n_internal: int = struct.field(pytree_node=False, default=0)  # = L-1
    n_leaves: int = struct.field(pytree_node=False, default=1)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes. x: (N,3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_bvh(vertices: np.ndarray, indices: np.ndarray) -> BVH:
    """Host-side build. Returns device-ready arrays.

    Uses the multithreaded C++ builder (native/lbvh.cpp) when available —
    the analog of the reference's parallel kd-tree TreeBuilder pool — and
    falls back to this vectorized numpy implementation otherwise; both
    produce identical arrays (tested)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n = indices.shape[0]

    try:
        from .. import native

        nat = native.build_lbvh(vertices, indices, LEAF_SIZE)
    except Exception:
        nat = None
    if nat is not None:
        amin, amax, miss, order = nat
        n_leaves = (amin.shape[0] + 1) // 2
        return BVH(
            aabb_min=jnp.asarray(amin),
            aabb_max=jnp.asarray(amax),
            miss_link=jnp.asarray(miss),
            tri_order=jnp.asarray(order),
            n_internal=int(n_leaves - 1),
            n_leaves=int(n_leaves),
        )

    p0 = vertices[indices[:, 0]]
    p1 = vertices[indices[:, 1]]
    p2 = vertices[indices[:, 2]]
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5
    lo = centroid.min(0)
    extent = np.maximum(centroid.max(0) - lo, 1e-9)
    order = np.argsort(_morton3((centroid - lo) / extent), kind="stable")

    n_leaves = 1 << max(int(np.ceil(np.log2(max(n, 1) / LEAF_SIZE))), 0)
    cap = n_leaves * LEAF_SIZE
    tri_order = np.full(cap, -1, np.int32)
    tri_order[:n] = order.astype(np.int32)

    # Leaf AABBs over chunks (padding gets inverted boxes -> never hit).
    big = np.float32(3e38)
    pad_min = np.full((cap - n, 3), big, np.float32)
    pad_max = np.full((cap - n, 3), -big, np.float32)
    smin = np.concatenate([tri_min[order], pad_min]).reshape(n_leaves, LEAF_SIZE, 3)
    smax = np.concatenate([tri_max[order], pad_max]).reshape(n_leaves, LEAF_SIZE, 3)
    leaf_min = smin.min(1)
    leaf_max = smax.max(1)

    # Internal AABBs bottom-up, level by level (heap layout).
    m = 2 * n_leaves - 1
    amin = np.empty((m, 3), np.float32)
    amax = np.empty((m, 3), np.float32)
    amin[n_leaves - 1:] = leaf_min
    amax[n_leaves - 1:] = leaf_max
    level_start = n_leaves - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        np_par = level_start - parent_start
        li = np.arange(parent_start, level_start)
        amin[li] = np.minimum(amin[2 * li + 1], amin[2 * li + 2])
        amax[li] = np.maximum(amax[2 * li + 1], amax[2 * li + 2])
        level_start = parent_start

    # Miss links: where to go when a node is skipped or finished.
    # Right sibling if the node is a left child, else parent's miss link.
    miss = np.empty(m, np.int32)
    miss[0] = -1
    idx = np.arange(1, m)
    is_left = (idx % 2) == 1
    # process top-down so parents are ready (heap level order = index order)
    for i in range(1, m):
        miss[i] = i + 1 if (i % 2) == 1 else miss[(i - 1) // 2]

    return BVH(
        aabb_min=jnp.asarray(amin),
        aabb_max=jnp.asarray(amax),
        miss_link=jnp.asarray(miss),
        tri_order=jnp.asarray(tri_order),
        n_internal=int(n_leaves - 1),
        n_leaves=int(n_leaves),
    )


def attach(scene, bvh: BVH | None = None):
    """Attach the stackless BVH; ops/trace.py decides per platform and
    triangle count whether a query walks it."""
    if bvh is None:
        bvh = build_bvh(np.asarray(scene.vertices), np.asarray(scene.indices))
    return scene.replace(bvh=bvh)
