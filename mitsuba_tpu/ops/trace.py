"""Trace dispatch: pick the intersection route for a scene.

The analog of Scene::rayIntersect (scene.h:187) as a single entry point.
The route follows from two facts the code can observe, the platform and
the triangle count:

  * no BVH attached: the brute force everywhere;
  * CPU: the stackless BVH walk (ops/bvh_traverse.py) whenever a BVH is
    attached;
  * GPU: the brute force up to GPU_BVH_MIN_TRIS triangles, the BVH walk
    above (the crossover measured on an H100 is recorded in PERF.md).

Both routes are plain XLA. Any other platform is an error: there is no
untested default route. Loaders ask `with_bvh_if_walked` whether a scene
should carry a BVH at all, so a BVH is built only where it is walked.
"""
from __future__ import annotations

import jax

from . import intersect as _isect

# GPU crossover: scenes with more triangles than this walk the BVH. On an
# H100 the brute force renders the big-mesh cell faster up to 65,334 tris
# (1.02-2x from 65k down to 24k); at 70k the BVH walk is 1.2x faster, as
# the XLA brute's closest hit slows ~8x past 512 scan chunks (PERF.md).
GPU_BVH_MIN_TRIS = 65536
# CPU: loaded scenes above this size get a BVH (the loaders' threshold
# since the CPU renderer first had a BVH; not measured against the brute
# force)
CPU_BVH_MIN_TRIS = 4096

PLATFORMS = ("cpu", "gpu")


def _platform() -> str:
    platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise NotImplementedError(
            f"no intersection route for platform {platform!r} "
            f"(supported: {', '.join(PLATFORMS)})")
    return platform


def route(scene) -> str:
    """"bvh" or "brute" for this scene on the default platform."""
    platform = _platform()
    if scene.bvh is None:
        return "brute"
    if platform == "gpu" and scene.num_triangles <= GPU_BVH_MIN_TRIS:
        return "brute"
    return "bvh"


def with_bvh_if_walked(scene):
    """`scene` with a BVH attached when a scene of its size walks one on
    the default platform; unchanged otherwise."""
    min_tris = (GPU_BVH_MIN_TRIS if _platform() == "gpu"
                else CPU_BVH_MIN_TRIS)
    if scene.bvh is not None or scene.num_triangles <= min_tris:
        return scene
    from ..scene import bvh as bvhlib
    return bvhlib.attach(scene)


def closest_hit(scene, o: jax.Array, d: jax.Array, tmax=None) -> _isect.Intersection:
    if route(scene) == "bvh":
        from . import bvh_traverse
        return bvh_traverse.closest_hit(scene, scene.bvh, o, d, tmax)
    return _isect.intersect_brute(scene, o, d, tmax)


def any_hit(scene, o: jax.Array, d: jax.Array, tmax) -> jax.Array:
    if route(scene) == "bvh":
        from . import bvh_traverse
        return bvh_traverse.any_hit(scene, scene.bvh, o, d, tmax)
    return _isect.occluded_brute(scene, o, d, tmax)


def closest_and_any(scene, o_c, d_c, tmax_c, o_s, d_s, tmax_s,
                    use_occupancy: bool = False):
    """Closest-hit (o_c, d_c) + shadow any-hit (o_s, d_s) in one call;
    every route decomposes it into the two standard queries."""
    its = closest_hit(scene, o_c, d_c, tmax_c)
    blocked = shadow_blocked(scene, o_s, d_s, tmax_s, use_occupancy)
    return its, blocked


def shadow_blocked(scene, o, d, tmax, use_occupancy: bool = False) -> jax.Array:
    """Shadow query with the optional occupancy-map approximation (the
    fork's _OM integrator variants; biased, cheaper on huge scenes)."""
    if use_occupancy and scene.occupancy is not None:
        from . import occupancy as occlib
        return occlib.occluded(scene.occupancy, o, d, tmax)
    return any_hit(scene, o, d, tmax)


surface_interaction = _isect.surface_interaction
Intersection = _isect.Intersection
