"""Dispatch-policy pinning (VERDICT r3 weak #8): which intersection route
each (platform, scene size) class takes — so a policy regression (e.g. a
size class silently falling onto a route that cannot run it) is a test
failure, not a render surprise."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_tpu.ops import trace
from mitsuba_tpu.scene import bvh as bvhlib, ir


def _mesh(n_side, attach=True):
    xx, zz = np.meshgrid(np.linspace(-1, 1, n_side),
                         np.linspace(-1, 1, n_side))
    v = np.stack([xx, np.zeros_like(xx), zz], -1).reshape(-1, 3) \
        .astype(np.float32)
    f = []
    for i in range(n_side - 1):
        for j in range(n_side - 1):
            a = i * n_side + j
            f += [[a, a + 1, a + n_side], [a + 1, a + n_side + 1,
                                           a + n_side]]
    f = np.asarray(f, np.int32)
    s = ir.build_scene(v, f, np.zeros(len(f), np.int32),
                       [{"type": ir.BSDF_DIFFUSE}])
    return bvhlib.attach(s) if attach else s


def _route(scene, platform):
    """Return which route closest_hit runs, without running it."""
    import mitsuba_tpu.ops.bvh_traverse as bt

    calls = []
    with mock.patch.object(trace.jax, "default_backend", lambda: platform), \
            mock.patch.object(trace._isect, "intersect_brute",
                              lambda *a, **k: calls.append("brute")), \
            mock.patch.object(bt, "closest_hit",
                              lambda *a, **k: calls.append("bvh")):
        trace.closest_hit(scene, jnp.zeros((4, 3)), jnp.ones((4, 3)))
    assert len(calls) == 1, calls
    return calls[0]


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("n_side", [10, 40, 60, 150, 190])
def test_policy_by_size(platform, n_side):
    """162, 3042, 6962, 44k and 71k tris: the CPU walks any attached BVH;
    the GPU keeps the brute force up to GPU_BVH_MIN_TRIS."""
    scene = _mesh(n_side)
    if platform == "cpu":
        expect = "bvh"
    else:
        expect = ("brute" if scene.num_triangles <= trace.GPU_BVH_MIN_TRIS
                  else "bvh")
    assert _route(scene, platform) == expect


def test_gpu_crossover_inside_the_size_classes():
    """The fixtures reach both GPU routes: the crossover lies between the
    44k and the 71k sheet."""
    assert _mesh(150).num_triangles <= trace.GPU_BVH_MIN_TRIS \
        < _mesh(190).num_triangles


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_no_bvh_means_brute(platform):
    """Without an attached BVH every platform takes the brute force."""
    assert _route(_mesh(60, attach=False), platform) == "brute"


def test_unknown_platform_raises():
    """There is no default route: a platform without one is an error."""
    with pytest.raises(NotImplementedError, match="metal"):
        _route(_mesh(10), "metal")


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("n_side", [40, 60, 190])
def test_bvh_built_only_where_walked(platform, n_side):
    """Loaders attach a BVH exactly when the scene would then walk it: on
    the GPU not below the crossover, on the CPU above CPU_BVH_MIN_TRIS."""
    bare = _mesh(n_side, attach=False)
    with mock.patch.object(trace.jax, "default_backend", lambda: platform):
        scene = trace.with_bvh_if_walked(bare)
        min_tris = (trace.GPU_BVH_MIN_TRIS if platform == "gpu"
                    else trace.CPU_BVH_MIN_TRIS)
        assert (scene.bvh is not None) == (bare.num_triangles > min_tris)
        if scene.bvh is not None:
            assert _route(scene, platform) == "bvh"
            assert trace.with_bvh_if_walked(scene) is scene


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_any_hit_follows_route(platform):
    """Shadow queries take the same route as closest-hit queries."""
    calls = []
    scene = _mesh(150)
    with mock.patch.object(trace.jax, "default_backend", lambda: platform):
        with mock.patch.object(trace._isect, "occluded_brute",
                               lambda *a, **k: calls.append("brute")):
            import mitsuba_tpu.ops.bvh_traverse as bt
            with mock.patch.object(bt, "any_hit",
                                   lambda *a, **k: calls.append("bvh")):
                trace.any_hit(scene, jnp.zeros((4, 3)), jnp.ones((4, 3)),
                              jnp.ones((4,)))
                expect = trace.route(scene)
    assert calls == [expect]
