"""GPU-resident smoke subset: runs only where JAX's default device is a GPU
(`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`); the `gpu` fixture
skips it everywhere else. chip_smoke.py runs the same checks at full width
in one process."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


@pytest.fixture(scope="module")
def cornell():
    from mitsuba_tpu.scene import builtin
    return builtin.cornell_box(width=32, height=32)


def test_device_is_gpu(gpu):
    assert gpu.platform == "gpu", jax.devices()


def test_wavefront_matches_path_gpu(cornell):
    from mitsuba_tpu.integrators import common, path, wavefront
    scene, cam = cornell
    cfg = common.RenderConfig(spp=16, max_depth=4, seed=0)
    ref = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    img = np.asarray(wavefront.render_jit(scene, cam, cfg))
    assert np.isfinite(img).all() and 0.05 < img.mean() < 1.0
    assert np.allclose(ref, img, atol=1e-4)


def test_render_matches_cpu_golden_gpu():
    """An on-chip render matches the checked-in CPU golden in value (the
    tolerance covers float reduction order, incl. scatter-add atomics)."""
    import chip_smoke
    from tools.golden_scenes import render_case

    ref = np.load(os.path.join(os.path.dirname(__file__), "golden",
                               "cornell_path.npy"))
    img = render_case("cornell_path")
    mean_rel, tail = chip_smoke.golden_error(img, ref)
    assert mean_rel < chip_smoke.GOLDEN_MEAN_REL, mean_rel
    assert tail < chip_smoke.GOLDEN_TAIL_FRAC, tail


def test_big_mesh_route_matches_brute_gpu():
    """The route trace.py picks for a big mesh agrees with the XLA brute
    force on chords: no leaks, same t."""
    import chip_smoke
    from bench import _bigmesh_scene
    from mitsuba_tpu.ops import intersect, trace

    scene, _ = _bigmesh_scene(16, 16)
    o, d = chip_smoke.chords(1 << 14)
    chip_smoke.agreement(jax.jit(trace.closest_hit)(scene, o, d),
                         jax.jit(intersect.intersect_brute)(scene, o, d))


def test_grid_medium_tracking_gpu():
    """Delta/ratio tracking scans with per-lane grid gathers."""
    from mitsuba_tpu.core.rng import uniform
    from mitsuba_tpu.models import medium as medlib
    n = 8192
    med = medlib.make_grid(np.ones((4, 4, 4), np.float32), 1.0, 0.5,
                           box_min=(-5, -5, -5), box_max=(5, 5, 5))
    lanes = jnp.arange(n, dtype=jnp.uint32)

    def u(j):
        return uniform(jnp.uint32(11), lanes, jnp.uint32(0), j)

    o = jnp.zeros((n, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    W = medlib.transmittance_track(med, u, o, d, jnp.full((n,), 1.0))
    est = np.asarray(jnp.mean(W, 0))
    assert np.allclose(est, np.exp(-1.0), rtol=5e-2), est


def test_vertex_boundary_gradient_gpu():
    """jax.grad of the edge-sampled boundary estimator w.r.t. blocker
    vertices compiles on the GPU and gives a clearly negative gradient."""
    from mitsuba_tpu.integrators import boundary, common
    from test_vertex_grad import BLOCKER_ROWS, shadow_scene

    scene, cam = shadow_scene()
    bc = boundary.BoundaryConfig(n_edge=4, primary=False)

    def loss(theta):
        s = scene.replace(vertices=scene.vertices
                          .at[BLOCKER_ROWS[0]:BLOCKER_ROWS[1], 0]
                          .add(theta))
        cfg = common.RenderConfig(spp=16, max_depth=2, seed=3)
        img = common.render(
            s, cam, lambda s_, c_, o, d, st, cf:
            boundary.li_grad(s_, c_, o, d, st, cf, bc), cfg)
        return jnp.mean(img)

    g = float(jax.grad(loss)(0.0))
    assert np.isfinite(g) and g < -0.1, g
