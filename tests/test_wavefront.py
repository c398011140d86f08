"""Regenerative wavefront renderer must reproduce the fixed-depth
wavefront exactly (same sample streams, same estimator)."""
import numpy as np

from mitsuba_tpu.integrators import common, path, wavefront
from mitsuba_tpu.scene import builtin


def test_matches_fixed_depth_exactly():
    scene, cam = builtin.cornell_box(width=16, height=16)
    cfg = common.RenderConfig(spp=16, max_depth=4, seed=0)
    ref = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    img = np.asarray(wavefront.render_jit(scene, cam, cfg))
    assert np.allclose(ref, img, atol=1e-5)


def test_lane_split_invariant():
    """Splitting spp across lanes per pixel changes nothing (same global
    sample indices)."""
    scene, cam = builtin.cornell_box(width=8, height=8)
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=2)
    a = np.asarray(wavefront.render_jit(scene, cam, cfg, lanes_per_pixel=1))
    b = np.asarray(wavefront.render_jit(scene, cam, cfg, lanes_per_pixel=4))
    assert np.allclose(a, b, atol=1e-5)


def test_with_env_and_depth1():
    import jax.numpy as jnp

    scene, cam = builtin.cornell_box(width=8, height=8)
    scene = scene.replace(env_radiance=jnp.asarray([0.2, 0.3, 0.4]),
                          has_env=True)
    cfg = common.RenderConfig(spp=8, max_depth=1, seed=1)
    ref = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    img = np.asarray(wavefront.render_jit(scene, cam, cfg))
    assert np.allclose(ref, img, atol=1e-5)


def test_compaction_ladder_invariant():
    """The occupancy compaction ladder (r5: halving-width continuation
    loops over the liveness plateau/tail, with lane->pixel ids carried
    in the state and a scatter-add film) must reproduce the plain
    regenerative render: same samples, only film reduction order may
    differ. fuse=True on CPU decomposes the fused dispatch into the two
    standard trace calls on every route."""
    import jax

    scene, cam = builtin.cornell_box(width=32, height=32)
    cfg = common.RenderConfig(spp=8, max_depth=4, rr_depth=3, seed=3)
    a = np.asarray(jax.jit(
        lambda s, c: wavefront.render(s, c, cfg, lanes_per_pixel=4,
                                      compact=False, fuse=True)
    )(scene, cam))
    b = np.asarray(jax.jit(
        lambda s, c: wavefront.render(s, c, cfg, lanes_per_pixel=4,
                                      compact=True, fuse=True)
    )(scene, cam))
    assert np.abs(a - b).max() < 1e-5
    # and the fused/deferred estimator still equals the plain one
    c = np.asarray(wavefront.render_jit(scene, cam, cfg,
                                        lanes_per_pixel=4))
    assert np.abs(a - c).max() < 1e-5
