"""Multi-device SPMD tests on the 8-virtual-CPU-device mesh — the analog of
the reference testing its cluster path with loopback workers
(mtssrv.cpp:202), but properly faked per SURVEY.md §4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_tpu.integrators import common, path
from mitsuba_tpu.parallel import render_sharded as rs
from mitsuba_tpu.scene import builtin


@pytest.fixture(scope="module")
def cornell16():
    return builtin.cornell_box(width=16, height=16)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(cornell16):
    """dp-sharded render computes the same estimate as the single-device
    render (same (pixel, sample) hash stream), up to fp reduction order."""
    scene, cam = cornell16
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=0)
    ref = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    mesh = rs.make_mesh(8, sp=1)
    img = np.asarray(rs.render_sharded_jit(scene, cam, path.li, cfg, mesh))
    assert np.allclose(img, ref, rtol=1e-4, atol=1e-5)


def test_sample_parallel_axis(cornell16):
    """Splitting spp over the 'sp' axis with psum must reproduce the same
    estimate too (disjoint sample ranges of the same global set)."""
    scene, cam = cornell16
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=0)
    ref = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    mesh = rs.make_mesh(8, sp=4)
    img = np.asarray(rs.render_sharded_jit(scene, cam, path.li, cfg, mesh))
    assert np.allclose(img, ref, rtol=1e-4, atol=1e-5)


def test_train_step_runs_and_reduces_loss(cornell16):
    """Sharded differentiable-rendering step: loss decreases over a few
    SGD iterations on emitter radiance + albedo."""
    scene, cam = cornell16
    cfg = common.RenderConfig(spp=4, max_depth=2, seed=1)
    mesh = rs.make_mesh(4, sp=2)
    target = jnp.zeros((16, 16, 3)) + 0.05

    step = jax.jit(
        lambda s: rs.train_step(s, cam, target, path.li, cfg, mesh, lr=0.1)
    )
    s = scene
    losses = []
    for _ in range(3):
        s, loss = step(s)
        losses.append(float(loss))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_train_step_jit_equals_jitted_train_step(cornell16):
    """train_step_jit (compiled with TRAIN_COMPILER_OPTIONS) computes what
    a plain jit of train_step computes (cam and target are arguments
    there and constants here: only float rounding differs)."""
    scene, cam = cornell16
    cfg = common.RenderConfig(spp=4, max_depth=2, seed=1)
    mesh = rs.make_mesh(4, sp=2)
    target = jnp.zeros((16, 16, 3)) + 0.05
    new_a, loss_a = jax.jit(
        lambda s: rs.train_step(s, cam, target, path.li, cfg, mesh))(scene)
    new_b, loss_b = rs.train_step_jit(scene, cam, target, path.li, cfg, mesh)
    np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(new_a),
                    jax.tree_util.tree_leaves(new_b)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_graft_entry():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    img = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(img)))
    ge.dryrun_multichip(8)


def test_sharded_filtered_splatting_matches_single_device():
    """Non-box reconstruction filters compose with sharding: per-shard
    full films merged by psum equal the single-device filtered render
    (round-1 weak item 9)."""
    from mitsuba_tpu.film import film as filmlib
    from mitsuba_tpu.integrators import common, path
    from mitsuba_tpu.parallel import render_sharded as rs
    from mitsuba_tpu.scene import builtin

    scene, cam = builtin.cornell_box(width=16, height=16)
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=0,
                              filter=filmlib.FILTER_GAUSSIAN)
    mesh = rs.make_mesh(8, sp=2)
    img_sharded = np.asarray(rs.render_sharded_jit(scene, cam, path.li,
                                                   cfg, mesh))
    img_single = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    assert img_sharded.shape == img_single.shape
    assert np.allclose(img_sharded, img_single, rtol=1e-4, atol=1e-5), \
        np.abs(img_sharded - img_single).max()
