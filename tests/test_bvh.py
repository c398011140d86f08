"""BVH build + traversal: must agree exactly with the brute-force
intersector on random scenes (test_kd.cpp analog)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_tpu.ops import bvh_traverse, intersect
from mitsuba_tpu.scene import builtin, bvh as bvhlib, ir


def random_tri_scene(n_tris=200, seed=0):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], 0)
    tris = np.stack(
        [np.arange(n_tris), np.arange(n_tris) + n_tris, np.arange(n_tris) + 2 * n_tris],
        -1,
    ).astype(np.int32)
    return ir.build_scene(verts, tris, np.zeros(n_tris, np.int32),
                          [{"type": ir.BSDF_DIFFUSE}])


@pytest.mark.parametrize("n_tris", [3, 64, 500])
def test_bvh_matches_brute_closest(n_tris):
    scene = random_tri_scene(n_tris, seed=n_tris)
    b = bvhlib.build_bvh(np.asarray(scene.vertices), np.asarray(scene.indices))
    rs = np.random.RandomState(1)
    n = 512
    o = jnp.asarray(rs.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = jnp.asarray(rs.normal(size=(n, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ref = intersect.intersect_brute(scene, o, d)
    out = bvh_traverse.closest_hit(scene, b, o, d)
    assert np.array_equal(np.asarray(ref.valid), np.asarray(out.valid))
    hit = np.asarray(ref.valid)
    # the brute path's packed-key reduce truncates t by <= 127 ulps
    # (~1.5e-5 relative), so quasi-tied overlapping triangles may pick a
    # different (equally correct) winner
    assert np.allclose(np.asarray(ref.t)[hit], np.asarray(out.t)[hit], rtol=3e-5)
    prim_match = np.asarray(ref.prim)[hit] == np.asarray(out.prim)[hit]
    t_tied = np.isclose(np.asarray(ref.t)[hit], np.asarray(out.t)[hit], rtol=3e-5)
    assert np.all(prim_match | t_tied)
    assert prim_match.mean() > 0.95


def test_bvh_matches_brute_anyhit():
    scene = random_tri_scene(300, seed=7)
    b = bvhlib.build_bvh(np.asarray(scene.vertices), np.asarray(scene.indices))
    rs = np.random.RandomState(2)
    n = 512
    o = jnp.asarray(rs.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = jnp.asarray(rs.normal(size=(n, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tmax = jnp.asarray(rs.uniform(0.5, 4.0, (n,)).astype(np.float32))
    ref = intersect.occluded_brute(scene, o, d, tmax)
    out = bvh_traverse.any_hit(scene, b, o, d, tmax)
    # brute applies the same (1-eps) guard band
    assert np.array_equal(np.asarray(ref), np.asarray(out))


def test_cornell_render_with_bvh_matches_brute():
    from mitsuba_tpu.integrators import common, path

    scene, cam = builtin.cornell_box(width=16, height=16)
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=0)
    ref = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    scene_b = bvhlib.attach(scene)
    img = np.asarray(common.render_jit(scene_b, cam, path.li, cfg))
    # brute packs (t, prim) into one key (~1e-5 t truncation) so a few
    # seam samples may land on the neighboring coplanar triangle
    assert np.allclose(ref, img, rtol=1e-3, atol=1e-3), np.abs(ref - img).max()


def test_bvh_jit_and_grad_compatible():
    """BVH lives in the pytree: jit caching + grads through hits work."""
    scene = random_tri_scene(64, seed=3)
    scene = bvhlib.attach(scene)

    @jax.jit
    def f(s, o, d):
        its = bvh_traverse.closest_hit(s, s.bvh, o, d)
        return jnp.sum(jnp.where(its.valid, its.t, 0.0))

    o = jnp.zeros((8, 3)) + jnp.asarray([0.0, 0.0, -3.0])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (8, 1))
    v = f(scene, o, d)
    assert np.isfinite(float(v))


# ---------------------------------------------------------------------------
# The big-mesh route (stackless BVH walk) against the XLA brute force on a
# ~8k-triangle fixture.
# ---------------------------------------------------------------------------

def _bunny_or_synthetic():
    import os
    from mitsuba_tpu.io import mesh as meshlib
    path = "/root/reference/data/tests/bunny.ply"
    if os.path.exists(path):
        md = meshlib.load_ply(path)
        return md.vertices, md.indices
    # synthetic: jittered grid of quads (~8k tris)
    g = 64
    xx, zz = np.meshgrid(np.linspace(-1, 1, g), np.linspace(-1, 1, g))
    rng = np.random.RandomState(0)
    yy = rng.uniform(-0.05, 0.05, xx.shape)
    v = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    f = []
    for i in range(g - 1):
        for j in range(g - 1):
            a = i * g + j
            f += [[a, a + 1, a + g], [a + 1, a + g + 1, a + g]]
    return v, np.asarray(f, np.int32)


def _big_scene():
    v, f = _bunny_or_synthetic()
    scene = ir.build_scene(v, f, np.zeros(len(f), np.int32),
                           [{"type": ir.BSDF_DIFFUSE}])
    return bvhlib.attach(scene), v


def _chords(v, n, seed):
    """Incoherent rays: chords through the fixture's bounding sphere."""
    lo, hi = v.min(0), v.max(0)
    center = jnp.asarray((lo + hi) / 2)
    radius = float(np.linalg.norm(hi - lo) / 2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    a = jax.random.normal(k1, (n, 3))
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = jax.random.normal(k2, (n, 3))
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    o = center + a * radius
    d = center + b * radius * 0.5 - o
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True), radius


def _camera_rays(v, n, seed):
    """Coherent rays: one origin above the sheet, a cone of directions."""
    lo, hi = v.min(0), v.max(0)
    center = (lo + hi) / 2
    xy = jax.random.uniform(jax.random.PRNGKey(seed), (n, 2),
                            minval=-0.4, maxval=0.4)
    o = jnp.broadcast_to(jnp.asarray(center + np.array([0.0, 2.0, 0.0],
                                                       np.float32)), (n, 3))
    d = jnp.stack([xy[:, 0], -jnp.ones((n,)), xy[:, 1]], -1)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def _assert_matches_brute(ref, out, min_prim=0.998):
    va, vb = np.asarray(ref.valid), np.asarray(out.valid)
    assert (va == vb).mean() > 0.998
    assert not (va & ~vb).any(), "BVH missed hits that brute force found"
    both = va & vb
    assert np.allclose(np.asarray(ref.t)[both], np.asarray(out.t)[both],
                       rtol=1e-4, atol=1e-5)
    assert (np.asarray(ref.prim)[both]
            == np.asarray(out.prim)[both]).mean() > min_prim


@pytest.mark.parametrize("rays", ["incoherent", "coherent"])
def test_big_mesh_route_matches_brute(rays):
    scene, v = _big_scene()
    n = 1024
    if rays == "incoherent":
        o, d, _ = _chords(v, n, seed=0)
    else:
        o, d = _camera_rays(v, n, seed=1)
    ref = intersect.intersect_brute(scene, o, d)
    out = bvh_traverse.closest_hit(scene, scene.bvh, o, d)
    _assert_matches_brute(ref, out)


def test_big_mesh_route_anyhit_matches_brute():
    scene, v = _big_scene()
    o, d, radius = _chords(v, 1024, seed=4)
    tmax = jnp.full((1024,), radius * 0.8)
    ref = intersect.occluded_brute(scene, o, d, tmax)
    out = bvh_traverse.any_hit(scene, scene.bvh, o, d, tmax)
    assert np.array_equal(np.asarray(ref), np.asarray(out))


def test_bvh_edge_adversarial_no_leaks():
    """Rays aimed exactly through shared triangle edges and vertices —
    the maximal-cancellation points of the Moller-Trumbore numerators.
    Contract: wherever the float32 brute force hits, the BVH walk hits
    too — ZERO leaks — at the same t."""
    scene, v = _big_scene()
    ff = np.asarray(scene.indices)
    vv = np.asarray(v)
    n = 512
    rng = np.random.RandomState(7)
    pick = rng.choice(len(ff), n)
    mid = 0.5 * (vv[ff[pick[: n // 2], 1]] + vv[ff[pick[: n // 2], 2]])
    corner = vv[ff[pick[n // 2:], 0]]
    aim = np.concatenate([mid, corner]).astype(np.float32)
    o = jnp.asarray(aim + np.array([0.0, 2.0, 0.0], np.float32))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))

    ref = intersect.intersect_brute(scene, o, d)
    out = bvh_traverse.closest_hit(scene, scene.bvh, o, d)
    rv, ov = np.asarray(ref.valid), np.asarray(out.valid)
    leaks = rv & ~ov
    assert not leaks.any(), f"edge leaks vs brute: {leaks.sum()}/{n}"
    assert rv.all(), "every aimed ray lands on the sheet"
    assert np.allclose(np.asarray(ref.t), np.asarray(out.t),
                       rtol=1e-4, atol=1e-5)


def test_bvh_sharded_matches_unsharded():
    """The BVH walk under shard_map on the 8-device CPU mesh (rays sharded
    over dp, scene and BVH replicated) equals the one-device walk."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    scene, v = _big_scene()
    o, d, _ = _chords(v, 8 * 128, seed=9)
    single = bvh_traverse.closest_hit(scene, scene.bvh, o, d)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("dp",))

    def shard_fn(scene, o, d):
        its = bvh_traverse.closest_hit(scene, scene.bvh, o, d)
        return its.t, its.valid, its.prim

    sharded = shard_map(shard_fn, mesh=mesh,
                        in_specs=(P(), P("dp"), P("dp")),
                        out_specs=(P("dp"), P("dp"), P("dp")),
                        check_vma=False)
    t_s, valid_s, prim_s = jax.jit(sharded)(scene, o, d)
    assert np.array_equal(np.asarray(valid_s), np.asarray(single.valid))
    assert np.array_equal(np.asarray(t_s), np.asarray(single.t))
    assert np.array_equal(np.asarray(prim_s), np.asarray(single.prim))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_closest_and_any_equals_separate(platform):
    """trace.closest_and_any (the wavefront's deferred-shadow call) equals
    the separate closest_hit + any_hit calls on every route — including
    retired rays (tmax 0), which must neither hit nor block."""
    from unittest import mock

    from mitsuba_tpu.ops import trace

    scene, v = _big_scene()
    n = 512
    o_c, d_c, radius = _chords(v, n, seed=3)
    o_s, d_s, _ = _chords(v, n, seed=5)
    tm_s = jnp.full((n,), radius * 0.9)
    # retire a quarter of each class (the wavefront's dead lanes)
    tm_c = jnp.where(jnp.arange(n) % 4 == 0, 0.0, jnp.float32(3e37))
    tm_s = jnp.where(jnp.arange(n) % 4 == 1, 0.0, tm_s)

    with mock.patch.object(trace.jax, "default_backend", lambda: platform):
        its_f, blk_f = trace.closest_and_any(
            scene, o_c, d_c, tm_c, o_s, d_s, tm_s)
        its_s = trace.closest_hit(scene, o_c, d_c, tm_c)
        blk_s = trace.any_hit(scene, o_s, d_s, tm_s)

    np.testing.assert_array_equal(np.asarray(its_f.valid),
                                  np.asarray(its_s.valid))
    np.testing.assert_array_equal(np.asarray(its_f.prim),
                                  np.asarray(its_s.prim))
    np.testing.assert_array_equal(np.asarray(its_f.t), np.asarray(its_s.t))
    np.testing.assert_array_equal(np.asarray(blk_f), np.asarray(blk_s))
    assert np.asarray(its_f.valid).any() and np.asarray(blk_f).any()
    assert not np.asarray(blk_f)[1::4].any()      # retired shadow rays
    assert not np.asarray(its_f.valid)[0::4].any()  # retired closest rays
