"""Ray-triangle intersection tests (analog of src/tests/test_kd.cpp — here
the backend is brute-force batching; BVH tests live in test_bvh.py)."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_tpu.ops import intersect, trace
from mitsuba_tpu.scene import builtin, ir


def simple_scene():
    # one unit quad at z=1 facing -z
    verts = np.asarray(
        [[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32
    )
    tris = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    return ir.build_scene(verts, tris, np.zeros(2, np.int32), [{"type": ir.BSDF_DIFFUSE}])


def test_hit_miss_and_barycentric():
    scene = simple_scene()
    o = jnp.asarray([[0.25, 0.25, 0.0], [0.75, 0.75, 0.0], [1.5, 0.5, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    its = intersect.intersect_brute(scene, o, d)
    v = np.asarray(its.valid)
    assert v.tolist() == [True, True, False]
    assert np.allclose(np.asarray(its.t)[:2], 1.0, atol=1e-5)
    # hit point recovered from barycentrics matches ray param point
    si = trace.surface_interaction(scene, o, d, its)
    p = np.asarray(si["p"])[:2]
    assert np.allclose(p[:, 2], 1.0, atol=1e-5)
    assert np.allclose(p[0, :2], [0.25, 0.25], atol=1e-5)


def test_closest_of_two():
    # two quads stacked; nearer one must win regardless of order
    verts = np.asarray(
        [[0, 0, 2], [1, 0, 2], [1, 1, 2], [0, 1, 2],
         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32
    )
    tris = np.asarray(
        [[0, 2, 1], [0, 3, 2], [4, 6, 5], [4, 7, 6]], np.int32
    )
    scene = ir.build_scene(verts, tris, np.zeros(4, np.int32), [{"type": ir.BSDF_DIFFUSE}])
    o = jnp.asarray([[0.5, 0.5, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    its = intersect.intersect_brute(scene, o, d)
    assert float(its.t[0]) == np.float32(1.0)
    assert int(its.prim[0]) in (2, 3)


def test_occlusion():
    scene = simple_scene()
    o = jnp.asarray([[0.5, 0.5, 0.0], [0.5, 0.5, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    tmax = jnp.asarray([5.0, 5.0])
    blocked = intersect.occluded_brute(scene, o, d, tmax)
    assert np.asarray(blocked).tolist() == [True, False]
    # tmax short of the quad: unoccluded
    blocked2 = intersect.occluded_brute(scene, o, d, jnp.asarray([0.5, 0.5]))
    assert np.asarray(blocked2).tolist() == [False, False]


def test_cornell_primary_hits():
    scene, cam = builtin.cornell_box(width=32, height=32)
    from mitsuba_tpu.models import sensor as sensorlib

    px = jnp.arange(32 * 32, dtype=jnp.float32) % 32 + 0.5
    py = jnp.arange(32 * 32, dtype=jnp.float32) // 32 + 0.5
    o, d, _ = sensorlib.sample_rays(cam, px, py, jnp.zeros((32 * 32, 2)))
    its = intersect.intersect_brute(scene, o, d)
    # every camera ray into the closed box must hit something
    assert bool(jnp.all(its.valid))
    t = np.asarray(its.t)
    assert t.min() > 0.5 and t.max() < 4.0


def _one_hot_rows(table, idx):
    """The one-hot product formulation of a row fetch (the reference the
    plain gather must reproduce)."""
    oh = (idx[:, None] == jnp.arange(table.shape[0])[None, :]).astype(
        table.dtype)
    return jax.lax.dot(oh, table, precision=jax.lax.Precision.HIGHEST)


def test_fetch_rows_matches_one_hot_value_and_gradient():
    from mitsuba_tpu.ops import gather

    rs = np.random.RandomState(0)
    table = jnp.asarray(rs.normal(size=(37, 5)).astype(np.float32))
    idx = jnp.asarray(rs.randint(0, 37, 300).astype(np.int32))
    w = jnp.asarray(rs.normal(size=(300, 5)).astype(np.float32))

    np.testing.assert_array_equal(np.asarray(gather.fetch_rows(table, idx)),
                                  np.asarray(_one_hot_rows(table, idx)))
    g = jax.grad(lambda t: jnp.sum(gather.fetch_rows(t, idx) * w))(table)
    g_ref = jax.grad(lambda t: jnp.sum(_one_hot_rows(t, idx) * w))(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-6)


def test_fetch_packed_splits_tables():
    from mitsuba_tpu.ops import gather

    a = jnp.arange(12.0).reshape(6, 2)
    b = jnp.arange(18.0).reshape(6, 3) + 100.0
    idx = jnp.asarray([5, 0, 3], jnp.int32)
    ra, rb = gather.fetch_packed([a, b], idx)
    np.testing.assert_array_equal(np.asarray(ra), np.asarray(a)[[5, 0, 3]])
    np.testing.assert_array_equal(np.asarray(rb), np.asarray(b)[[5, 0, 3]])
