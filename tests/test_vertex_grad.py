"""Vertex-position gradients: interior term + visibility boundary term.

The north-star axis (BASELINE.json: "gradients w.r.t. ... vertex
positions"; SURVEY §7.1 "reparameterized vertex-position grads last —
the hard part: visibility discontinuities"). Validated against central
finite differences of the primal renderer with common random numbers:

  * interior: d(image)/d(receiver height) through hit-point/shading
    recomputation (ops/intersect.py surface_interaction);
  * boundary (direct shadow): a quad blocker translating across an area
    light's shadow — pure occlusion gradient, zero for pointwise AD,
    recovered by the edge-sampled boundary term (integrators/boundary.py);
  * boundary (one bounce): the same configuration at max_depth 3;
  * primal identity: li_grad's added terms are zero-primal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_tpu.integrators import boundary, common, path, reparam
from mitsuba_tpu.models import sensor as sensorlib
from mitsuba_tpu.scene import ir


def shadow_scene():
    """Floor + floating quad blocker (above the camera) + small area
    light: the image sees the blocker's shadow but not the blocker."""
    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat, rad=None):
        b = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([b, b + 1, b + 2], [b, b + 2, b + 3]):
            if rad is not None:
                tri_rad[len(tris)] = rad
            tris.append(t)
            tri_mat.append(mat)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.2, 0.2, 0.2]}
    lm = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    add_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2], 0)
    add_quad([-0.5, 0.9, -0.3], [-0.5, 0.9, 0.3],
             [-0.1, 0.9, 0.3], [-0.1, 0.9, -0.3], 1)
    add_quad([-0.1, 1.5, -0.1], [0.1, 1.5, -0.1],
             [0.1, 1.5, 0.1], [-0.1, 1.5, 0.1], 2, rad=[30.0, 30.0, 30.0])
    scene = ir.build_scene(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32), [white, dark, lm],
        tri_radiance=tri_rad)
    cam = sensorlib.make_camera(
        origin=[-0.15, 0.8, 0.0], target=[-0.15, 0.0, 0.0], up=[0, 0, 1],
        fov_x=45.0, width=24, height=24)
    return scene, cam


BLOCKER_ROWS = (4, 8)   # vertex rows of the blocker quad
FLOOR_ROWS = (0, 4)


def _mean_image(scene, cam, li_fn, cfg):
    return jnp.mean(common.render(scene, cam, li_fn, cfg))


def _fd(scene, cam, rows, axis, eps, cfg):
    """Central FD of the primal path tracer, common random numbers."""
    v = scene.vertices

    def at(theta):
        s = scene.replace(vertices=v.at[rows[0]:rows[1], axis].add(theta))
        return float(_mean_image(s, cam, path.li, cfg))

    return (at(eps) - at(-eps)) / (2 * eps)


def test_edge_table_and_adjacency():
    scene, _ = shadow_scene()
    adj = np.asarray(scene.face_adj)
    # quad diagonals: each face pair shares exactly one edge
    assert adj.shape == (6, 3)
    for f in range(0, 6, 2):
        assert (adj[f] == f + 1).sum() == 1
        assert (adj[f + 1] == f).sum() == 1
    et = np.asarray(scene.edge_table)
    # per quad: 4 open edges + 1 shared diagonal = 5 unique edges
    assert et.shape == (15, 5)
    assert ((et[:, 3] >= 0).sum()) == 3


def test_li_grad_primal_identity():
    scene, cam = shadow_scene()
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=5)
    a = np.asarray(common.render(scene, cam, path.li, cfg))
    bc = boundary.BoundaryConfig(n_edge=2, primary=True)
    b = np.asarray(common.render(
        scene, cam,
        lambda s, c, o, d, st, cf: boundary.li_grad(s, c, o, d, st, cf, bc),
        cfg))
    assert np.abs(a - b).max() < 1e-4
    # the order-1 lookahead terms are zero-primal too (the lookahead
    # radiance only scales the attached velocity factor)
    bc1 = boundary.BoundaryConfig(n_edge=2, primary=False,
                                  lookahead=1, n_la=1)
    c = np.asarray(common.render(
        scene, cam,
        lambda s, c_, o, d, st, cf: boundary.li_grad(s, c_, o, d, st, cf,
                                                     bc1),
        cfg))
    assert np.abs(a - c).max() < 1e-4


def test_reparam_primal_identity():
    scene, cam = shadow_scene()
    cfg = common.RenderConfig(spp=4, max_depth=2, seed=5)
    a = np.asarray(common.render(scene, cam, path.li, cfg))
    rp = reparam.ReparamConfig(n_aux=4)
    b = np.asarray(common.render(
        scene, cam,
        lambda s, c, o, d, st, cf: reparam.li_reparam(s, c, o, d, st, cf, rp),
        cfg))
    assert np.abs(a - b).max() < 1e-4


def test_interior_vertex_gradient():
    """Translate the floor vertically: distances/cosines to light and
    camera change smoothly — the interior term alone, via plain AD."""
    scene, cam = shadow_scene()
    cfg = common.RenderConfig(spp=64, max_depth=2, seed=9)
    fd = _fd(scene, cam, FLOOR_ROWS, 1, 0.02,
             common.RenderConfig(spp=512, max_depth=2, seed=9))

    def loss(theta):
        s = scene.replace(vertices=scene.vertices
                          .at[FLOOR_ROWS[0]:FLOOR_ROWS[1], 1].add(theta))
        return _mean_image(s, cam, path.li, cfg)

    g = float(jax.grad(loss)(0.0))
    assert np.isfinite(g) and abs(fd) > 1e-3
    assert abs(g - fd) < 0.12 * abs(fd), (g, fd)


def test_shadow_boundary_gradient_direct():
    """VERDICT r4 item 2 (direct case): d(image)/d(blocker x) is pure
    occlusion; pointwise AD gives ~0, li_grad must match FD within 5%."""
    scene, cam = shadow_scene()
    fd = _fd(scene, cam, BLOCKER_ROWS, 0, 0.025,
             common.RenderConfig(spp=768, max_depth=2, seed=7))
    assert fd < -0.2  # the shadow sweeps the frame

    # pointwise AD misses the boundary entirely
    def loss_plain(theta):
        s = scene.replace(vertices=scene.vertices
                          .at[BLOCKER_ROWS[0]:BLOCKER_ROWS[1], 0].add(theta))
        return _mean_image(s, cam, path.li,
                           common.RenderConfig(spp=16, max_depth=2, seed=7))

    g0 = float(jax.grad(loss_plain)(0.0))
    assert abs(g0) < 0.05 * abs(fd), (g0, fd)

    bc = boundary.BoundaryConfig(n_edge=8, primary=False)

    def loss(theta, seed):
        s = scene.replace(vertices=scene.vertices
                          .at[BLOCKER_ROWS[0]:BLOCKER_ROWS[1], 0].add(theta))
        cfg = common.RenderConfig(spp=64, max_depth=2, seed=seed)
        return _mean_image(
            s, cam, lambda s_, c_, o, d, st, cf:
            boundary.li_grad(s_, c_, o, d, st, cf, bc), cfg)

    g = np.mean([float(jax.grad(loss)(0.0, s)) for s in (3, 11)])
    assert abs(g - fd) < 0.05 * abs(fd), (g, fd)


def test_shadow_boundary_gradient_one_bounce():
    """VERDICT r4 item 2 (one-bounce case): same configuration at
    max_depth 3 — boundary terms at both path vertices."""
    scene, cam = shadow_scene()
    fd = _fd(scene, cam, BLOCKER_ROWS, 0, 0.025,
             common.RenderConfig(spp=768, max_depth=3, seed=7))
    bc = boundary.BoundaryConfig(n_edge=8, primary=False)

    def loss(theta, seed):
        s = scene.replace(vertices=scene.vertices
                          .at[BLOCKER_ROWS[0]:BLOCKER_ROWS[1], 0].add(theta))
        cfg = common.RenderConfig(spp=64, max_depth=3, seed=seed)
        return _mean_image(
            s, cam, lambda s_, c_, o, d, st, cf:
            boundary.li_grad(s_, c_, o, d, st, cf, bc), cfg)

    g = np.mean([float(jax.grad(loss)(0.0, s)) for s in (3, 11, 19)])
    assert abs(g - fd) < 0.05 * abs(fd), (g, fd)


def indirect_shadow_scene():
    """Floor lit ONLY by bounce light (VERDICT r4 item 3's scene): the
    area light faces UP at a white ceiling panel, so the floor sees the
    light's back face (zero emission) and is lit exclusively by the
    ceiling's REFLECTED radiance. A blocker between floor and ceiling
    casts an indirect shadow: d(image)/d(blocker x) is a visibility
    boundary whose radiance difference has NO emission component —
    emission-order boundary terms see ~0, the order-1 direct-lighting
    lookahead (BoundaryConfig.lookahead=1) recovers it."""
    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat, rad=None):
        b = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([b, b + 1, b + 2], [b, b + 2, b + 3]):
            if rad is not None:
                tri_rad[len(tris)] = rad
            tris.append(t)
            tri_mat.append(mat)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.2, 0.2, 0.2]}
    lm = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    # floor (y=0, facing up)
    add_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2], 0)
    # ceiling reflector (y=2, facing down)
    add_quad([-1.5, 2, -1.5], [1.5, 2, -1.5], [1.5, 2, 1.5],
             [-1.5, 2, 1.5], 0)
    # light quad at y=1.6 facing UP (floor sees its dark back face)
    add_quad([0.85, 1.6, -0.15], [0.85, 1.6, 0.15],
             [1.15, 1.6, 0.15], [1.15, 1.6, -0.15], 2,
             rad=[60.0, 60.0, 60.0])
    # blocker between floor and ceiling bright spot
    add_quad([0.3, 1.0, -0.3], [0.3, 1.0, 0.3],
             [0.7, 1.0, 0.3], [0.7, 1.0, -0.3], 1)
    scene = ir.build_scene(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32), [white, dark, lm],
        tri_radiance=tri_rad)
    cam = sensorlib.make_camera(
        origin=[0.15, 0.7, 0.0], target=[0.15, 0.0, 0.0], up=[0, 0, 1],
        fov_x=45.0, width=24, height=24)
    return scene, cam


IND_BLOCKER_ROWS = (12, 16)


def test_indirect_shadow_boundary_lookahead():
    """VERDICT r4 item 3: quantify the emission-order truncation on an
    indirect-dominated boundary and validate the order-1 lookahead.
    Emission-order boundary terms must miss (nearly all of) the
    gradient; lookahead=1 must match FD within 12%."""
    scene, cam = indirect_shadow_scene()
    # the scene is symmetric at theta=0 (shadow centered -> zero slope);
    # evaluate the gradient at an offset where the boundary sweep has
    # first-order signal
    theta0 = 0.08
    cfg_fd = common.RenderConfig(spp=1024, max_depth=3, seed=7)

    def primal(theta, cfg):
        s = scene.replace(vertices=scene.vertices
                          .at[IND_BLOCKER_ROWS[0]:IND_BLOCKER_ROWS[1], 0]
                          .add(theta))
        return float(_mean_image(s, cam, path.li, cfg))

    eps = 0.03
    fd = (primal(theta0 + eps, cfg_fd) - primal(theta0 - eps, cfg_fd)) \
        / (2 * eps)
    assert abs(fd) > 0.02, fd  # the indirect shadow sweeps the frame

    def loss(theta, seed, bc):
        s = scene.replace(vertices=scene.vertices
                          .at[IND_BLOCKER_ROWS[0]:IND_BLOCKER_ROWS[1], 0]
                          .add(theta))
        cfg = common.RenderConfig(spp=64, max_depth=3, seed=seed)
        return _mean_image(
            s, cam, lambda s_, c_, o, d, st, cf:
            boundary.li_grad(s_, c_, o, d, st, cf, bc), cfg)

    # emission order: the truncation measured (documented bias bound)
    bc0 = boundary.BoundaryConfig(n_edge=8, primary=False, lookahead=0)
    g0 = np.mean([float(jax.grad(loss)(theta0, s, bc0)) for s in (3, 11)])
    assert abs(g0) < 0.25 * abs(fd), (g0, fd)

    # order-1 lookahead recovers the indirect-shadow gradient
    bc1 = boundary.BoundaryConfig(n_edge=8, primary=False,
                                  lookahead=1, n_la=2)
    g1 = np.mean([float(jax.grad(loss)(theta0, s, bc1))
                  for s in (3, 11, 19)])
    assert abs(g1 - fd) < 0.12 * abs(fd), (g1, fd)


@pytest.mark.slow
def test_primary_silhouette_gradient():
    """Camera-visible blocker: the silhouette sweeps pixels directly.
    The primary boundary estimator is unbiased but high-variance (edge
    samples must land in a lane's own pixel footprint), hence the
    looser tolerance and seed averaging."""
    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat, rad=None):
        b = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([b, b + 1, b + 2], [b, b + 2, b + 3]):
            if rad is not None:
                tri_rad[len(tris)] = rad
            tris.append(t)
            tri_mat.append(mat)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.25, 0.25, 0.25]}
    lm = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    add_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2], 0)
    add_quad([-0.3, 0.5, -0.25], [-0.3, 0.5, 0.25],
             [0.1, 0.5, 0.25], [0.1, 0.5, -0.25], 1)
    add_quad([-0.15, 1.5, -0.15], [0.15, 1.5, -0.15],
             [0.15, 1.5, 0.15], [-0.15, 1.5, 0.15], 2,
             rad=[20.0, 20.0, 20.0])
    scene = ir.build_scene(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32), [white, dark, lm],
        tri_radiance=tri_rad)
    cam = sensorlib.make_camera(origin=[0.0, 1.1, 0.0],
                                target=[0.0, 0.0, 0.0], up=[0, 0, 1],
                                fov_x=50.0, width=24, height=24)
    fd = _fd(scene, cam, (4, 8), 0, 0.02,
             common.RenderConfig(spp=1024, max_depth=2, seed=7))
    bc = boundary.BoundaryConfig(n_edge=8, primary=True, n_primary=32768)

    def loss(theta, seed):
        s = scene.replace(vertices=scene.vertices.at[4:8, 0].add(theta))
        cfg = common.RenderConfig(spp=32, max_depth=2, seed=seed)
        return jnp.mean(boundary.render_grad(s, cam, cfg, bc))

    # 5 seeds: with the r5 silhouette-importance CDF on (the default),
    # this toy scene's NEE boundary estimator is unbiased but ~3x
    # higher-variance than length-uniform sampling (measured 5-seed
    # std 0.015 vs 0.004 — on 11 edges there is nothing to importance-
    # sample, the reweighting only perturbs allocation; at mesh scale
    # the CDF is what makes edge sampling tractable, see BASELINE.md r5)
    g = np.mean([float(jax.grad(loss)(0.0, s))
                 for s in (3, 11, 19, 27, 35)])
    assert abs(g - fd) < 0.15 * abs(fd), (g, fd)


@pytest.mark.slow
def test_inverse_rendering_recovers_blocker_position():
    """End-to-end use of the north-star capability: gradient-descend the
    blocker's x-translation from a wrong initialization to match a
    target image. Plain AD has zero signal here (the image depends on
    the blocker ONLY through occlusion); with the edge-sampled boundary
    terms the optimization walks the shadow into place."""
    scene, cam = shadow_scene()
    cfg = common.RenderConfig(spp=32, max_depth=2, seed=5)
    target = common.render(scene, cam, path.li,
                           common.RenderConfig(spp=256, max_depth=2,
                                               seed=13))
    bc = boundary.BoundaryConfig(n_edge=8, primary=False)

    def loss(theta, seed):
        s = scene.replace(vertices=scene.vertices
                          .at[BLOCKER_ROWS[0]:BLOCKER_ROWS[1], 0]
                          .add(theta))
        c = common.RenderConfig(spp=cfg.spp, max_depth=2, seed=seed)
        img = common.render(
            s, cam, lambda s_, c_, o, d, st, cf:
            boundary.li_grad(s_, c_, o, d, st, cf, bc), c)
        return jnp.mean((img - target) ** 2)

    gl = jax.jit(jax.value_and_grad(loss))
    theta = 0.12                     # start with the shadow well inside
    lr = 2.5                         # the frame (larger offsets leave
    for it in range(14):             # the view -> loss plateau)
        val, g = gl(theta, it + 1)
        theta = float(np.clip(theta - lr * float(g), -0.6, 0.6))
        lr *= 0.85
    # recovered to within a sixth of the initial offset (measured:
    # settles at |theta| ~ 0.03 with this schedule)
    assert abs(theta) < 0.08, theta
