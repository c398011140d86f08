"""Sensor-plugin parity tests: telecentric, radial-distortion
perspective, and the measurement sensors (radiance/fluence/irradiance
meters) with closed-form expectations under a constant environment."""
import jax.numpy as jnp
import numpy as np

from mitsuba_tpu.integrators import common, direct, path
from mitsuba_tpu.models import sensor as sensorlib
from mitsuba_tpu.scene import ir


def _env_scene(L=0.8):
    # one tiny black triangle far below keeps build_scene happy without
    # occluding anything the sensors look at
    verts = np.asarray([[100, -100, 100], [101, -100, 100], [100, -100, 101]],
                       np.float32)
    tris = np.asarray([[0, 1, 2]], np.int32)
    return ir.build_scene(verts, tris, np.zeros(1, np.int32),
                          [{"type": ir.BSDF_DIFFUSE}],
                          env_radiance=[L] * 3)


def _rays(cam, n=64):
    px = jnp.linspace(0.5, cam.width - 0.5, n)
    py = jnp.full((n,), cam.height / 2.0)
    u = jnp.full((n, 2), 0.5)
    return sensorlib.sample_rays(cam, px, py, u)


def test_rdist_zero_kc_matches_perspective():
    base = dict(fov_x=40, width=32, height=32)
    cam_p = sensorlib.make_camera([0, 0, -3], [0, 0, 0], **base)
    cam_r = sensorlib.make_camera([0, 0, -3], [0, 0, 0],
                                  kind=sensorlib.SENSOR_RDIST, **base)
    (o1, d1, _), (o2, d2, _) = _rays(cam_p), _rays(cam_r)
    assert np.allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)


def test_rdist_distortion_bends_edge_rays():
    base = dict(fov_x=40, width=32, height=32)
    cam_r = sensorlib.make_camera([0, 0, -3], [0, 0, 0], kc=(0.2, 0.0),
                                  kind=sensorlib.SENSOR_RDIST, **base)
    cam_p = sensorlib.make_camera([0, 0, -3], [0, 0, 0], **base)
    # exact center + edge rays
    px = jnp.asarray([16.0, 0.5])
    py = jnp.full((2,), 16.0)
    u = jnp.full((2, 2), 0.5)
    _, d_r, _ = sensorlib.sample_rays(cam_r, px, py, u)
    _, d_p, _ = sensorlib.sample_rays(cam_p, px, py, u)
    # center ray identical; edge rays bent toward the axis for kc0 > 0
    # (the stored image is barrel-distorted, so the undistorted film
    # point moves inward)
    assert np.allclose(np.asarray(d_r)[0], np.asarray(d_p)[0], atol=1e-4)
    assert float(d_r[1, 2]) > float(d_p[1, 2]) + 1e-4


def test_telecentric_zero_aperture_is_orthographic():
    cam_t = sensorlib.make_camera([0, 0, -3], [0, 0, 0], fov_x=1.5,
                                  kind=sensorlib.SENSOR_TELECENTRIC,
                                  width=16, height=16)
    cam_o = sensorlib.make_camera([0, 0, -3], [0, 0, 0], fov_x=1.5,
                                  kind=sensorlib.SENSOR_ORTHOGRAPHIC,
                                  width=16, height=16)
    (o1, d1, _), (o2, d2, _) = _rays(cam_t), _rays(cam_o)
    assert np.allclose(np.asarray(o1), np.asarray(o2), atol=1e-5)
    assert np.allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)


def test_telecentric_aperture_spreads_rays():
    cam = sensorlib.make_camera([0, 0, -3], [0, 0, 0], fov_x=1.5,
                                kind=sensorlib.SENSOR_TELECENTRIC,
                                aperture=0.3, focus_dist=2.0,
                                width=16, height=16)
    n = 128
    px = jnp.full((n,), 8.0)
    py = jnp.full((n,), 8.0)
    u = jnp.stack([jnp.linspace(0.01, 0.99, n), jnp.full((n,), 0.3)], -1)
    o, d, _ = sensorlib.sample_rays(cam, px, py, u)
    # origins spread over the lens disk
    assert float(jnp.std(o[:, 0])) > 0.01
    # camera at world z=-3 looking toward +z, focus_dist=2 -> focus plane
    # at world z=-1: all rays of this pixel converge there
    zf = -1.0
    pf = o + d * ((zf - o[:, 2]) / d[:, 2])[:, None]
    assert float(jnp.std(pf[:, 0])) < 1e-4 + 0.02 * float(jnp.std(o[:, 0]))


def test_radiancemeter_constant_env():
    L = 0.8
    scene = _env_scene(L)
    cam = sensorlib.make_camera([0, 0, 0], [0, 0, 1], width=1, height=1,
                                kind=sensorlib.SENSOR_RADIANCEMETER)
    img = np.asarray(common.render_jit(
        scene, cam, direct.li, common.RenderConfig(spp=8, max_depth=2,
                                                   seed=0)))
    assert np.allclose(img, L, atol=1e-5), img


def test_fluencemeter_constant_env():
    L = 0.8
    scene = _env_scene(L)
    cam = sensorlib.make_camera([0, 0, 0], [0, 0, 1], width=1, height=1,
                                kind=sensorlib.SENSOR_FLUENCEMETER)
    img = np.asarray(common.render_jit(
        scene, cam, direct.li, common.RenderConfig(spp=512, max_depth=2,
                                                   seed=0)))
    assert np.allclose(img, 4.0 * np.pi * L, rtol=2e-2), (
        img.mean(), 4 * np.pi * L)


def test_irradiancemeter_constant_env():
    L = 0.8
    scene = _env_scene(L)
    cam = sensorlib.make_camera([0, 0, 0], [0, 0, 1], width=1, height=1,
                                kind=sensorlib.SENSOR_IRRADIANCEMETER)
    img = np.asarray(common.render_jit(
        scene, cam, direct.li, common.RenderConfig(spp=512, max_depth=2,
                                                   seed=0)))
    assert np.allclose(img, np.pi * L, rtol=2e-2), (img.mean(), np.pi * L)


def _perspective_ref(cam_np, fov_x, w, h, px, py):
    """float64 numpy model of the pinhole camera: film point -> world ray."""
    sx = 2.0 * px / w - 1.0
    sy = 1.0 - 2.0 * py / h
    tan_half = np.tan(0.5 * np.deg2rad(fov_x))
    d_cam = np.stack([sx * tan_half, sy * tan_half * (h / w),
                      np.ones_like(sx)], -1)
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    rot = cam_np[:3, :3].astype(np.float64)
    d = d_cam @ rot.T
    o = np.broadcast_to(cam_np[:3, 3].astype(np.float64), d.shape)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_camera_rays_match_float64_reference():
    """Camera rays agree with a float64 model to 1e-6: the camera
    transform is a full-precision float32 product (a reduced-precision
    matmul mode would be off by ~1e-3)."""
    w, h = 96, 64
    cam = sensorlib.make_camera([0.3, 1.1, 4.0], [0.1, 0.9, 0.0],
                                fov_x=42.0, width=w, height=h)
    rs = np.random.RandomState(0)
    px = rs.uniform(0, w, 4096).astype(np.float32)
    py = rs.uniform(0, h, 4096).astype(np.float32)
    o, d, imp = sensorlib.sample_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                      jnp.zeros((4096, 2)))
    o_ref, d_ref = _perspective_ref(np.asarray(cam.to_world), 42.0, w, h,
                                    px.astype(np.float64),
                                    py.astype(np.float64))
    np.testing.assert_allclose(np.asarray(d), d_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(o), o_ref, rtol=0, atol=1e-6)
    assert np.all(np.asarray(imp) == 1.0)


def test_world_to_raster_inverts_camera_rays():
    """world_to_raster (light tracing's projection) maps points on camera
    rays back to their pixel coordinates."""
    w, h = 64, 48
    cam = sensorlib.make_camera([0.0, 1.0, 3.0], [0.0, 1.0, 0.0],
                                fov_x=50.0, width=w, height=h)
    rs = np.random.RandomState(1)
    px = jnp.asarray(rs.uniform(1, w - 1, 512).astype(np.float32))
    py = jnp.asarray(rs.uniform(1, h - 1, 512).astype(np.float32))
    o, d, _ = sensorlib.sample_rays(cam, px, py, jnp.zeros((512, 2)))
    qx, qy, valid, _ = sensorlib.world_to_raster(cam, o + 2.5 * d)
    assert np.asarray(valid).all()
    np.testing.assert_allclose(np.asarray(qx), np.asarray(px), atol=1e-3)
    np.testing.assert_allclose(np.asarray(qy), np.asarray(py), atol=1e-3)
