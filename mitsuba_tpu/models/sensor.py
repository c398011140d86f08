"""Sensors: batched primary-ray generation.

Analog of Sensor::sampleRay / PerspectiveCamera
(include/mitsuba/render/sensor.h:66,393,492, src/sensors/perspective.cpp):
a sensor is a pure function (pixel coords + aperture sample) -> rays.
Implemented: perspective, thinlens (depth of field), orthographic,
spherical (lat-long panorama). All take film-plane positions in pixels.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import math as m
from ..core import warp

SENSOR_PERSPECTIVE = 0
SENSOR_THINLENS = 1
SENSOR_ORTHOGRAPHIC = 2
SENSOR_SPHERICAL = 3
SENSOR_TELECENTRIC = 4       # src/sensors/telecentric.cpp
SENSOR_RDIST = 5             # src/sensors/perspective_rdist.cpp
SENSOR_RADIANCEMETER = 6     # src/sensors/radiancemeter.cpp
SENSOR_FLUENCEMETER = 7      # src/sensors/fluencemeter.cpp
SENSOR_IRRADIANCEMETER = 8   # src/sensors/irradiancemeter.cpp


@struct.dataclass
class Camera:
    """Pinhole/thin-lens camera. `to_world` maps camera space (right-handed,
    camera looks down +z like the reference, perspective.cpp:98) to world."""

    to_world: jax.Array     # (4,4)
    fov_x: jax.Array        # scalar, degrees
    aperture: jax.Array     # scalar lens radius (thinlens.cpp)
    focus_dist: jax.Array   # scalar
    kc: jax.Array = None    # (2,) radial distortion (perspective_rdist.cpp)
    # shutter-close pose for motion blur (track.h AnimatedTransform with
    # two keyframes; matrix-lerped + re-orthonormalized). None = static.
    to_world_end: jax.Array = None
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)
    kind: int = struct.field(pytree_node=False, default=SENSOR_PERSPECTIVE)
    near: float = struct.field(pytree_node=False, default=1e-2)


def _matmul(a, b):
    """Full float32 product: a reduced-precision matmul mode (TF32) would
    shift camera rays by ~1e-3."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def look_at(origin, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix (Transform::lookAt, libcore/transform.cpp:311)."""
    origin = np.asarray(origin, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up / np.linalg.norm(up), fwd)
    right = right / np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 0] = right
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return mat


def make_camera(origin, target, up=(0, 1, 0), fov_x=39.0, width=256, height=256,
                kind=SENSOR_PERSPECTIVE, aperture=0.0, focus_dist=1.0,
                kc=(0.0, 0.0)) -> Camera:
    return Camera(
        to_world=jnp.asarray(look_at(origin, target, up)),
        fov_x=jnp.float32(fov_x),
        aperture=jnp.float32(aperture),
        focus_dist=jnp.float32(focus_dist),
        kc=jnp.asarray(kc, jnp.float32),
        width=int(width),
        height=int(height),
        kind=int(kind),
    )


def sample_rays(cam: Camera, px: jax.Array, py: jax.Array, u_lens: jax.Array):
    """Generate world-space rays through continuous pixel positions.

    px, py: (N,) continuous pixel coords in [0, W) x [0, H).
    u_lens: (N,2) aperture samples (ignored by pinhole).
    Returns (o, d): (N,3) each, plus importance weight (N,) (=1 for these
    sensor models, matching perspective.cpp:261 Spectrum(1.0f)).
    """
    n = px.shape[0]
    w = jnp.float32(cam.width)
    h = jnp.float32(cam.height)
    # NDC in [-1, 1], y flipped so pixel (0,0) is top-left like the film.
    sx = 2.0 * px / w - 1.0
    sy = 1.0 - 2.0 * py / h
    tan_half = jnp.tan(0.5 * jnp.deg2rad(cam.fov_x))
    aspect = h / w

    imp = jnp.ones((n,), jnp.float32)
    if cam.kind in (SENSOR_PERSPECTIVE, SENSOR_THINLENS, SENSOR_RDIST):
        if cam.kind == SENSOR_RDIST:
            # perspective_rdist.cpp: the stored image is distorted by
            # r' = r (1 + kc0 r^2 + kc1 r^4); invert per ray with Newton
            # iterations to find the undistorted film point
            r_d = jnp.sqrt(sx * sx + (sy * aspect) ** 2) + 1e-12
            r_u = r_d
            for _ in range(4):
                f = r_u * (1.0 + cam.kc[0] * r_u ** 2
                           + cam.kc[1] * r_u ** 4) - r_d
                fp = 1.0 + 3.0 * cam.kc[0] * r_u ** 2 + 5.0 * cam.kc[1] * r_u ** 4
                r_u = r_u - f / jnp.maximum(fp, 1e-6)
            scale = r_u / r_d
            sx = sx * scale
            sy = sy * scale
        d_cam = jnp.stack(
            [sx * tan_half, sy * tan_half * aspect, jnp.ones_like(sx)], axis=-1
        )
        o_cam = jnp.zeros((n, 3))
        if cam.kind == SENSOR_THINLENS:
            # thinlens.cpp:226: sample lens disk, refocus at focus plane
            lens = warp.square_to_uniform_disk_concentric(u_lens) * cam.aperture
            focus_p = d_cam * (cam.focus_dist / d_cam[..., 2:3])
            o_cam = jnp.concatenate([lens, jnp.zeros((n, 1))], axis=-1)
            d_cam = focus_p - o_cam
        d_cam = m.normalize(d_cam)
    elif cam.kind == SENSOR_TELECENTRIC:
        # telecentric.cpp: orthographic chief rays + per-pixel aperture
        # disk, refocused at the focus plane
        extent = cam.fov_x  # world-units half-width (like orthographic)
        film_p = jnp.stack(
            [sx * extent, sy * extent * aspect, jnp.zeros_like(sx)], -1)
        lens = warp.square_to_uniform_disk_concentric(u_lens) * cam.aperture
        o_cam = film_p + jnp.concatenate([lens, jnp.zeros((n, 1))], -1)
        focus_p = film_p + jnp.asarray([0.0, 0.0, 1.0]) * cam.focus_dist
        d_cam = m.normalize(focus_p - o_cam)
    elif cam.kind == SENSOR_RADIANCEMETER:
        # radiancemeter.cpp: one ray along the sensor axis
        o_cam = jnp.zeros((n, 3))
        d_cam = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    elif cam.kind == SENSOR_FLUENCEMETER:
        # fluencemeter.cpp: fluence = integral of L over the full sphere;
        # uniform-sphere sampling with importance 4*pi
        z = 1.0 - 2.0 * u_lens[..., 0]
        r_ = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        phi_ = 2.0 * jnp.pi * u_lens[..., 1]
        d_cam = jnp.stack([r_ * jnp.cos(phi_), r_ * jnp.sin(phi_), z], -1)
        o_cam = jnp.zeros((n, 3))
        imp = jnp.full((n,), 4.0 * jnp.pi, jnp.float32)
    elif cam.kind == SENSOR_IRRADIANCEMETER:
        # irradiancemeter.cpp: E = integral of L cos(theta) over the +z
        # hemisphere; cosine sampling cancels the cosine -> importance pi
        local = warp.square_to_cosine_hemisphere(u_lens)
        d_cam = local
        o_cam = jnp.zeros((n, 3))
        imp = jnp.full((n,), jnp.pi, jnp.float32)
    elif cam.kind == SENSOR_ORTHOGRAPHIC:
        # orthographic.cpp: parallel rays along +z; fov_x reused as film extent
        extent = cam.fov_x  # world-units half-width
        o_cam = jnp.stack([sx * extent, sy * extent * aspect, jnp.zeros_like(sx)], -1)
        d_cam = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    elif cam.kind == SENSOR_SPHERICAL:
        # spherical.cpp: lat-long panorama
        phi = (px / w) * 2.0 * jnp.pi - jnp.pi
        theta = (py / h) * jnp.pi
        st = jnp.sin(theta)
        d_cam = jnp.stack([st * jnp.sin(phi), jnp.cos(theta), st * jnp.cos(phi)], -1)
        o_cam = jnp.zeros((n, 3))
    else:
        raise ValueError(f"unknown sensor kind {cam.kind}")

    if cam.to_world_end is not None:
        # motion blur: per-ray shutter time reuses the lens sample's first
        # coordinate (pinhole sensors don't consume it; thinlens + motion
        # correlates lens/time — documented approximation of track.h's
        # independent time sampling)
        tt = u_lens[..., 0][:, None, None]
        m01 = cam.to_world[None, :3, :4] * (1.0 - tt) \
            + cam.to_world_end[None, :3, :4] * tt
        # re-orthonormalize the lerped rotation (Gram-Schmidt; track.h
        # slerps quaternions — equivalent for small shutter rotations)
        r0 = m.normalize(m01[:, :, 0])
        r1 = m.normalize(m01[:, :, 1] - r0 * m.dot(m01[:, :, 1], r0,
                                                   keepdims=True))
        r2 = jnp.cross(r0, r1)
        # camera -> world with the per-ray frame (columns r0, r1, r2),
        # as explicit float32 sums
        def to_world(v):
            return v[:, 0:1] * r0 + v[:, 1:2] * r1 + v[:, 2:3] * r2

        o = to_world(o_cam) + m01[:, :, 3]
        d = m.normalize(to_world(d_cam))
        return o, d, imp
    rot = cam.to_world[:3, :3]
    o = _matmul(o_cam, rot.T) + cam.to_world[:3, 3]
    d = m.normalize(_matmul(d_cam, rot.T))
    return o, d, imp


def world_to_raster(cam: Camera, p: jax.Array):
    """Project world points to pixel coords (for ptracer/light tracing;
    analog of PerspectiveCamera::getSampleDirection). Returns (px, py, valid,
    importance) — importance is the W_e factor for particle tracing."""
    rot = cam.to_world[:3, :3]
    trans = cam.to_world[:3, 3]
    p_cam = _matmul(p - trans, rot)  # rot is orthonormal: inverse = transpose
    z = p_cam[..., 2]
    valid = z > cam.near
    zs = jnp.where(valid, z, 1.0)
    tan_half = jnp.tan(0.5 * jnp.deg2rad(cam.fov_x))
    aspect = jnp.float32(cam.height) / jnp.float32(cam.width)
    sx = p_cam[..., 0] / (zs * tan_half)
    sy = p_cam[..., 1] / (zs * tan_half * aspect)
    px = (sx + 1.0) * 0.5 * cam.width
    py = (1.0 - sy) * 0.5 * cam.height
    valid &= (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
    # importance W_e = 1 / (A_film * cos^3 theta) in solid-angle measure
    d = m.normalize(p_cam)
    cos_t = d[..., 2]
    film_area = 4.0 * tan_half * tan_half * aspect
    imp = m.safe_div(1.0, film_area * jnp.maximum(cos_t, 1e-6) ** 4)
    return px, py, valid, imp


def ray_differentials(cam: Camera, d: jax.Array):
    """+1-pixel ray-direction deltas for the projective sensor family.

    The RayDifferential analog (reference perspective.cpp ray
    differentials / mipmap.h:161 EWA driver): given the normalized world
    direction of a camera ray, return (dd_dx, dd_dy) — the change of that
    direction for one-pixel raster steps. Derived analytically from the
    camera model (pinhole; the thinlens central ray uses the same
    geometry). Non-projective sensors return zeros, which downstream
    texture filtering treats as "no anisotropic footprint"."""
    n = d.shape[0]
    if cam.kind not in (SENSOR_PERSPECTIVE, SENSOR_THINLENS, SENSOR_RDIST):
        z = jnp.zeros((n, 3))
        return z, z
    w = jnp.float32(cam.width)
    h = jnp.float32(cam.height)
    tan_half = jnp.tan(0.5 * jnp.deg2rad(cam.fov_x))
    aspect = h / w
    rot = cam.to_world[:3, :3]
    # unnormalized camera-space direction, rescaled to the z=1 plane
    d_cam = _matmul(d, rot)               # R^T d (columns orthonormal)
    v = d_cam / jnp.maximum(d_cam[..., 2:3], 1e-8)
    dv_dx = jnp.asarray([2.0 * 1.0 / w, 0.0, 0.0]) * tan_half
    dv_dy = jnp.asarray([0.0, -2.0 * 1.0 / h * aspect, 0.0]) * tan_half

    def dnorm(vv, dvv):
        # d(normalize(v)) = (I - n n^T) dv / |v|
        inv_len = jax.lax.rsqrt(jnp.maximum(m.dot(vv, vv), 1e-12))
        nrm = vv * inv_len[:, None]
        dvv = jnp.broadcast_to(dvv, vv.shape)
        return (dvv - nrm * m.dot(nrm, dvv)[:, None]) * inv_len[:, None]

    ddx_cam = dnorm(v, dv_dx)
    ddy_cam = dnorm(v, dv_dy)
    return _matmul(ddx_cam, rot.T), _matmul(ddy_cam, rot.T)
