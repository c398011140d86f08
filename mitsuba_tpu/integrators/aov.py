"""AOV-style integrators: depth, position/normal fields, ambient occlusion.

Analogs of src/integrators/misc/{ao.cpp,field.cpp,depth.cpp}.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import warp
from ..core.rng import SampleStream, uniform
from ..ops import trace
from .common import RenderConfig

SENSOR_DIMS = 4
RAY_EPS = 1e-3


def li_depth(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    """Ray distance to first hit (misc/depth.cpp)."""
    its = trace.closest_hit(scene, o, d)
    t = jnp.where(its.valid, its.t, 0.0)
    return jnp.repeat(t[:, None], 3, axis=-1)


def li_normal(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    """Shading normal field (misc/field.cpp 'shNormal')."""
    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    return jnp.where(its.valid[:, None], si["ns"], 0.0)


def li_position(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    return jnp.where(its.valid[:, None], si["p"], 0.0)


def li_albedo(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    from ..models import bsdf as bsdflib

    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
    return jnp.where(its.valid[:, None], sp.reflectance, 0.0)


def li_ao(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    """Ambient occlusion (misc/ao.cpp): cosine-hemisphere occlusion probe.

    cfg.ao_length < 0 uses an unbounded ray (ao.cpp rayLength=-1 default:
    scene bsphere radius / 2 — we use a large constant)."""
    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    ns, ng, p = si["ns"], si["ng"], si["p"]
    u2 = jnp.stack(
        [
            uniform(stream.seed, stream.pixel, stream.sample, SENSOR_DIMS),
            uniform(stream.seed, stream.pixel, stream.sample, SENSOR_DIMS + 1),
        ],
        -1,
    )
    wo_local = warp.square_to_cosine_hemisphere(u2)
    wo = m.to_world(ns, wo_local)
    length = cfg.ao_length if cfg.ao_length > 0 else 1e6
    o2 = p + ng * jnp.where(m.dot(wo, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
    blocked = trace.any_hit(scene, o2, wo, jnp.full(p.shape[:1], length))
    vis = jnp.where(its.valid & ~blocked, 1.0, 0.0)
    return jnp.repeat(vis[:, None], 3, axis=-1)


def li_motion(scene, cam, o, d, stream, cfg):
    """Screen-space motion vectors (src/integrators/misc/motion.cpp): the
    primary hit projected at shutter open vs close; output (dx, dy, 0)
    in pixels. Camera animation only (object animation unsupported)."""
    from ..models import sensor as sensorlib

    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    p = si["p"]
    cam0 = cam.replace(to_world_end=None)
    px0, py0, v0, _ = sensorlib.world_to_raster(cam0, p)
    if cam.to_world_end is not None:
        cam1 = cam.replace(to_world=cam.to_world_end, to_world_end=None)
        px1, py1, v1, _ = sensorlib.world_to_raster(cam1, p)
    else:
        px1, py1, v1 = px0, py0, v0
    ok = its.valid & v0 & v1
    dx = jnp.where(ok, px1 - px0, 0.0)
    dy = jnp.where(ok, py1 - py0, 0.0)
    return jnp.stack([dx, dy, jnp.zeros_like(dx)], -1)
