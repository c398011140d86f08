"""Adjoint particle tracer: random walks from the emitters, splatted to the
sensor.

Analog of src/integrators/ptracer (CaptureParticleWorker over
ParticleTracer, particleproc.h:128): emitter-sampled light paths carry
power; every vertex connects to the pinhole camera with a visibility ray
and splats f * G * W_e onto the film. The wavefront is a fixed-depth
unrolled walk over the whole particle batch (the analog of range work
units, range.h:35), and the film splat is a scatter-add.

Camera importance for the perspective pinhole (perspective.cpp
importance()): W(omega) = 1 / (A_film * cos^3 theta), A_film the film area
at unit distance. Contribution of vertex x to its pixel:
  beta * f_cos(x -> eye) / d^2 * W * (npix / N_particles).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import SampleStream, uniform
from ..core import warp
from ..models import bsdf as bsdflib
from ..models.emitter import sample_emitter_ray  # noqa: F401 (re-export)
from ..ops import trace
from .common import RenderConfig

RAY_EPS = 1e-3
DIMS_PER_BOUNCE = 8


def render(scene, cam, cfg: RenderConfig, n_particles: int | None = None) -> jax.Array:
    """Light-traced image, (H, W, 3). cfg.spp scales the particle count
    (spp * npix particles, matching the reference's workload per spp)."""
    from ..models import sensor as sensorlib

    w, h = cam.width, cam.height
    npix = w * h
    if n_particles is None:
        n_particles = npix * cfg.spp
    # chunk particles so the live set stays ~512k
    chunk = min(n_particles, 1 << 19)
    while n_particles % chunk:
        chunk -= 1
    nchunks = n_particles // chunk
    families = scene.bsdf_families

    eye = cam.to_world[:3, 3]
    tan_half = jnp.tan(0.5 * jnp.deg2rad(cam.fov_x))
    aspect = jnp.float32(h) / jnp.float32(w)
    film_area = 4.0 * tan_half * tan_half * aspect

    def splat_to_camera(img, p, beta_f):
        """Accumulate beta_f (= beta * f_cos already) onto the film."""
        px, py, valid, _ = sensorlib.world_to_raster(cam, p)
        to_eye = eye[None, :] - p
        d2 = jnp.maximum(m.dot(to_eye, to_eye), 1e-12)
        dir_e = to_eye / jnp.sqrt(d2)[:, None]
        # cos at the camera (forward axis = third column of rotation)
        fwd = cam.to_world[:3, 2]
        cos_cam = jnp.maximum(m.dot(-dir_e[:, :], fwd[None, :]), 1e-6)
        blocked = trace.any_hit(scene, p + dir_e * RAY_EPS, dir_e, jnp.sqrt(d2))
        weight = m.safe_div(1.0, d2 * film_area * cos_cam**3)
        contrib = beta_f * weight[:, None]
        ok = valid & ~blocked
        xi = jnp.clip(px.astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(py.astype(jnp.int32), 0, h - 1)
        contrib = jnp.where(ok[:, None], contrib, 0.0)
        return img.at[yi, xi].add(contrib), dir_e

    def run_chunk(img, ci):
        pid = jnp.arange(chunk, dtype=jnp.uint32) + ci.astype(jnp.uint32) * jnp.uint32(chunk)
        seed = jnp.uint32(cfg.seed)

        def u(dim):
            return uniform(seed, pid, jnp.uint32(0), dim)

        ers = sample_emitter_ray(
            scene, u(0), jnp.stack([u(1), u(2)], -1), jnp.stack([u(3), u(4)], -1)
        )
        o, d, beta = ers.o, ers.d, ers.beta
        # Emission vertex splat (area lights only: delta positions are
        # invisible to the camera and infinite lights have no surface —
        # the reference's handleEmission likewise only connects emitters
        # with a real surface): the camera sees radiance Le directly, so
        # the area-measure throughput is beta_pos = Le * area / sel_pdf
        # (= beta / pi) and the "f_cos" of the connection is just cos_x.
        dir_e0 = m.normalize(eye[None, :] - o)
        cos_x = jnp.maximum(m.dot(dir_e0, ers.ng), 0.0)
        img, _ = splat_to_camera(
            img, o,
            jnp.where(ers.is_area[:, None], (beta / jnp.pi) * cos_x[:, None], 0.0),
        )

        active = jnp.ones((chunk,), bool)
        state = (o, d, beta, active, img)

        def bounce(t, state):
            o, d, beta, active, img = state
            its = trace.closest_hit(scene, o, d)
            si = trace.surface_interaction(scene, o, d, its)
            active = active & its.valid
            ns, ngs, p = si["ns"], si["ng"], si["p"]
            wi_local = m.to_local(ns, si["wi_world"])
            sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])

            # connect to camera: f_cos toward the eye
            to_eye = eye[None, :] - p
            dir_e = to_eye / m.length(to_eye, keepdims=True)
            wo_local = m.to_local(ns, dir_e)
            f_cos, _ = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
            off = jnp.where(m.dot(dir_e, ngs) > 0, RAY_EPS, -RAY_EPS)
            img, _ = splat_to_camera(
                img, p + ngs * off[:, None],
                jnp.where(active[:, None], beta * f_cos, 0.0),
            )

            # continue the walk (importance transport: sample() weight is
            # f*cos/pdf which is symmetric for our reciprocal BSDFs)
            dim0 = 8 + t * DIMS_PER_BOUNCE

            def ub(k):
                return uniform(seed, pid, jnp.uint32(1), dim0 + k)

            wo, weight, pdf, _ = bsdflib.sample(
                sp, wi_local, ub(0), jnp.stack([ub(1), ub(2)], -1), families
            )
            d_new = m.to_world(ns, wo)
            beta_new = beta * weight
            alive = active & (pdf > 0.0) & (jnp.max(beta_new, -1) > 0.0)
            # Russian roulette
            q = jax.lax.stop_gradient(jnp.clip(jnp.max(beta_new, -1), 0.05, 0.95))
            do_rr = t >= (cfg.rr_depth - 1)
            survive = jnp.where(do_rr, ub(3) < q, True)
            beta_new = beta_new / jnp.where(do_rr, q, 1.0)[:, None]
            alive = alive & survive
            o_new = p + ngs * jnp.where(m.dot(d_new, ngs) > 0, RAY_EPS, -RAY_EPS)[:, None]
            return (
                jnp.where(alive[:, None], o_new, o),
                jnp.where(alive[:, None], d_new, d),
                jnp.where(alive[:, None], beta_new, 0.0),
                alive,
                img,
            )

        for t in range(cfg.max_depth - 1):
            state = bounce(t, state)
        return state[4], None

    img0 = jnp.zeros((h, w, 3), jnp.float32)
    img, _ = jax.lax.scan(run_chunk, img0, jnp.arange(nchunks))
    img = img * (jnp.float32(npix) / jnp.float32(n_particles))

    # Directly-visible ENVIRONMENT radiance: infinite lights have no
    # surface, so no particle emission vertex ever splats them (the area
    # branch above); the background is the deterministic s=0 term, added
    # with one jittered camera pass per pixel (the reference likewise
    # treats sensor-visible infinite lights outside the particle phase —
    # ptracer.cpp's sensor path). Area emitters stay with the emission
    # splat, so nothing double-counts.
    if scene.envmap is not None or getattr(scene, "has_env", False):
        from ..models import emitter as emitterlib

        bg_spp = int(min(max(cfg.spp, 1), 8))
        pid = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (bg_spp,))
        slot = jnp.repeat(jnp.arange(bg_spp, dtype=jnp.uint32), npix)
        jx = uniform(jnp.uint32(cfg.seed), pid, slot + jnp.uint32(2), 0)
        jy = uniform(jnp.uint32(cfg.seed), pid, slot + jnp.uint32(2), 1)
        px = (pid % w).astype(jnp.float32) + jx
        py = (pid // w).astype(jnp.float32) + jy
        o_c, d_c, _ = sensorlib.sample_rays(cam, px, py,
                                            jnp.zeros((npix * bg_spp, 2)))
        its = trace.closest_hit(scene, o_c, d_c)
        le = jnp.where(~its.valid[:, None],
                       emitterlib.env_radiance(scene, d_c), 0.0)
        bg = le.reshape(bg_spp, npix, 3).mean(0).reshape(h, w, 3)
        img = img + bg
    return img


def render_jit(scene, cam, cfg: RenderConfig):
    from functools import partial

    return jax.jit(partial(render, cfg=cfg))(scene, cam)
