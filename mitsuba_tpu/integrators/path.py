"""Wavefront MIS path tracer.

Counterpart of the reference's `path` plugin — the canonical loop
at src/integrators/path/path.cpp:119-280: intersect, add emitted radiance
(MIS-weighted against NEE), next-event estimation with power-heuristic MIS
(:176-263), BSDF sampling, Russian roulette with eta^2-scaled throughput
(:276+). Here the loop is a lax.fori_loop over bounces with the whole ray
batch live and active-lane masks instead of per-ray early exits — the SIMD
wavefront is the batched analog of the reference's SSE packets
(skdtree.cpp:241), widened from 4 lanes to the full batch.

Sampler dims: 4 are consumed by the sensor (common.py); each bounce consumes
a fixed window of 8 dims so samples are decorrelated across bounces.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..ops import trace
from ..scene import ir as _ir
from .common import RenderConfig, mis_weight

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
RAY_EPS = 1e-3


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    return _li(scene, cam, o, d, stream, cfg, with_stats=False)


def li_with_stats(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig):
    """Like li() but also returns the number of *useful* rays traced
    (active closest-hit lanes + NEE shadow rays) — the honest numerator for
    the rays/s benchmark (kdbench analog, src/utils/kdbench.cpp:35)."""
    return _li(scene, cam, o, d, stream, cfg, with_stats=True)


def _li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig,
        with_stats: bool):
    n = o.shape[0]
    families = scene.bsdf_families

    def bounce_u(bounce, k):
        dim = SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k
        return stream.at_dim(dim)

    def body(t, state):
        o, d, L, beta, active, prev_pdf, prev_delta, eta_scale, rays = state
        rays = rays + jnp.sum(active.astype(jnp.float32))

        its = trace.closest_hit(scene, o, d)
        if scene.tex_mips is not None:
            # EWA footprint gradients on the primary hit (mipmap.h:161;
            # secondary bounces keep the isotropic trilinear footprint,
            # like the reference's camera-only RayDifferential)
            ddx, ddy = sensorlib.ray_differentials(cam, d)
            primary = jnp.asarray(t == 0)
            ddx = jnp.where(primary, ddx, 0.0)
            ddy = jnp.where(primary, ddy, 0.0)
            si = trace.surface_interaction(scene, o, d, its,
                                           dd_dx=ddx, dd_dy=ddy)
        else:
            si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])

        # --- escaped rays: environment emission (path.cpp:148-163) ------
        env_le = emitterlib.env_radiance(scene, d)
        if scene.has_env:
            w_env = jnp.where(
                prev_delta, 1.0, mis_weight(cfg.mis_mode, prev_pdf, emitterlib.pdf_direct_env(scene, d))
            )
            if cfg.hide_emitters:
                w_env = jnp.where(t == 0, 0.0, w_env)
            L = L + jnp.where(
                (active & ~its.valid)[:, None], beta * env_le * w_env[:, None], 0.0
            )
        active = active & its.valid

        # --- emitted radiance at the hit (path.cpp:166-175) -------------
        em_id = si["emitter"]
        hit_emitter = em_id >= 0
        le = scene.emitters.radiance[jnp.maximum(em_id, 0)]
        cos_l = m.dot(si["wi_world"], ng)   # emitters are one-sided (front = +ng)
        le = jnp.where((hit_emitter & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_bsdf = jnp.where(prev_delta, 1.0, mis_weight(cfg.mis_mode, prev_pdf, pdf_em))
        if cfg.hide_emitters:
            w_bsdf = jnp.where(t == 0, 0.0, w_bsdf)
        L = L + jnp.where(active[:, None], beta * le * w_bsdf[:, None], 0.0)

        # Depth accounting: vertex t+1 just handled; continuing requires
        # t + 2 <= max_depth path edges.
        can_continue = t < (cfg.max_depth - 1)

        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"],
                                u_blend=bounce_u(t, 7), aux=si)

        # --- next event estimation (path.cpp:176-263) --------------------
        u_nee = jnp.stack([bounce_u(t, 0), bounce_u(t, 1), bounce_u(t, 2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        wo_local = m.to_local(ns, ds.d)
        f_nee, pdf_bsdf_nee = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        nee_possible = active & can_continue & (ds.pdf > 0.0) & (
            jnp.max(f_nee, axis=-1) > 0.0
        )
        # geometric side check against the geometric normal (strictNormals
        # analog, path.cpp:150,231)
        if cfg.strict_normals:
            same_side = (m.dot(ds.d, ng) * m.cos_theta(wo_local)) > 0.0
            nee_possible = nee_possible & same_side
        # shadow ray from the raw point with t in (eps, dist*(1-eps)) —
        # Mitsuba's Ray(p, d, Epsilon, dist*(1-ShadowEpsilon)) convention.
        # A normal-offset origin would shorten the flight and make the ray
        # hit the light quad itself inside the guard band (self-shadowing).
        blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist,
                                       cfg.occupancy_shadows)
        rays = rays + jnp.sum(nee_possible.astype(jnp.float32))
        # delta lights can't be BSDF-sampled: MIS weight 1 (emitter.h)
        w_nee = jnp.where(ds.is_delta, 1.0, mis_weight(cfg.mis_mode, ds.pdf, pdf_bsdf_nee))
        contrib = beta * f_nee * ds.radiance * m.safe_div(w_nee, ds.pdf)[:, None]
        L = L + jnp.where((nee_possible & ~blocked)[:, None], contrib, 0.0)

        # --- BSDF sampling (path.cpp:265+) --------------------------------
        u_lobe = bounce_u(t, 3)
        u2 = jnp.stack([bounce_u(t, 4), bounce_u(t, 5)], -1)
        wo, weight, pdf, is_delta = bsdflib.sample(sp, wi_local, u_lobe, u2, families)
        d_new = m.to_world(ns, wo)
        # relative IOR bookkeeping for RR (eta in weight via dielectric)
        eta_r = jnp.where(
            (sp.type == _ir.BSDF_DIELECTRIC) & (m.cos_theta(wi_local) * m.cos_theta(wo) < 0),
            jnp.where(m.cos_theta(wi_local) > 0, sp.eta[..., 0], 1.0 / sp.eta[..., 0]),
            1.0,
        )
        eta_scale = eta_scale * eta_r
        beta_new = beta * weight
        alive = (
            active
            & can_continue
            & (pdf > 0.0)
            & (jnp.max(beta_new, axis=-1) > 0.0)
        )
        off_sign = jnp.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)
        o_new = p + ng * off_sign[:, None]

        # --- Russian roulette (path.cpp:276-279) --------------------------
        q = jnp.minimum(jnp.max(beta_new, axis=-1) * eta_scale * eta_scale, 0.95)
        q = jax.lax.stop_gradient(jnp.maximum(q, 0.05))
        do_rr = t >= (cfg.rr_depth - 1)
        u_rr = bounce_u(t, 6)
        survive = jnp.where(do_rr, u_rr < q, True)
        beta_new = beta_new / jnp.where(do_rr, q, 1.0)[:, None]
        alive = alive & survive

        beta_out = jnp.where(alive[:, None], beta_new, 0.0)
        return (
            jnp.where(alive[:, None], o_new, o),
            jnp.where(alive[:, None], d_new, d),
            L,
            beta_out,
            alive,
            jnp.where(alive, pdf, prev_pdf),
            jnp.where(alive, is_delta, prev_delta),
            eta_scale,
            rays,
        )

    state = (
        o,
        d,
        jnp.zeros((n, 3)),
        jnp.ones((n, 3)),
        jnp.ones((n,), bool),
        jnp.ones((n,)),
        jnp.ones((n,), bool),  # camera rays are "delta" for MIS
        jnp.ones((n,)),
        jnp.zeros((), jnp.float32),
    )
    if cfg.unroll:
        # Static unroll: bounce index is a Python int, so QMC samplers get
        # static dimensions and XLA can specialize/fuse per bounce.
        for t in range(cfg.max_depth):
            state = body(t, state)
    else:
        state = jax.lax.fori_loop(0, cfg.max_depth, body, state)
    if with_stats:
        return state[2], state[8]
    return state[2]
