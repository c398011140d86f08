"""Wavefront volumetric path tracer (homogeneous scene-global medium).

Analog of src/integrators/path/volpath_simple.cpp: per bounce,
sample a free-flight distance against the medium; lanes with a medium event
do phase-function NEE + scattering, surface lanes do the usual BSDF NEE +
sampling (path.cpp structure). Both event kinds advance in the same
wavefront iteration with masks — no divergence beyond lane predication.

NEE through the medium applies closed-form transmittance
(homogeneous.cpp evalTransmittance); MIS uses the same power heuristic as
path.py with phase pdf standing in for BSDF pdf on medium lanes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import medium as medlib
from ..models import phase as phaselib
from ..ops import trace
from ..scene import ir as _ir
from .common import RenderConfig, power_heuristic

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8      # surface dims — matches path.py exactly
RAY_EPS = 1e-3


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    med = scene.medium
    if med is None:
        from . import path as _path

        return _path.li(scene, cam, o, d, stream, cfg)

    n = o.shape[0]
    families = scene.bsdf_families

    def bounce_u(bounce, k):
        """Surface-event dims — the SAME window as path.py, so the vacuum
        limit (sigma_t -> 0) reproduces path.li bit-exactly (tested)."""
        return stream.at_dim(SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k)

    def medium_u(bounce, j):
        """Medium-event dims in a disjoint window above the surface dims."""
        return stream.at_dim(SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE
                             + bounce * 4 + j)

    is_grid = med.kind in (medlib.MEDIUM_GRID, medlib.MEDIUM_HGRID)
    TRACK = medlib.TRACK_STEPS
    track_base = SENSOR_DIMS + cfg.max_depth * (DIMS_PER_BOUNCE + 4)

    def track_u(bounce, j):
        """Tracking-walk dims (grid media): 3*TRACK per bounce — 2*TRACK
        for delta-tracking distance sampling, TRACK for NEE ratio
        tracking."""
        return stream.at_dim(track_base + bounce * 3 * TRACK + j)

    def nee(p, beta, wi_world, ns_or_none, ng_or_none, sp, t, active_mask,
            is_medium_lane):
        """Shared next-event estimation for surface + medium lanes. `p` is
        the raw event point; surface lanes offset the shadow origin along
        the geometric normal exactly like path.py does."""
        u_nee = jnp.stack([bounce_u(t, 0), bounce_u(t, 1), bounce_u(t, 2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        # scatter value + pdf toward the light
        if ns_or_none is not None:
            wo_local = m.to_local(ns_or_none, ds.d)
            wi_local = m.to_local(ns_or_none, wi_world)
            f_s, pdf_s = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        else:
            f_s = jnp.zeros((n, 3))
            pdf_s = jnp.zeros((n,))
        # phaselib's wi convention = toward the previous vertex, which is
        # exactly what nee() receives in wi_world
        ph_v, ph_pdf = phaselib.eval_pdf(med.phase, med.g, wi_world, ds.d,
                                         med.phase_params,
                                         medlib.phase_axis(med, p))
        f = jnp.where(is_medium_lane[:, None], ph_v[:, None] * jnp.ones(3), f_s)
        pdf_fwd = jnp.where(is_medium_lane, ph_pdf, pdf_s)
        # beta>0 gate: zero-throughput lanes (e.g. near-vacuum medium events
        # at astronomical t) can produce inf pdfs whose 0*inf would NaN the
        # whole sample after nan_to_num
        ok = (active_mask & (ds.pdf > 0.0) & (jnp.max(f, -1) > 0.0)
              & (jnp.max(beta, -1) > 0.0))
        # raw-origin shadow ray, t in (eps, dist*(1-eps)) — see path.py note
        blocked = trace.any_hit(scene, p, ds.d, ds.dist)
        if is_grid:
            tr = medlib.transmittance_track(
                med, lambda j: track_u(t, 2 * medlib.TRACK_STEPS + j),
                p, ds.d, jnp.minimum(ds.dist, 1e7))
        else:
            tr = medlib.transmittance(med, ds.dist)
        w = jnp.where(ds.is_delta, 1.0, power_heuristic(ds.pdf, pdf_fwd))
        contrib = beta * f * tr * ds.radiance * m.safe_div(w, ds.pdf)[:, None]
        return jnp.where((ok & ~blocked)[:, None], contrib, 0.0)

    def body(t, state):
        o, d, L, beta, active, prev_pdf, prev_delta = state

        its = trace.closest_hit(scene, o, d)
        t_surf = jnp.where(its.valid, its.t, 1e30)

        if is_grid:
            t_m, is_med, w_med, w_surf = medlib.sample_distance_grid(
                med, lambda j: track_u(t, j), o, d, t_surf)
        else:
            u_chan = medium_u(t, 0)
            u_dist = medium_u(t, 1)
            t_m, is_med, w_med, w_surf = medlib.sample_distance(
                med, u_chan, u_dist, t_surf)
        # clamp free-flight distance so p_m stays in float32 range even in
        # the near-vacuum limit (events out there carry w_med ~ 0 anyway)
        t_m = jnp.minimum(t_m, 3e7)
        medium_lane = active & is_med
        surface_lane = active & ~is_med & its.valid
        escaped = active & ~is_med & ~its.valid

        # --- escaped: env light through remaining transmittance ---------
        env_le = emitterlib.env_radiance(scene, d)
        if scene.has_env:
            w_env = jnp.where(
                prev_delta, 1.0,
                power_heuristic(prev_pdf, emitterlib.pdf_direct_env(scene, d)),
            )
            L = L + jnp.where(
                escaped[:, None], beta * w_surf * env_le * w_env[:, None], 0.0
            )

        # --- surface emission (through medium transmittance) ------------
        si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p_s = si["ns"], si["ng"], si["p"]
        em_id = si["emitter"]
        cos_l = m.dot(si["wi_world"], ng)
        le = scene.emitters.radiance[jnp.maximum(em_id, 0)]
        le = jnp.where(((em_id >= 0) & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_hit = jnp.where(prev_delta, 1.0, power_heuristic(prev_pdf, pdf_em))
        L = L + jnp.where(surface_lane[:, None], beta * w_surf * le * w_hit[:, None], 0.0)

        can_continue = t < (cfg.max_depth - 1)

        # === medium event ================================================
        p_m = o + d * t_m[:, None]
        beta_m = beta * w_med
        L = L + nee(p_m, beta_m, -d, None, None, None, t,
                    medium_lane & can_continue, jnp.ones((n,), bool))
        u2_ph = jnp.stack([medium_u(t, 2), medium_u(t, 3)], -1)
        # phaselib.sample takes wi pointing toward the previous vertex (-d);
        # the sample weight is 1 for the exactly-sampled kinds and
        # value/pdf for kkay/mixture (statically elided otherwise)
        ph_ax = medlib.phase_axis(med, p_m)
        wo_m, pdf_ph = phaselib.sample(med.phase, med.g, -d, u2_ph,
                                       med.phase_params, ph_ax)
        w_ph = phaselib.sample_weight(med.phase, med.g, -d, wo_m, pdf_ph,
                                      med.phase_params, ph_ax)
        beta_m_cont = beta_m * w_ph[:, None]

        # === surface event ===============================================
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
        wi_local = m.to_local(ns, si["wi_world"])
        beta_s = beta * w_surf
        L = L + nee(p_s, beta_s, si["wi_world"], ns, ng, sp, t,
                    surface_lane & can_continue, jnp.zeros((n,), bool))
        u_lobe = bounce_u(t, 3)
        u2_b = jnp.stack([bounce_u(t, 4), bounce_u(t, 5)], -1)
        wo_s, weight_s, pdf_b, is_delta = bsdflib.sample(sp, wi_local, u_lobe, u2_b, families)
        d_s = m.to_world(ns, wo_s)

        # === merge continuations ========================================
        new_o = jnp.where(
            medium_lane[:, None], p_m,
            p_s + ng * jnp.where(m.dot(d_s, ng) > 0, RAY_EPS, -RAY_EPS)[:, None],
        )
        new_d = jnp.where(medium_lane[:, None], wo_m, d_s)
        new_beta = jnp.where(medium_lane[:, None], beta_m_cont,
                             beta_s * weight_s)
        new_pdf = jnp.where(medium_lane, pdf_ph, pdf_b)
        new_delta = jnp.where(medium_lane, jnp.zeros((n,), bool), is_delta)

        alive = (medium_lane | surface_lane) & can_continue & (
            new_pdf > 0.0
        ) & (jnp.max(new_beta, -1) > 0.0)

        # Russian roulette
        q = jax.lax.stop_gradient(
            jnp.clip(jnp.max(new_beta, -1), 0.05, 0.95)
        )
        do_rr = t >= (cfg.rr_depth - 1)
        survive = jnp.where(do_rr, bounce_u(t, 6) < q, True)
        new_beta = new_beta / jnp.where(do_rr, q, 1.0)[:, None]
        alive = alive & survive

        return (
            jnp.where(alive[:, None], new_o, o),
            jnp.where(alive[:, None], new_d, d),
            L,
            jnp.where(alive[:, None], new_beta, 0.0),
            alive,
            jnp.where(alive, new_pdf, prev_pdf),
            jnp.where(alive, new_delta, prev_delta),
        )

    state = (
        o, d,
        jnp.zeros((n, 3)),
        jnp.ones((n, 3)),
        jnp.ones((n,), bool),
        jnp.ones((n,)),
        jnp.ones((n,), bool),
    )
    if cfg.unroll:
        for t in range(cfg.max_depth):
            state = body(t, state)
    else:
        state = jax.lax.fori_loop(0, cfg.max_depth, body, state)
    return state[2]
