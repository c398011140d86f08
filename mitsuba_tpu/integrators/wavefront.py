"""Regenerative wavefront path tracer — the fast primal renderer.

The fixed-depth wavefront (path.py) keeps every lane alive for max_depth
bounces even though the mean path length is far shorter (Cornell @ depth 8:
~6 useful rays per 16 traced — 2.6x waste). This renderer assigns one
pixel ("slot") to each lane and REGENERATES dead lanes in place: the moment
a path terminates (miss, depth cap, Russian roulette), its accumulated
radiance is banked and the lane immediately starts the pixel's next sample.
The wavefront stays ~fully occupied, so the effective rays/s approaches the
raw intersector rate — the same path-regeneration trick production GPU
wavefront tracers use, expressed as one lax.while_loop.

Identical estimator and sample streams as path.li (same (pixel, sample,
dim) hashing), so images match the fixed-depth renderer statistically; the
independent sampler is required (bounce dims are data-dependent here, which
QMC's static-dim patterns can't express).

Not differentiable (while_loop): use integrators/path.py for gradients.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import uniform
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import trace
from ..scene import ir as _ir
from .common import RenderConfig, mis_weight

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
RAY_EPS = 1e-3


def render(scene, cam, cfg: RenderConfig, lanes_per_pixel: int = 1,
           compact: bool = False, fuse: bool = False) -> jax.Array:
    """Full-frame render -> (H, W, 3). Jit-compatible; primal only.

    fuse=True defers each NEE shadow ray into the next step's
    trace.closest_and_any call (same estimator). Every intersection route
    decomposes that call into the two standard queries.

    compact=True (takes effect only with fuse=True and >= 4096 lanes):
    when the busy-lane count falls below successive halvings of the
    width, the live lanes are gathered into narrower continuation loops,
    so paths that run deep do not keep the full-width per-step machinery
    busy. Same estimator and sample streams (lanes carry their pixel ids;
    the film becomes a scatter-add), float film reduction order may
    differ."""
    from ..models import sensor as sensorlib

    w, h = cam.width, cam.height
    npix = w * h
    n = npix * lanes_per_pixel
    assert cfg.spp % lanes_per_pixel == 0
    spp_lane = cfg.spp // lanes_per_pixel
    families = scene.bsdf_families
    seed = jnp.uint32(cfg.seed)

    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (lanes_per_pixel,))
    lane_slot = jnp.repeat(
        jnp.arange(lanes_per_pixel, dtype=jnp.uint32), npix
    )

    def u_dim_at(pix, sample, dim):
        return uniform(seed, pix, sample, dim)

    def camera_ray_at(pix, sample):
        jx = u_dim_at(pix, sample, 0)
        jy = u_dim_at(pix, sample, 1)
        u_lens = jnp.stack([u_dim_at(pix, sample, 2),
                            u_dim_at(pix, sample, 3)], -1)
        o, d, _ = sensorlib.sample_rays(
            cam, (pix % w).astype(jnp.float32) + jx,
            (pix // w).astype(jnp.float32) + jy, u_lens)
        return o, d

    sample0 = lane_slot * jnp.uint32(spp_lane)
    o0, d0 = camera_ray_at(pixel, sample0)

    state0 = dict(
        pix=pixel,                           # lane -> pixel id (gatherable)
        o=o0, d=d0,
        sample=sample0,                      # current sample index per lane
        done=jnp.zeros((n,), jnp.uint32),    # completed samples per lane
        bounce=jnp.zeros((n,), jnp.int32),
        L_path=jnp.zeros((n, 3)),
        L_accum=jnp.zeros((n, 3)),
        beta=jnp.ones((n, 3)),
        prev_pdf=jnp.ones((n,)),
        prev_delta=jnp.ones((n,), bool),
        eta_scale=jnp.ones((n,)),
    )
    if fuse:
        # deferred NEE shadow ray from the PREVIOUS step's shade point,
        # traced together with this step's closest-hit batch
        # (trace.closest_and_any)
        state0.update(
            pend=jnp.zeros((n,), bool),
            pend_o=jnp.zeros((n, 3)),
            pend_d=jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (n, 1)),
            pend_dist=jnp.zeros((n,)),
            pend_contrib=jnp.zeros((n, 3)),
            pend_accum=jnp.zeros((n,), bool),  # resolve into L_accum
            #                                    (path completed) vs L_path
        )

    def cond(s):
        live = jnp.any(s["done"] < spp_lane)
        return live | jnp.any(s["pend"]) if fuse else live

    def step(s):
        o, d = s["o"], s["d"]
        sample, bounce = s["sample"], s["bounce"]
        lane_live = s["done"] < spp_lane
        t = bounce

        def bu(k):
            return u_dim_at(s["pix"], sample,
                            SENSOR_DIMS + t * DIMS_PER_BOUNCE + k)

        if fuse:
            # one call for this step's closest batch + last step's
            # shadow batch; retired lanes trace tmax=0 rays
            tmax_c = jnp.where(lane_live, jnp.float32(3e37), 0.0)
            its, blocked = trace.closest_and_any(
                scene, o, d, tmax_c,
                s["pend_o"], s["pend_d"],
                jnp.where(s["pend"], s["pend_dist"], 0.0),
                cfg.occupancy_shadows)
            resolved = jnp.where((s["pend"] & ~blocked)[:, None],
                                 s["pend_contrib"], 0.0)
            L_accum_in = s["L_accum"] + jnp.where(
                s["pend_accum"][:, None], resolved, 0.0)
            L_path = s["L_path"] + jnp.where(
                s["pend_accum"][:, None], 0.0, resolved)
        else:
            its = trace.closest_hit(scene, o, d)
            L_accum_in = s["L_accum"]
            L_path = s["L_path"]
        si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])

        beta = s["beta"]

        # escaped: environment
        env_le = emitterlib.env_radiance(scene, d)
        if scene.has_env:
            w_env = jnp.where(
                s["prev_delta"], 1.0,
                mis_weight(cfg.mis_mode, s["prev_pdf"],
                           emitterlib.pdf_direct_env(scene, d)),
            )
            if cfg.hide_emitters:
                w_env = jnp.where(t == 0, 0.0, w_env)
            L_path = L_path + jnp.where(
                (lane_live & ~its.valid)[:, None],
                beta * env_le * w_env[:, None], 0.0,
            )
        hit = lane_live & its.valid

        # emitted radiance
        em_id = si["emitter"]
        cos_l = m.dot(si["wi_world"], ng)
        le = scene.emitters.radiance[jnp.maximum(em_id, 0)]
        le = jnp.where(((em_id >= 0) & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_bsdf = jnp.where(s["prev_delta"], 1.0,
                           mis_weight(cfg.mis_mode, s["prev_pdf"], pdf_em))
        if cfg.hide_emitters:
            w_bsdf = jnp.where(t == 0, 0.0, w_bsdf)
        L_path = L_path + jnp.where(hit[:, None], beta * le * w_bsdf[:, None], 0.0)

        can_continue = t < (cfg.max_depth - 1)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"],
                                u_blend=bu(7), aux=si)

        # NEE — the shadow ray is NOT traced here: it is deferred into
        # the NEXT step's fused dispatch (see closest_and_any above) and
        # its contribution resolves there, into L_path if this path is
        # still running or L_accum if it completed below. Same estimator,
        # half the dispatches.
        u_nee = jnp.stack([bu(0), bu(1), bu(2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        wo_local = m.to_local(ns, ds.d)
        f_nee, pdf_b_nee = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        nee_ok = hit & can_continue & (ds.pdf > 0.0) & (jnp.max(f_nee, -1) > 0.0)
        w_nee = jnp.where(ds.is_delta, 1.0,
                          mis_weight(cfg.mis_mode, ds.pdf, pdf_b_nee))
        contrib = beta * f_nee * ds.radiance * m.safe_div(w_nee, ds.pdf)[:, None]
        if not fuse:
            blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist,
                                           cfg.occupancy_shadows)
            L_path = L_path + jnp.where((nee_ok & ~blocked)[:, None],
                                        contrib, 0.0)

        # BSDF sample + continuation decision
        wo, weight, pdf, is_delta = bsdflib.sample(
            sp, wi_local, bu(3), jnp.stack([bu(4), bu(5)], -1), families
        )
        d_new = m.to_world(ns, wo)
        eta_r = jnp.where(
            (sp.type == _ir.BSDF_DIELECTRIC)
            & (m.cos_theta(wi_local) * m.cos_theta(wo) < 0),
            jnp.where(m.cos_theta(wi_local) > 0, sp.eta[..., 0],
                      1.0 / sp.eta[..., 0]),
            1.0,
        )
        eta_scale = s["eta_scale"] * eta_r
        beta_new = beta * weight
        alive = hit & can_continue & (pdf > 0.0) & (jnp.max(beta_new, -1) > 0.0)
        q = jnp.minimum(jnp.max(beta_new, -1) * eta_scale * eta_scale, 0.95)
        q = jnp.maximum(q, 0.05)
        do_rr = t >= (cfg.rr_depth - 1)
        survive = jnp.where(do_rr, bu(6) < q, True)
        beta_new = beta_new / jnp.where(do_rr, q, 1.0)[:, None]
        alive = alive & survive

        # --- regeneration -------------------------------------------------
        died = lane_live & ~alive
        new_done = s["done"] + died.astype(jnp.uint32)
        L_accum = L_accum_in + jnp.where(died[:, None], L_path, 0.0)
        new_sample = sample + died.astype(jnp.uint32)
        o_cam, d_cam = camera_ray_at(s["pix"], new_sample)
        regen = died & (new_done < spp_lane)

        o_next = jnp.where(regen[:, None], o_cam,
                           jnp.where(alive[:, None],
                                     p + ng * jnp.where(
                                         m.dot(d_new, ng) > 0, RAY_EPS,
                                         -RAY_EPS)[:, None], o))
        d_next = jnp.where(regen[:, None], d_cam,
                           jnp.where(alive[:, None], d_new, d))
        out = dict(
            pix=s["pix"],
            o=o_next, d=d_next,
            sample=jnp.where(died, new_sample, sample),
            done=new_done,
            bounce=jnp.where(alive, bounce + 1, 0),
            L_path=jnp.where(alive[:, None], L_path, 0.0),
            L_accum=L_accum,
            beta=jnp.where(alive[:, None], beta_new, 1.0),
            prev_pdf=jnp.where(alive, pdf, 1.0),
            prev_delta=jnp.where(alive, is_delta, True),
            eta_scale=jnp.where(alive, eta_scale, 1.0),
        )
        if fuse:
            out.update(
                pend=nee_ok,
                pend_o=p,
                pend_d=ds.d,
                pend_dist=jnp.where(nee_ok, ds.dist, 0.0),
                pend_contrib=jnp.where(nee_ok[:, None], contrib, 0.0),
                # a dying path's pending NEE lands in the banked
                # accumulator
                pend_accum=died,
            )
        return out

    if compact and fuse and n >= 4 * 1024:
        # compaction ladder: run each stage while the busy count
        # exceeds the next (halved) width, then gather the busy lanes
        # (pixel ids ride in the state) into the narrower continuation
        # — the occupancy tail otherwise pays full-width per-step
        # machinery. Stages share the one step function; the film
        # becomes a scatter-add.
        def busy_of(s):
            b = s["done"] < spp_lane
            return (b | s["pend"]) if fuse else b

        widths = []
        wdt = n // 2
        while wdt >= max(1024, n // 16):
            widths.append(max(-(-wdt // 1024) * 1024, 1024))
            wdt //= 2

        film = jnp.zeros((npix, 3))
        state = state0
        for nxt in widths:
            state = jax.lax.while_loop(
                lambda s, nxt=nxt: cond(s) & (jnp.sum(busy_of(s)) > nxt),
                step, state)
            film = film.at[state["pix"]].add(state["L_accum"])
            # stable argsort: busy lanes first; the stage exit
            # guarantees busy-count <= nxt, so every busy lane fits
            idx = jnp.argsort(~busy_of(state))[:nxt]
            state = {k: v[idx] for k, v in state.items()}
            state["L_accum"] = jnp.zeros((nxt, 3))
        state = jax.lax.while_loop(cond, step, state)
        film = film.at[state["pix"]].add(state["L_accum"])
        img = film
    else:
        out = jax.lax.while_loop(cond, step, state0)
        img = out["L_accum"].reshape(lanes_per_pixel, npix, 3).sum(0)
    img = jnp.nan_to_num(img / cfg.spp, nan=0.0, posinf=0.0, neginf=0.0)
    return img.reshape(h, w, 3)


@lru_cache(maxsize=64)
def _jitted(cfg: RenderConfig, lanes_per_pixel: int, compact: bool = False):
    return jax.jit(partial(render, cfg=cfg, lanes_per_pixel=lanes_per_pixel,
                           compact=compact))


def render_jit(scene, cam, cfg: RenderConfig, lanes_per_pixel: int = 1,
               compact: bool = False):
    return _jitted(cfg, lanes_per_pixel, compact)(scene, cam)
