"""Bidirectional path tracing with per-pixel light subpaths, full-emitter
light-path starts, Veach MIS over every (s,t) strategy, and the t=1
light-tracing image.

Analog of src/integrators/bdpt (strategy enumeration
bdpt_proc.cpp:163; light image composited at bdpt_proc.cpp:283,347-352;
libbidir PathVertex walks vertex.h:272). Both subpaths are dense
(N, depth, ...) wavefront arrays built in one unrolled walk; every (s,t)
pair is a static loop iteration, so the whole strategy family evaluates
without divergence. MIS uses the streaming recursive quantities in
bdptmis.py instead of the reference's cached per-vertex pdf re-walks.

Light subpaths start from EVERY emitter kind (area/env/point/spot/
directional) via models.emitter.sample_emitter_ray — the parity point of
Scene::sampleEmitterRay (scene.h:886).

`li` is the standard per-ray integrator (no light image — camera-splat
strategies excluded from the MIS sums, so weights still sum to 1 over the
used set). `render` is the full driver with the light image: t=1
strategies splat through the camera like ptracer and all weights include
them (bdpt_proc.cpp:163 minT=1 iff lightImage).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models.emitter import (EV_AREA, EV_DIR, EV_ENV,
                              connect_emitter_vertex, sample_emitter_ray,
                              scene_bsphere)
from ..ops import trace
from . import bdptmis
from .common import RenderConfig

RAY_EPS = 1e-3
INV_PI = 1.0 / jnp.pi


def _mis_exp(cfg) -> float:
    # cfg.mis_mode: 0=power, 1=balance (2=uniform falls back to balance
    # here; the fork's Uniform mode lives in lvcbpt where it's the point)
    return 2.0 if cfg.mis_mode == 0 else 1.0


def _walk(scene, families, stream, dim0, o, d, beta0, st0, b,
          depth, first_inf=None):
    """Unrolled random walk storing per-depth vertex data + MIS state at
    arrival (post on-hit, pre-scatter)."""
    n = o.shape[0]
    v = {k: [] for k in ("p", "ns", "ng", "wi", "beta", "valid", "delta",
                         "mat", "uv", "em", "prim", "dvcm", "dvc",
                         "st_pre", "d_in", "escaped")}
    beta = beta0
    active = jnp.ones((n,), bool)
    st = st0
    prev_p = o
    for i in range(depth):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        v["st_pre"].append(st)          # pre-hit state (env escape weight)
        v["d_in"].append(d)
        v["escaped"].append(active & ~its.valid)
        active_new = active & its.valid
        ns, ng, p = si["ns"], si["ng"], si["p"]
        dvec = p - prev_p
        dist2 = jnp.maximum(m.dot(dvec, dvec), 1e-12)
        cos_in = m.dot(d, ng)
        skip = first_inf if i == 0 else None
        st_here = bdptmis.on_hit(st, dist2, cos_in, b, skip_dist2=skip)

        v["p"].append(p)
        v["ns"].append(ns)
        v["ng"].append(ng)
        v["wi"].append(si["wi_world"])
        v["beta"].append(beta)
        v["valid"].append(active_new)
        v["mat"].append(si["mat"])
        v["uv"].append(si["uv"])
        v["em"].append(si["emitter"])
        v["prim"].append(its.prim)
        v["dvcm"].append(st_here.dvcm)
        v["dvc"].append(st_here.dvc)
        active = active_new

        spt = bsdflib.gather_shade_point(
            scene, si["mat"], si["uv"],
            u_blend=stream.at_dim(dim0 + 8 * i + 7))
        wi_local = m.to_local(ns, si["wi_world"])
        wo, wgt, pdf, is_delta = bsdflib.sample(
            spt, wi_local,
            stream.at_dim(dim0 + 8 * i + 3),
            jnp.stack([stream.at_dim(dim0 + 8 * i + 4),
                       stream.at_dim(dim0 + 8 * i + 5)], -1),
            families,
        )
        v["delta"].append(is_delta)
        d_new = m.to_world(ns, wo)
        _, pdf_rev_sa = bsdflib.eval_pdf(spt, wo, wi_local, families)
        st = bdptmis.scatter(st_here, pdf, pdf_rev_sa,
                             m.cos_theta(wo), is_delta, b)

        beta = beta * wgt
        active = active & (pdf > 0) & (jnp.max(beta, -1) > 0)
        prev_p = p
        o = p + ng * jnp.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
        d = d_new
    return v


def _cam_quantities(cam, d):
    fwd_axis = cam.to_world[:3, 2]
    cos_cam = jnp.maximum(m.dot(d, fwd_axis[None, :]), 1e-6)
    tan_half = jnp.tan(0.5 * jnp.deg2rad(cam.fov_x))
    aspect = jnp.float32(cam.height) / jnp.float32(cam.width)
    film_area = 4.0 * tan_half * tan_half * aspect
    pdf_cam_sa = m.safe_div(1.0, film_area * cos_cam ** 3)
    return pdf_cam_sa, film_area


def _li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig,
        light_image: bool, splat_img=None):
    """Shared body. Returns (L, splat_img) — splat_img untouched (None)
    unless light_image."""
    b = _mis_exp(cfg)
    n = o.shape[0]
    families = scene.bsdf_families
    max_edges = cfg.max_depth
    T = max_edges
    S = max(max_edges - 1, 0)
    nlp = cam.width * cam.height       # light subpaths per sample slot

    em = scene.emitters
    p0a, e1a, e2a = scene.tri_vertices()
    area_all = 0.5 * m.length(jnp.cross(e1a, e2a))
    pg_area, env_p, _ = emitterlib._group_probs(scene)
    _, r_bs = scene_bsphere(scene)
    disk_pdf = 1.0 / (jnp.pi * r_bs * r_bs)
    eye_pos = cam.to_world[:3, 3]

    # --- eye subpath ----------------------------------------------------
    pdf_cam_sa, film_area = _cam_quantities(cam, d)
    st_cam0 = bdptmis.camera_start(nlp, pdf_cam_sa, b, light_image)
    eye = _walk(scene, families, stream, 4, o, d, jnp.ones((n, 3)),
                st_cam0, b, T)

    # --- light subpath --------------------------------------------------
    base = 4 + 8 * T
    u_sel = stream.at_dim(base)
    u_pos = jnp.stack([stream.at_dim(base + 1), stream.at_dim(base + 2)], -1)
    u_dir = jnp.stack([stream.at_dim(base + 3), stream.at_dim(base + 4)], -1)
    ers = sample_emitter_ray(scene, u_sel, u_pos, u_dir)
    st_l0 = bdptmis.light_start(ers, b)
    inf_light = ers.is_env | (ers.kind == EV_DIR)
    light = _walk(scene, families, stream, base + 5, ers.o, ers.d, ers.beta,
                  st_l0, b, S, first_inf=inf_light)

    L = jnp.zeros((n, 3))

    def splat(img, p, contrib, active):
        """Accumulate `contrib` (pre-multiplied with everything except the
        camera importance) through the pinhole onto the film."""
        from ..models import sensor as sensorlib

        px, py, valid, _ = sensorlib.world_to_raster(cam, p)
        to_eye = eye_pos[None, :] - p
        d2 = jnp.maximum(m.dot(to_eye, to_eye), 1e-12)
        dir_e = to_eye * jax.lax.rsqrt(d2)[:, None]
        fwd = cam.to_world[:3, 2]
        cos_cam = jnp.maximum(m.dot(-dir_e, fwd[None, :]), 1e-6)
        # raw origin: any_hit clips to (SHADOW_EPS, t*(1-SHADOW_EPS));
        # offsetting the origin re-introduces light-quad self-shadowing
        blocked = trace.shadow_blocked(scene, p, dir_e,
                                       jnp.sqrt(d2), cfg.occupancy_shadows)
        w_e = m.safe_div(1.0, d2 * film_area * cos_cam ** 3)
        c = contrib * w_e[:, None]
        ok = valid & ~blocked & active
        xi = jnp.clip(px.astype(jnp.int32), 0, cam.width - 1)
        yi = jnp.clip(py.astype(jnp.int32), 0, cam.height - 1)
        c = jnp.nan_to_num(jnp.where(ok[:, None], c, 0.0),
                           nan=0.0, posinf=0.0, neginf=0.0)
        return img.at[yi, xi].add(c), (dir_e, d2, cos_cam)

    # ================= s = 0: eye path hits an emitter ==================
    for t in range(1, T + 1):
        i = t - 1
        em_id = eye["em"][i]
        cos_l = m.dot(eye["wi"][i], eye["ng"][i])
        hit = eye["valid"][i] & (em_id >= 0) & (cos_l > 0.0)
        le = em.radiance[jnp.maximum(em_id, 0)]
        prim = eye["prim"][i]
        direct_a = m.safe_div(em.select_pdf_full[jnp.maximum(prim, 0)]
                              * pg_area, area_all[jnp.maximum(prim, 0)])
        emission = direct_a * jnp.maximum(cos_l, 0.0) * INV_PI
        st_i = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
        w = bdptmis.weight_hit_area(st_i, direct_a, emission, b)
        L = L + jnp.where(hit[:, None],
                          eye["beta"][i] * le * w[:, None], 0.0)

        # escaped rays see the environment (pre-hit state: SA measure)
        if scene.has_env:
            esc = eye["escaped"][i]
            d_i = eye["d_in"][i]
            le_env = emitterlib.env_radiance(scene, d_i)
            if cfg.hide_emitters and t == 1:
                le_env = jnp.zeros_like(le_env)
            pdf_env_sa = emitterlib.pdf_direct_env(scene, d_i)
            if i == 0:
                # 1-edge path camera->env: the only strategy (no surface
                # vertex to splat even with the light image on)
                w_env = jnp.ones((n,))
            else:
                w_env = bdptmis.weight_hit_env(eye["st_pre"][i], pdf_env_sa,
                                               disk_pdf, b)
            L = L + jnp.where(esc[:, None],
                              eye["beta"][i] * le_env * w_env[:, None], 0.0)

    # ================= s = 1: connect eye vertices to z0 ================
    for t in range(1, T + 1):
        if 1 + t > max_edges:
            continue
        i = t - 1
        yp, yns, yng = eye["p"][i], eye["ns"][i], eye["ng"][i]
        cdir, dist, g, _finite = connect_emitter_vertex(
            scene, yp, ers.kind, ers.pos, ers.ng, ers.aux_dir, ers.cutoff)
        sp_y = bsdflib.gather_shade_point(scene, eye["mat"][i], eye["uv"][i])
        wi_y = m.to_local(yns, eye["wi"][i])
        wo_y = m.to_local(yns, cdir)
        f_y, pdf_y_sa = bsdflib.eval_pdf(sp_y, wi_y, wo_y, families)
        _, pdf_y_rev = bsdflib.eval_pdf(sp_y, wo_y, wi_y, families)
        st_y = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
        w = bdptmis.weight_connect_z0(
            st_y, ers.kind, ers.pos, ers.ng, ers.aux_dir, ers.cutoff,
            ers.pdf_pos, disk_pdf, yp, yng, pdf_y_sa, pdf_y_rev, b)
        contrib = eye["beta"][i] * f_y * g[:, None] * ers.beta_pos
        ok = eye["valid"][i] & (jnp.max(contrib, -1) > 0.0)
        blocked = trace.shadow_blocked(scene, yp, cdir, dist,
                                       cfg.occupancy_shadows)
        L = L + jnp.where((ok & ~blocked)[:, None],
                          contrib * w[:, None], 0.0)

    # ============ inner connections: s >= 2, t >= 1 ====================
    for s in range(2, S + 2):
        k = s - 2                      # light[] surface index of junction
        for t in range(1, T + 1):
            if s + t > max_edges:
                continue
            i = t - 1
            zp, zns, zng = light["p"][k], light["ns"][k], light["ng"][k]
            zbeta = light["beta"][k]
            zvalid = light["valid"][k]

            yp, yns, yng = eye["p"][i], eye["ns"][i], eye["ng"][i]
            to_z = zp - yp
            d2 = jnp.maximum(m.dot(to_z, to_z), 1e-12)
            dist = jnp.sqrt(d2)
            cdir = to_z * jax.lax.rsqrt(d2)[:, None]

            sp_y = bsdflib.gather_shade_point(scene, eye["mat"][i],
                                              eye["uv"][i])
            wi_y = m.to_local(yns, eye["wi"][i])
            wo_y = m.to_local(yns, cdir)
            f_y, pdf_y_sa = bsdflib.eval_pdf(sp_y, wi_y, wo_y, families)
            _, pdf_y_rev = bsdflib.eval_pdf(sp_y, wo_y, wi_y, families)

            sp_z = bsdflib.gather_shade_point(scene, light["mat"][k],
                                              light["uv"][k])
            wi_z = m.to_local(zns, light["wi"][k])
            wo_z = m.to_local(zns, -cdir)
            f_z, pdf_z_sa = bsdflib.eval_pdf(sp_z, wi_z, wo_z, families)
            _, pdf_z_rev = bsdflib.eval_pdf(sp_z, wo_z, wi_z, families)

            st_y = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
            st_z = bdptmis.MisState(light["dvcm"][k], light["dvc"][k])
            w = bdptmis.weight_connect_inner(
                st_y, st_z, pdf_y_sa, pdf_y_rev, pdf_z_sa, pdf_z_rev,
                m.dot(cdir, yng), m.dot(-cdir, zng), d2, b)

            contrib = eye["beta"][i] * f_y * f_z * zbeta / d2[:, None]
            ok = (eye["valid"][i] & zvalid & (jnp.max(contrib, -1) > 0.0))
            blocked = trace.shadow_blocked(scene, yp, cdir, dist,
                                           cfg.occupancy_shadows)
            L = L + jnp.where((ok & ~blocked)[:, None],
                              contrib * w[:, None], 0.0)

    # ================= t = 1: light image splats ========================
    if light_image:
        # (s=1, t=1): the emitter vertex itself (area lights only —
        # delta positions are invisible, infinite lights have no surface)
        to_eye0 = eye_pos[None, :] - ers.pos
        d2_0 = jnp.maximum(m.dot(to_eye0, to_eye0), 1e-12)
        dir_e0 = to_eye0 * jax.lax.rsqrt(d2_0)[:, None]
        cos_x = jnp.maximum(m.dot(dir_e0, ers.ng), 0.0)
        fwd = cam.to_world[:3, 2]
        cos_cam0 = jnp.maximum(m.dot(-dir_e0, fwd[None, :]), 1e-6)
        pdf_cam_a0 = m.safe_div(cos_x, d2_0 * film_area * cos_cam0 ** 3)
        w0 = bdptmis.weight_splat_z0(ers.pdf_pos, pdf_cam_a0, nlp,
                                     ers.is_area, b)
        splat_img, _ = splat(
            splat_img, ers.pos,
            jnp.where(ers.is_area[:, None],
                      ers.beta_pos * (cos_x * w0)[:, None], 0.0),
            jnp.ones((n,), bool))

        # (s>=2, t=1): every light surface vertex
        for k in range(S):
            s_verts = k + 2            # light vertices incl z0
            if s_verts > max_edges:
                continue
            zp, zns, zng = light["p"][k], light["ns"][k], light["ng"][k]
            to_eye = eye_pos[None, :] - zp
            d2 = jnp.maximum(m.dot(to_eye, to_eye), 1e-12)
            dir_e = to_eye * jax.lax.rsqrt(d2)[:, None]
            sp_z = bsdflib.gather_shade_point(scene, light["mat"][k],
                                              light["uv"][k])
            wi_z = m.to_local(zns, light["wi"][k])
            wo_z = m.to_local(zns, dir_e)
            f_z, _ = bsdflib.eval_pdf(sp_z, wi_z, wo_z, families)
            _, pdf_z_rev = bsdflib.eval_pdf(sp_z, wo_z, wi_z, families)
            cos_cam = jnp.maximum(m.dot(-dir_e, fwd[None, :]), 1e-6)
            cos_v = jnp.abs(m.dot(dir_e, zng))
            pdf_cam_a = m.safe_div(cos_v, d2 * film_area * cos_cam ** 3)
            st_z = bdptmis.MisState(light["dvcm"][k], light["dvc"][k])
            w = bdptmis.weight_splat(st_z, pdf_cam_a, nlp, pdf_z_rev, b)
            splat_img, _ = splat(
                splat_img, zp,
                light["beta"][k] * f_z * w[:, None], light["valid"][k])

    return L, splat_img


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> jax.Array:
    """Standard per-ray BDPT (no light image; weights sum to 1 over the
    connection/hit strategies)."""
    L, _ = _li(scene, cam, o, d, stream, cfg, light_image=False)
    return L


def render(scene, cam, cfg: RenderConfig) -> jax.Array:
    """Full BDPT with the light image (bdpt_proc.cpp:347-352 composite):
    eye strategies accumulate per-pixel, t=1 strategies splat; both are
    normalized by spp (nlp light paths = npix per sample slot)."""
    from ..core.rng import SampleStream

    w, h = cam.width, cam.height
    chunk = cfg.resolve_chunk(w, h)
    nchunks = cfg.spp // chunk
    pixel_ids = jnp.arange(w * h, dtype=jnp.uint32)
    pixel_ids = jnp.repeat(pixel_ids, chunk)
    sample_slot = jnp.tile(jnp.arange(chunk, dtype=jnp.uint32), (w * h,))
    px_base = (pixel_ids % w).astype(jnp.float32)
    py_base = (pixel_ids // w).astype(jnp.float32)

    from ..models import sensor as sensorlib

    def render_chunk(img, ci):
        sample_ids = sample_slot + ci.astype(jnp.uint32) * jnp.uint32(chunk)
        stream = SampleStream(jnp.uint32(cfg.seed), pixel_ids, sample_ids, 0,
                              kind=cfg.sampler, spp=cfg.spp)
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        o, d, imp = sensorlib.sample_rays(cam, px_base + jx, py_base + jy,
                                          u_lens)
        splat0 = jnp.zeros((h, w, 3), jnp.float32)
        L, splat_img = _li(scene, cam, o, d, stream, cfg,
                           light_image=True, splat_img=splat0)
        L = jnp.nan_to_num(L * imp[:, None], nan=0.0, posinf=0.0, neginf=0.0)
        img = img + jnp.sum(L.reshape(h, w, chunk, 3), axis=2)
        img = img + splat_img
        return img, None

    img0 = jnp.zeros((h, w, 3), jnp.float32)
    img, _ = jax.lax.scan(render_chunk, img0, jnp.arange(nchunks))
    return img / jnp.float32(cfg.spp)


def render_jit(scene, cam, cfg: RenderConfig):
    from functools import partial

    return jax.jit(partial(render, cfg=cfg))(scene, cam)
