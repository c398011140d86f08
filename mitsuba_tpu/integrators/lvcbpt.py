"""Light-vertex-cache bidirectional path tracing (LVC-BPT).

Analog of the fork's flagship integrator
(src/integrators/myBDPT/LVCBPT.cpp:30-55): a light pass traces L light
subpaths and stores EVERY vertex (including the emitter vertex itself) in
a flat cache; the eye pass connects each eye vertex to M uniformly chosen
cache vertices (connectSubpaths, LVCBPT.cpp:704-744). Unlike classic BDPT
there is no per-pixel light subpath — the cache amortizes light-path work
across all pixels, which in a wavefront means the whole cache is a dense SoA
array and connections are pure batched gathers (no divergence).

All three fork MIS modes (LVCBPT.cpp:88-96 m_MISmode) map through
cfg.mis_mode: 0=power, 1=balance (true Veach heuristics via the streaming
dvcm/dvc recurrences shared with bdpt.py — see bdptmis.py), 2=uniform
(weight 1/k over the k strategies of a k-edge path, numStrategy at
LVCBPT.cpp:553 — the fork's pdf-free heuristic; like the fork it ignores
delta lobes, exact only for non-specular scenes).

The strategy family is exactly BDPT-without-light-image — eye hit (s=0),
connect-to-z0 (s=1), inner connections (s>=2) — so the MIS weights are
the same bdptmis formulas; only the light-vertex *estimator* differs
(random cache row with V/(M·L) reweighting instead of the per-pixel
subpath sum). Light subpaths start from EVERY emitter kind via
models.emitter.sample_emitter_ray (Scene::sampleEmitterRay parity).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models.emitter import (EV_DIR, connect_emitter_vertex,
                              sample_emitter_ray, scene_bsphere)
from ..ops import trace
from . import bdptmis
from .bdpt import _cam_quantities, _mis_exp, _walk
from .common import RenderConfig

RAY_EPS = 1e-3
INV_PI = 1.0 / jnp.pi


class LightCache(NamedTuple):
    """Flat SoA vertex cache (m_LVC, LVCBPT.cpp:120): row block 0 holds
    the n_paths emitter vertices (z0), blocks 1..S the surface vertices."""

    pos: jax.Array        # (V,3)
    ns: jax.Array         # (V,3)
    ng: jax.Array         # (V,3)
    wi: jax.Array         # (V,3) toward previous vertex (z0: ray dir)
    beta: jax.Array       # (V,3) throughput (z0 rows: beta_pos)
    mat: jax.Array        # (V,) int32 material (-1 = emitter vertex)
    uv: jax.Array         # (V,2)
    depth: jax.Array      # (V,) int32 edges from the emitter (z0 = 0)
    valid: jax.Array      # (V,)
    delta: jax.Array      # (V,) vertex BSDF is delta
    dvcm: jax.Array       # (V,) MIS state at arrival (bdptmis)
    dvc: jax.Array        # (V,)
    # z0 per-kind emitter info (meaningful where mat == -1)
    ekind: jax.Array      # (V,) int32 EV_*
    eaux: jax.Array       # (V,3) spot axis / infinite-light ray dir
    ecut: jax.Array       # (V,2) spot (cos cutoff, cos beam)
    epdf_pos: jax.Array   # (V,) z0 pdf in its own measure


def build_light_cache(scene, cfg: RenderConfig, n_paths: int, b: float):
    """Light pass -> dense cache. One wavefront walk over n_paths lanes
    (the traceLightSubpath loop, LVCBPT.cpp:322), vertices kept instead of
    splatted."""
    seed = jnp.uint32(cfg.seed ^ 0x51CBA7)
    pid = jnp.arange(n_paths, dtype=jnp.uint32)
    stream = SampleStream(seed, pid, jnp.zeros((n_paths,), jnp.uint32), 0,
                          kind=0, spp=cfg.spp)
    u_sel = stream.at_dim(0)
    u_pos = jnp.stack([stream.at_dim(1), stream.at_dim(2)], -1)
    u_dir = jnp.stack([stream.at_dim(3), stream.at_dim(4)], -1)
    ers = sample_emitter_ray(scene, u_sel, u_pos, u_dir)
    st0 = bdptmis.light_start(ers, b)
    inf_light = ers.is_env | (ers.kind == EV_DIR)
    S = max(cfg.max_depth - 1, 0)
    lw = _walk(scene, scene.bsdf_families, stream, 5, ers.o, ers.d,
               ers.beta, st0, b, S, first_inf=inf_light)

    zeros = jnp.zeros((n_paths,))
    neg1 = jnp.full((n_paths,), -1, jnp.int32)
    rows = dict(
        pos=[ers.pos], ns=[ers.ng], ng=[ers.ng], wi=[ers.d],
        beta=[ers.beta_pos], mat=[neg1],
        uv=[jnp.zeros((n_paths, 2))],
        depth=[jnp.zeros((n_paths,), jnp.int32)],
        valid=[jnp.ones((n_paths,), bool)],
        delta=[jnp.zeros((n_paths,), bool)],
        dvcm=[zeros], dvc=[zeros],
        ekind=[ers.kind], eaux=[ers.aux_dir], ecut=[ers.cutoff],
        epdf_pos=[ers.pdf_pos],
    )
    for k in range(S):
        rows["pos"].append(lw["p"][k])
        rows["ns"].append(lw["ns"][k])
        rows["ng"].append(lw["ng"][k])
        rows["wi"].append(lw["wi"][k])
        rows["beta"].append(lw["beta"][k])
        rows["mat"].append(lw["mat"][k])
        rows["uv"].append(lw["uv"][k])
        rows["depth"].append(jnp.full((n_paths,), k + 1, jnp.int32))
        rows["valid"].append(lw["valid"][k])
        rows["delta"].append(lw["delta"][k])
        rows["dvcm"].append(lw["dvcm"][k])
        rows["dvc"].append(lw["dvc"][k])
        rows["ekind"].append(neg1)
        rows["eaux"].append(jnp.zeros((n_paths, 3)))
        rows["ecut"].append(jnp.zeros((n_paths, 2)))
        rows["epdf_pos"].append(zeros)
    return LightCache(**{k: jnp.concatenate(v) for k, v in rows.items()})


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig,
       n_connect: int = 4) -> jax.Array:
    """Eye pass Li over a ray batch; the cache is built per call from
    cfg.seed and shared by every ray in the batch (LVC's whole point)."""
    b = _mis_exp(cfg)
    uniform_mode = cfg.mis_mode == 2
    n = o.shape[0]
    M = n_connect
    families = scene.bsdf_families
    T = cfg.max_depth
    n_paths = getattr(cfg, "lvc_paths", None) or max(n // 4, 1024)
    cache = build_light_cache(scene, cfg, n_paths, b)
    V = cache.pos.shape[0]
    cache_scale = jnp.float32(V) / jnp.float32(M * n_paths)

    em = scene.emitters
    _, e1a, e2a = scene.tri_vertices()
    area_all = 0.5 * m.length(jnp.cross(e1a, e2a))
    pg_area, _, _ = emitterlib._group_probs(scene)
    _, r_bs = scene_bsphere(scene)
    disk_pdf = 1.0 / (jnp.pi * r_bs * r_bs)

    pdf_cam_sa, _ = _cam_quantities(cam, d)
    st0 = bdptmis.camera_start(1, pdf_cam_sa, b, light_image=False)
    eye = _walk(scene, families, stream, 4, o, d, jnp.ones((n, 3)),
                st0, b, T)
    base = 4 + 8 * T                     # connection-pick dims

    L = jnp.zeros((n, 3))

    # ---------------- eye-hit strategies (s = 0) -----------------------
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
        if uniform_mode:
            w = jnp.full((n,), 1.0 if t == 1 else 1.0 / t)
        else:
            st_i = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
            w = bdptmis.weight_hit_area(st_i, direct_a, emission, b)
        L = L + jnp.where(hit[:, None], eye["beta"][i] * le * w[:, None], 0.0)

        if scene.has_env:
            esc = eye["escaped"][i]
            d_i = eye["d_in"][i]
            le_env = emitterlib.env_radiance(scene, d_i)
            if cfg.hide_emitters and t == 1:
                le_env = jnp.zeros_like(le_env)
            if i == 0:
                w_env = jnp.ones((n,))
            elif uniform_mode:
                w_env = jnp.full((n,), 1.0 / t)
            else:
                pdf_env_sa = emitterlib.pdf_direct_env(scene, d_i)
                w_env = bdptmis.weight_hit_env(eye["st_pre"][i], pdf_env_sa,
                                               disk_pdf, b)
            L = L + jnp.where(esc[:, None],
                              eye["beta"][i] * le_env * w_env[:, None], 0.0)

    # ---------------- cache connections --------------------------------
    for t in range(1, T + 1):
        i = t - 1
        yp, yns, yng = eye["p"][i], eye["ns"][i], eye["ng"][i]
        sp_y = bsdflib.gather_shade_point(scene, eye["mat"][i], eye["uv"][i])
        wi_y = m.to_local(yns, eye["wi"][i])
        st_y = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
        for j in range(M):
            uj = stream.at_dim(base + i * M + j)
            vidx = jnp.minimum((uj * V).astype(jnp.int32), V - 1)
            lp = cache.pos[vidx]
            lns = cache.ns[vidx]
            lng = cache.ng[vidx]
            lbeta = cache.beta[vidx]
            lmat = cache.mat[vidx]
            ldepth = cache.depth[vidx]
            is_emit = lmat < 0
            ekind = cache.ekind[vidx]
            eaux = cache.eaux[vidx]
            ecut = cache.ecut[vidx]

            cdir_e, dist_e, g_e, _ = connect_emitter_vertex(
                scene, yp, ekind, lp, lns, eaux, ecut)
            to_l = lp - yp
            d2 = jnp.maximum(m.dot(to_l, to_l), 1e-12)
            dist_s = jnp.sqrt(d2)
            cdir_s = to_l * jax.lax.rsqrt(d2)[:, None]
            cdir = jnp.where(is_emit[:, None], cdir_e, cdir_s)
            dist = jnp.where(is_emit, dist_e, dist_s)

            wo_y = m.to_local(yns, cdir)
            f_y, pdf_y_sa = bsdflib.eval_pdf(sp_y, wi_y, wo_y, families)
            _, pdf_y_rev = bsdflib.eval_pdf(sp_y, wo_y, wi_y, families)

            sp_z = bsdflib.gather_shade_point(
                scene, jnp.maximum(lmat, 0), cache.uv[vidx])
            wi_z = m.to_local(lns, cache.wi[vidx])
            wo_z = m.to_local(lns, -cdir)
            f_z, pdf_z_sa = bsdflib.eval_pdf(sp_z, wi_z, wo_z, families)
            _, pdf_z_rev = bsdflib.eval_pdf(sp_z, wo_z, wi_z, families)

            if uniform_mode:
                k_edges = (t + ldepth + 1).astype(jnp.float32)
                w = 1.0 / k_edges
            else:
                w_z0 = bdptmis.weight_connect_z0(
                    st_y, ekind, lp, lns, eaux, ecut,
                    cache.epdf_pos[vidx], disk_pdf,
                    yp, yng, pdf_y_sa, pdf_y_rev, b)
                st_z = bdptmis.MisState(cache.dvcm[vidx], cache.dvc[vidx])
                w_in = bdptmis.weight_connect_inner(
                    st_y, st_z, pdf_y_sa, pdf_y_rev, pdf_z_sa, pdf_z_rev,
                    m.dot(cdir, yng), m.dot(-cdir, lng), d2, b)
                w = jnp.where(is_emit, w_z0, w_in)

            light_term = jnp.where(is_emit[:, None],
                                   g_e[:, None] * jnp.ones((n, 3)),
                                   f_z / d2[:, None])
            contrib = eye["beta"][i] * f_y * light_term * lbeta \
                * cache_scale * w[:, None]
            ok = (eye["valid"][i] & cache.valid[vidx]
                  & (t + ldepth + 1 <= T)
                  & (jnp.max(contrib, -1) > 0.0))
            blocked = trace.shadow_blocked(scene, yp, cdir, dist,
                                           cfg.occupancy_shadows)
            contrib = jnp.nan_to_num(contrib, nan=0.0, posinf=0.0,
                                     neginf=0.0)
            L = L + jnp.where((ok & ~blocked)[:, None], contrib, 0.0)

    return L
