"""Emitter sampling: area lights (emissive triangles) + constant environment.

Analog of Scene::sampleEmitterDirect / pdfEmitterDirect
(include/mitsuba/render/scene.h:482-886) and the area emitter plugin
(src/emitters/area.cpp): NEE draws an emissive triangle from a luminance-
weighted CDF, a uniform point on it, and converts the area pdf to solid
angle. Everything is batched; the "which emitter" choice is a searchsorted
over the CDF (one gather, no divergence).

Sampled quantities stay consistent with in-trace vertex positions so values
remain correct if vertices are perturbed (pdfs recomputed from live
geometry, only the *selection probabilities* are host-precomputed).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import warp


class DirectSample(NamedTuple):
    """Result of sampling a direction toward an emitter from `ref_p`
    (analog of DirectSamplingRecord, emitter.h:190-278)."""

    d: jax.Array          # (N,3) unit direction ref -> light
    dist: jax.Array       # (N,)
    radiance: jax.Array   # (N,3) emitted radiance toward ref (delta lights
    #                       fold I/d^2 etc. in here)
    pdf: jax.Array        # (N,) solid-angle pdf x selection prob (0=invalid)
    is_env: jax.Array     # (N,) bool
    is_delta: jax.Array   # (N,) bool — MIS weight must be 1 (point/spot/
    #                       directional can't be BSDF-sampled, emitter.h)
    n_l: jax.Array = None  # (N,3) light-surface normal at the sampled
    #                       point (area lights; zeros for env/delta) —
    #                       consumers: subsurface exact refracted NEE


# Probability of choosing the environment vs area lights when both exist.
# The reference importance-samples emitters by power (scene.cpp:131); a
# fixed split keeps the pdf simple and is harmless with MIS.
ENV_SELECT_P = 0.5


def _group_probs(scene):
    """Static selection probabilities of the (area, env, delta) groups.

    If the scene carries precomputed power-weighted probabilities (the
    analog of Scene's m_emitterPDF built from emitter power, scene.cpp:131
    via compute_group_probs below), use those; otherwise present groups
    split uniformly (exact pdf either way; MIS keeps any split unbiased)."""
    gp = getattr(scene, "group_probs", ())
    if gp:
        return gp
    has_delta = scene.delta_emitters is not None
    groups = int(scene.has_area) + int(scene.has_env) + int(has_delta)
    p = 1.0 / max(groups, 1)
    return (p if scene.has_area else 0.0,
            p if scene.has_env else 0.0,
            p if has_delta else 0.0)


_LUM = (0.2126, 0.7152, 0.0722)


def compute_group_probs(scene):
    """Host-side power-weighted (area, env, delta) selection probabilities
    (the analog of the reference's per-emitter power distribution,
    scene.cpp:131 m_emitterPDF). Returns scene with group_probs set.

    Call once at scene-build time with concrete arrays (not under jit)."""
    import numpy as np

    lum = np.asarray(_LUM, np.float32)
    p_area = p_env = p_delta = 0.0
    if scene.has_area:
        em = scene.emitters
        v = np.asarray(scene.vertices)
        i = np.asarray(scene.indices)
        tri = np.asarray(em.tri_index)
        p0 = v[i[tri, 0]]
        e1 = v[i[tri, 1]] - p0
        e2 = v[i[tri, 2]] - p0
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        rad = np.asarray(em.radiance)[np.asarray(em.tri_emitter)]
        p_area = float(np.sum(areas * (rad @ lum)) * np.pi)
    c, r = (np.asarray(x) for x in scene_bsphere(scene))
    disk = float(np.pi * r * r)
    if scene.has_env:
        if scene.envmap is not None:
            img = np.asarray(scene.envmap.image)
            mean_l = (float((img.reshape(-1, 3) @ lum).mean())
                      * float(np.asarray(scene.envmap.scale)))
        else:
            mean_l = float(np.asarray(scene.env_radiance) @ lum)
        p_env = mean_l * 4.0 * np.pi * disk
    if scene.delta_emitters is not None:
        de = scene.delta_emitters
        kind = np.asarray(de.kind)
        inten = np.asarray(de.intensity) @ lum
        cut = np.asarray(de.cutoff)
        from ..scene import ir as _ir

        solid = np.where(
            kind == _ir.DELTA_SPOT, 2.0 * np.pi * (1.0 - cut[:, 0]),
            np.where(kind == _ir.DELTA_DIRECTIONAL, disk,
                     np.where(kind == _ir.DELTA_COLLIMATED, 1.0,
                              4.0 * np.pi)),
        )
        p_delta = float(np.sum(inten * solid))
    total = p_area + p_env + p_delta
    if total <= 0.0:
        return scene
    probs = (p_area / total, p_env / total, p_delta / total)
    # guard against starving a present group of samples entirely
    floor = 0.05
    probs = tuple(
        (max(p, floor) if present else 0.0)
        for p, present in zip(probs, (scene.has_area, scene.has_env,
                                      scene.delta_emitters is not None))
    )
    s = sum(probs)
    return scene.replace(group_probs=tuple(p / s for p in probs))


def scene_bsphere(scene):
    """Scene bounding sphere (center (3,), radius ()) used by infinite
    emitters to place ray origins (directional.cpp:90-91 takes the kd-tree
    AABB's bsphere with a 1.1x margin; envmap.cpp m_geoBSphere likewise)."""
    vmin = jnp.min(scene.vertices, axis=0)
    vmax = jnp.max(scene.vertices, axis=0)
    c = 0.5 * (vmin + vmax)
    r = jnp.maximum(m.length(vmax - c), 1e-3) * 1.1
    return c, r


def sample_direct(scene, ref_p: jax.Array, u3: jax.Array) -> DirectSample:
    """u3: (N,3) uniforms -> (emitter choice, point-on-emitter)."""
    n = ref_p.shape[0]
    em = scene.emitters
    pg_area, env_p, p_delta = _group_probs(scene)
    # slot layout over u3[...,0]: [0, env_p) env | [env_p, env_p+p_delta)
    # delta | rest area
    pick_env = (u3[..., 0] < env_p) if scene.has_env else jnp.zeros((n,), bool)
    pick_delta = (
        (u3[..., 0] >= env_p) & (u3[..., 0] < env_p + p_delta)
        if scene.delta_emitters is not None else jnp.zeros((n,), bool)
    )
    u_sel = jnp.clip(
        (u3[..., 0] - env_p - p_delta) / max(pg_area, 1e-9), 0.0, 1.0
    )

    # --- area emitter branch -------------------------------------------
    from ..ops.gather import fetch_packed

    idx = jnp.clip(
        jnp.searchsorted(em.tri_cdf, u_sel, side="left"),
        0,
        em.tri_cdf.shape[0] - 1,
    ).astype(jnp.int32)
    p0_all, e1_all, e2_all = scene.tri_vertices()
    # per-emissive-triangle table (tiny), fetched with one gather
    (p0t, e1t, e2t, radt, selt) = fetch_packed(
        [
            p0_all[em.tri_index],
            e1_all[em.tri_index],
            e2_all[em.tri_index],
            em.radiance[em.tri_emitter],
            em.tri_pdf[:, None],
        ],
        idx,
    )
    sel_pdf = selt[:, 0]
    b = warp.square_to_uniform_triangle(u3[..., 1:3])
    pos = p0t + e1t * b[..., 0:1] + e2t * b[..., 1:2]
    ngv = jnp.cross(e1t, e2t)
    two_a = m.length(ngv)
    ng = ngv / two_a[:, None]
    area = 0.5 * two_a
    to_light = pos - ref_p
    dist = m.length(to_light)
    d = to_light / dist[:, None]
    cos_l = m.dot(ng, -d)
    # area pdf -> solid angle (emitter.h pdfDirect conversion)
    p_area = m.safe_div(sel_pdf, area)
    pdf_area_sa = m.safe_div(p_area * dist * dist, jnp.abs(cos_l))
    rad = radt
    # one-sided area emitters: only the front face emits (area.cpp:113)
    front = cos_l > 1e-6
    pdf_area_sa = jnp.where(front, pdf_area_sa, 0.0)
    rad = jnp.where(front[:, None], rad, 0.0)

    pdf = pdf_area_sa * pg_area
    is_delta = jnp.zeros((n,), bool)

    # --- delta emitter branch (point/spot/directional) ------------------
    if scene.delta_emitters is not None:
        de = scene.delta_emitters
        from ..scene import ir as _ir

        k = de.kind.shape[0]
        which = jnp.minimum((u3[..., 1] * k).astype(jnp.int32), k - 1)
        kind = de.kind[which]
        lp = de.position[which]
        ldir = de.direction[which]
        inten = de.intensity[which]
        cut = de.cutoff[which]

        to_l = lp - ref_p
        dist_d = m.length(to_l)
        d_pos = to_l / jnp.maximum(dist_d, 1e-12)[:, None]
        inv_d2 = m.safe_div(1.0, dist_d * dist_d)
        # spot falloff (spot.cpp falloffCurve): 1 inside beamWidth, smooth
        # to 0 at cutoffAngle
        cos_spot = m.dot(-d_pos, ldir)
        fall = jnp.clip(
            m.safe_div(cos_spot - cut[..., 0], jnp.maximum(cut[..., 1] - cut[..., 0], 1e-6)),
            0.0, 1.0,
        )
        rad_point = inten * inv_d2[:, None]
        rad_spot = rad_point * fall[:, None]
        is_dirl = kind == _ir.DELTA_DIRECTIONAL
        d_delta = jnp.where(is_dirl[:, None], -ldir, d_pos)
        dist_delta = jnp.where(is_dirl, m.INF * 0.1, dist_d)
        rad_delta = jnp.where(
            (kind == _ir.DELTA_SPOT)[:, None], rad_spot,
            jnp.where(is_dirl[:, None], inten, rad_point),
        )
        # collimated beams have delta position AND direction: the chance
        # that a surface point lies on the beam is zero (collimated.cpp —
        # no sampleDirect); reachable only via sample_emitter_ray
        rad_delta = jnp.where((kind == _ir.DELTA_COLLIMATED)[:, None],
                              0.0, rad_delta)
        sel = p_delta / k
        d = jnp.where(pick_delta[:, None], d_delta, d)
        dist = jnp.where(pick_delta, dist_delta, dist)
        rad = jnp.where(pick_delta[:, None], rad_delta, rad)
        pdf = jnp.where(pick_delta, sel, pdf)
        is_delta = pick_delta

    # --- environment branch --------------------------------------------
    if scene.has_env:
        if scene.envmap is not None:
            from ..scene import envmap as envlib

            d_env, pdf_env, rad_env = envlib.sample_direction(
                scene.envmap, u3[..., 1:3]
            )
        else:
            d_env = warp.square_to_uniform_sphere(u3[..., 1:3])
            pdf_env = jnp.full((n,), warp.square_to_uniform_sphere_pdf())
            rad_env = jnp.broadcast_to(scene.env_radiance, (n, 3))
        d = jnp.where(pick_env[:, None], d_env, d)
        dist = jnp.where(pick_env, m.INF * 0.1, dist)
        rad = jnp.where(pick_env[:, None], rad_env, rad)
        pdf = jnp.where(pick_env, pdf_env * env_p, pdf)
    n_l = jnp.where((is_delta | pick_env)[:, None], 0.0, ng)
    return DirectSample(d=d, dist=dist, radiance=rad, pdf=pdf,
                        is_env=pick_env, is_delta=is_delta, n_l=n_l)


# ---------------------------------------------------------------------------
# Emitter ray sampling (light-path starts) — the analog of
# Scene::sampleEmitterRay (scene.cpp:1103) over every emitter kind:
# area (area.cpp), point/spot/directional ({point,spot,directional}.cpp
# sampleRay), constant/envmap (constant.cpp:159, envmap.cpp:498).
# ---------------------------------------------------------------------------

# Emitter-vertex kind codes carried by light subpaths (per-lane).
EV_AREA = 0
EV_ENV = 1
EV_POINT = 2
EV_SPOT = 3
EV_DIR = 4


class EmitterRaySample(NamedTuple):
    """A sampled light-path origin: ray + pdf bookkeeping for BDPT MIS.

    Conventions (z0 = emitter vertex):
      beta     = full ray weight Le-ish/(sel*pdf_pos*pdf_dir): the emitted
                 power estimator carried by a unidirectional particle.
      beta_pos = weight of z0 alone, for s=1 connections: area Le/pdf_pos;
                 point/spot I/sel (falloff applied at connection time);
                 env L(d)/(pdf_dir*sel); directional E/sel.
      pdf_pos  = measure-matched pdf of z0: area lights sel/area (area
                 measure); env sel*pdf_dir (solid angle — the direction IS
                 the env vertex); delta-position lights sel (discrete).
      pdf_dir  = pdf of the ray direction given z0: area cos/pi (solid
                 angle); point 1/4pi; spot cone pdf; env/directional the
                 bsphere-disk position pdf 1/(pi r^2) (area measure — the
                 swap mirrors how infinite lights exchange the roles of
                 position and direction).
    """

    o: jax.Array          # (N,3) ray origin (epsilon-offset)
    d: jax.Array          # (N,3) ray direction
    beta: jax.Array       # (N,3) full ray throughput weight
    ng: jax.Array         # (N,3) normal at origin (delta/inf: ray dir)
    pos: jax.Array        # (N,3) emitter vertex position (unoffset)
    beta_pos: jax.Array   # (N,3)
    pdf_pos: jax.Array    # (N,)
    pdf_dir: jax.Array    # (N,)
    kind: jax.Array       # (N,) int32 EV_*
    tri: jax.Array        # (N,) int32 area triangle id (0 if N/A)
    aux_dir: jax.Array    # (N,3) spot axis / directional-env ray direction
    cutoff: jax.Array     # (N,2) spot (cos cutoff, cos beam)
    delta_pos: jax.Array  # (N,) bool
    delta_dir: jax.Array  # (N,) bool
    is_env: jax.Array     # (N,) bool
    is_area: jax.Array    # (N,) bool


def sample_emitter_ray(scene, u_sel, u_pos, u_dir) -> EmitterRaySample:
    """Sample a ray leaving an emitter; covers area, env, point, spot and
    directional lights with one batched mask-combined computation."""
    n = u_sel.shape[0]
    em = scene.emitters
    pg_area, env_p, p_delta = _group_probs(scene)
    ray_eps = 1e-3

    pick_env = (u_sel < env_p) if scene.has_env else jnp.zeros((n,), bool)
    pick_delta = (
        (u_sel >= env_p) & (u_sel < env_p + p_delta)
        if scene.delta_emitters is not None else jnp.zeros((n,), bool)
    )
    is_area = ~(pick_env | pick_delta)

    # --- area branch ----------------------------------------------------
    u_area = jnp.clip((u_sel - env_p - p_delta) / max(pg_area, 1e-9), 0.0, 1.0)
    idx = jnp.clip(
        jnp.searchsorted(em.tri_cdf, u_area, side="left"),
        0, em.tri_cdf.shape[0] - 1,
    ).astype(jnp.int32)
    tri = em.tri_index[idx]
    sel_area = em.tri_pdf[idx] * max(pg_area, 1e-9)
    p0, e1, e2 = scene.tri_vertices()
    b = warp.square_to_uniform_triangle(u_pos)
    pos = p0[tri] + e1[tri] * b[..., 0:1] + e2[tri] * b[..., 1:2]
    ngv = jnp.cross(e1[tri], e2[tri])
    two_a = m.length(ngv)
    ng = ngv / jnp.maximum(two_a, 1e-20)[:, None]
    area = 0.5 * two_a
    wo_local = warp.square_to_cosine_hemisphere(u_dir)
    d = m.to_world(ng, wo_local)
    le = em.radiance[em.tri_emitter[idx]]
    pdf_pos = m.safe_div(sel_area, area)
    pdf_dir = jnp.maximum(m.dot(d, ng), 0.0) * (1.0 / jnp.pi)
    beta_pos = le / jnp.maximum(pdf_pos, 1e-20)[:, None]
    beta = le * (jnp.pi * m.safe_div(area, sel_area))[:, None]
    o = pos + ng * ray_eps
    kind = jnp.full((n,), EV_AREA, jnp.int32)
    aux_dir = d
    cutoff = jnp.zeros((n, 2))
    delta_pos = jnp.zeros((n,), bool)
    delta_dir = jnp.zeros((n,), bool)

    c_bs, r_bs = scene_bsphere(scene)
    disk_pdf = 1.0 / (jnp.pi * r_bs * r_bs)

    # --- delta branch (point / spot / directional) ----------------------
    if scene.delta_emitters is not None:
        de = scene.delta_emitters
        from ..scene import ir as _ir

        k = de.kind.shape[0]
        u_d = jnp.clip((u_sel - env_p) / max(p_delta, 1e-9), 0.0, 1.0 - 1e-7)
        which = jnp.minimum((u_d * k).astype(jnp.int32), k - 1)
        dkind = de.kind[which]
        lp = de.position[which]
        ldir = de.direction[which]
        inten = de.intensity[which]
        cut = de.cutoff[which]
        sel = max(p_delta, 1e-9) / k

        is_point = dkind == _ir.DELTA_POINT
        is_spot = dkind == _ir.DELTA_SPOT
        is_dirl = dkind == _ir.DELTA_DIRECTIONAL
        is_coll = dkind == _ir.DELTA_COLLIMATED

        d_sphere = warp.square_to_uniform_sphere(u_dir)
        cone_local = warp.square_to_uniform_cone(u_dir, cut[..., 0])
        d_cone = m.to_world(ldir, cone_local)
        pdf_cone = warp.square_to_uniform_cone_pdf(cut[..., 0])
        cos_spot = m.dot(d_cone, ldir)
        fall = jnp.clip(
            m.safe_div(cos_spot - cut[..., 0],
                       jnp.maximum(cut[..., 1] - cut[..., 0], 1e-6)),
            0.0, 1.0,
        )
        # directional: origin on the perpendicular bsphere disk
        # (directional.cpp:151-153)
        off = warp.square_to_uniform_disk_concentric(u_pos) * r_bs
        t1, t2 = m.coordinate_system(ldir)
        o_disk = c_bs - ldir * r_bs + t1 * off[..., 0:1] + t2 * off[..., 1:2]

        d_delta = jnp.where((is_dirl | is_coll)[:, None], ldir,
                            jnp.where(is_spot[:, None], d_cone, d_sphere))
        pos_delta = jnp.where(is_dirl[:, None], o_disk, lp)
        pdf_dir_delta = jnp.where(
            is_dirl | is_coll, 1.0,
            jnp.where(is_spot, pdf_cone, warp.square_to_uniform_sphere_pdf()),
        )
        beta_delta = jnp.where(
            is_dirl[:, None], inten * (jnp.pi * r_bs * r_bs) / sel,
            jnp.where(is_spot[:, None],
                      inten * m.safe_div(fall, pdf_cone)[:, None] / sel,
                      jnp.where(is_coll[:, None], inten / sel,
                                inten * (4.0 * jnp.pi / sel))),
        )
        beta_pos_delta = inten / sel
        pdf_pos_delta = jnp.full((n,), sel)
        kind_delta = jnp.where(
            is_dirl, EV_DIR, jnp.where(is_spot, EV_SPOT, EV_POINT)
        ).astype(jnp.int32)

        sel_m = pick_delta
        o = jnp.where(sel_m[:, None], pos_delta + d_delta * ray_eps, o)
        d = jnp.where(sel_m[:, None], d_delta, d)
        pos = jnp.where(sel_m[:, None], pos_delta, pos)
        ng = jnp.where(sel_m[:, None], d_delta, ng)
        beta = jnp.where(sel_m[:, None], beta_delta, beta)
        beta_pos = jnp.where(sel_m[:, None], beta_pos_delta, beta_pos)
        pdf_pos = jnp.where(sel_m, pdf_pos_delta, pdf_pos)
        pdf_dir = jnp.where(sel_m, jnp.where(is_dirl, disk_pdf, pdf_dir_delta),
                            pdf_dir)
        kind = jnp.where(sel_m, kind_delta, kind)
        aux_dir = jnp.where(sel_m[:, None], ldir, aux_dir)
        cutoff = jnp.where(sel_m[:, None], cut, cutoff)
        delta_pos = jnp.where(sel_m, ~is_dirl, delta_pos)
        delta_dir = jnp.where(sel_m, is_dirl | is_coll, delta_dir)

    # --- environment branch (constant.cpp:159 / envmap.cpp:498) ---------
    if scene.has_env:
        if scene.envmap is not None:
            from ..scene import envmap as envlib

            d_out, pdf_env, rad_env = envlib.sample_direction(
                scene.envmap, u_dir
            )
        else:
            d_out = warp.square_to_uniform_sphere(u_dir)
            pdf_env = jnp.full((n,), warp.square_to_uniform_sphere_pdf())
            rad_env = jnp.broadcast_to(scene.env_radiance, (n, 3))
        d_in = -d_out                      # ray travels INTO the scene
        off = warp.square_to_uniform_disk_concentric(u_pos) * r_bs
        t1, t2 = m.coordinate_system(d_in)
        o_env = c_bs - d_in * r_bs + t1 * off[..., 0:1] + t2 * off[..., 1:2]
        sel = max(env_p, 1e-9)
        beta_env = rad_env * m.safe_div(jnp.pi * r_bs * r_bs, pdf_env * sel)[:, None]
        beta_pos_env = rad_env / jnp.maximum(pdf_env * sel, 1e-20)[:, None]

        o = jnp.where(pick_env[:, None], o_env, o)
        d = jnp.where(pick_env[:, None], d_in, d)
        pos = jnp.where(pick_env[:, None], o_env, pos)
        ng = jnp.where(pick_env[:, None], d_in, ng)
        beta = jnp.where(pick_env[:, None], beta_env, beta)
        beta_pos = jnp.where(pick_env[:, None], beta_pos_env, beta_pos)
        pdf_pos = jnp.where(pick_env, pdf_env * sel, pdf_pos)
        pdf_dir = jnp.where(pick_env, disk_pdf, pdf_dir)
        kind = jnp.where(pick_env, EV_ENV, kind)
        aux_dir = jnp.where(pick_env[:, None], d_in, aux_dir)
        delta_dir = jnp.where(pick_env, False, delta_dir)

    return EmitterRaySample(
        o=o, d=d, beta=beta, ng=ng, pos=pos, beta_pos=beta_pos,
        pdf_pos=pdf_pos, pdf_dir=pdf_dir, kind=kind, tri=tri,
        aux_dir=aux_dir, cutoff=cutoff, delta_pos=delta_pos,
        delta_dir=delta_dir, is_env=pick_env, is_area=is_area,
    )


def connect_emitter_vertex(scene, p, kind, pos, ng, aux_dir, cutoff):
    """Geometry of connecting surface point `p` to a light-path origin
    vertex z0 (the s=1 BDPT / LVC-BPT connection; mirrors the per-emitter
    sampleDirect geometry, emitter.h:190-278).

    Returns (cdir, dist, g, finite) with contribution
      beta_eye * f_eye(cdir) * g * beta_pos(z0):
    g folds the measure conversion — cos_z/d^2 for area, falloff/d^2 for
    spot, 1/d^2 for point, 1 for env/directional (delta direction: only
    -aux_dir transports, no inverse-square)."""
    to_l = pos - p
    d2 = jnp.maximum(m.dot(to_l, to_l), 1e-12)
    dist_f = jnp.sqrt(d2)
    cdir_f = to_l / dist_f[:, None]
    inv_d2 = 1.0 / d2

    cos_z = jnp.maximum(m.dot(ng, -cdir_f), 0.0)
    g_area = cos_z * inv_d2
    # spot falloff toward p (direction light->p = -cdir)
    cos_ax = m.dot(-cdir_f, aux_dir)
    fall = jnp.clip(
        m.safe_div(cos_ax - cutoff[..., 0],
                   jnp.maximum(cutoff[..., 1] - cutoff[..., 0], 1e-6)),
        0.0, 1.0,
    )
    g = jnp.where(kind == EV_AREA, g_area,
                  jnp.where(kind == EV_SPOT, fall * inv_d2,
                            jnp.where(kind == EV_POINT, inv_d2, 1.0)))
    infinite = (kind == EV_ENV) | (kind == EV_DIR)
    cdir = jnp.where(infinite[:, None], -aux_dir, cdir_f)
    dist = jnp.where(infinite, m.INF * 0.1, dist_f)
    return cdir, dist, g, ~infinite


def emitter_dir_pdf_area(kind, pos, ng, aux_dir, cutoff, disk_pdf,
                         y_p, y_ng) -> jax.Array:
    """Area-measure pdf of emitter vertex z0 generating a ray through the
    surface point y (per-lane kind dispatch; the light-side 'directional'
    pdf override in BDPT/LVC MIS sums).

    area: cos0/pi * cos_y/d^2; point: 1/(4pi) * cos_y/d^2; spot: cone pdf
    inside the cone; env/directional: parallel-ray density disk_pdf *
    |cos_y| (no inverse-square — infinite lights)."""
    to_y = y_p - pos
    d2 = jnp.maximum(m.dot(to_y, to_y), 1e-12)
    w = to_y * jax.lax.rsqrt(d2)[:, None]
    inv_pi = 1.0 / jnp.pi
    cos_y_fin = jnp.abs(m.dot(w, y_ng)) / d2          # finite-light conversion
    pdf_area = jnp.maximum(m.dot(w, ng), 0.0) * inv_pi
    pdf_point = 1.0 / (4.0 * jnp.pi)
    cos_ax = m.dot(w, aux_dir)
    pdf_spot = jnp.where(
        cos_ax > cutoff[..., 0],
        warp.square_to_uniform_cone_pdf(cutoff[..., 0]), 0.0)
    cos_y_inf = jnp.abs(m.dot(aux_dir, y_ng))
    return jnp.where(
        kind == EV_AREA, pdf_area * cos_y_fin,
        jnp.where(kind == EV_POINT, pdf_point * cos_y_fin,
                  jnp.where(kind == EV_SPOT, pdf_spot * cos_y_fin,
                            disk_pdf * cos_y_inf)))


def emitter_hit_pdf(kind, pos, ng, from_p, bsdf_pdf_sa) -> jax.Array:
    """pdf (in z0's own measure) of the EYE side generating emitter vertex
    z0 by scattering from `from_p` with solid-angle pdf `bsdf_pdf_sa`:
    area lights convert to area; env stays solid-angle (z0's measure);
    delta-position/direction lights can never be hit -> 0."""
    to_z = pos - from_p
    d2 = jnp.maximum(m.dot(to_z, to_z), 1e-12)
    w = to_z * jax.lax.rsqrt(d2)[:, None]
    conv = jnp.abs(m.dot(w, ng)) / d2
    return jnp.where(kind == EV_AREA, bsdf_pdf_sa * conv,
                     jnp.where(kind == EV_ENV, bsdf_pdf_sa, 0.0))


def pdf_direct_area(scene, ref_p, d, dist, prim, cos_l) -> jax.Array:
    """Solid-angle pdf that sample_direct would have produced direction `d`
    hitting triangle `prim` at distance `dist` (for MIS on BSDF samples).
    Mirrors Scene::pdfEmitterDirect (scene.h:577)."""
    from ..ops.gather import fetch_packed

    em = scene.emitters
    _, e1, e2 = scene.tri_vertices()
    area_all = 0.5 * m.length(jnp.cross(e1, e2))   # (T,) — O(T), cheap
    (selt, areat) = fetch_packed(
        [em.select_pdf_full[:, None], area_all[:, None]], prim
    )
    p_area = m.safe_div(selt[:, 0], areat[:, 0])
    pdf = m.safe_div(p_area * dist * dist, jnp.abs(cos_l))
    pg_area, _, _ = _group_probs(scene)
    return pdf * pg_area


def pdf_direct_env(scene, d: jax.Array) -> jax.Array:
    """Solid-angle pdf of sample_direct's env branch for direction d
    (MIS weight for BSDF samples that escape)."""
    if not scene.has_env:
        return jnp.zeros(d.shape[:-1], jnp.float32)
    _, env_p, _ = _group_probs(scene)
    if scene.envmap is not None:
        from ..scene import envmap as envlib

        return envlib.pdf_direction(scene.envmap, d) * env_p
    return jnp.full(
        d.shape[:-1], warp.square_to_uniform_sphere_pdf() * env_p
    )


def env_radiance(scene, d: jax.Array) -> jax.Array:
    """Environment emission for escaped rays (constant.cpp / envmap.cpp)."""
    if not scene.has_env:
        return jnp.zeros(d.shape[:-1] + (3,), d.dtype)
    if scene.envmap is not None:
        from ..scene import envmap as envlib

        return envlib.eval_radiance(scene.envmap, d)
    return jnp.broadcast_to(scene.env_radiance, d.shape[:-1] + (3,))
