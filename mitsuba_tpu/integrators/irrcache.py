"""Irradiance caching (src/librender/irrcache.cpp:44 HierarchicalIrradianceCache
+ src/integrators/misc/irrcache).

Redesign: the reference's lazily-filled octree with per-query
insertion is pointer-chasing, mutation-heavy, and order-dependent — all
hostile to SPMD. Instead the cache is built EAGERLY as a flat point
cloud (the same strategy the dipole subsurface uses for its irradiance
samples): area-weighted surface points, each with a hemispherical MC
estimate of INDIRECT irradiance and the harmonic-mean gather distance,
stored in a hash grid. Shading interpolates with Ward's weights
   w_i = 1 / (|x - x_i| / R_i + sqrt(1 - n.n_i))
(irrcache.cpp:269) and adds exact direct lighting (the irrcache
integrator's split). Indirect gather rays return the DIRECT lighting at
their hit (one-bounce cache, the reference's default single-level mode).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import SampleStream, uniform
from ..core import warp
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import hashgrid, trace
from .common import RenderConfig

RAY_EPS = 1e-3


def _direct_at(scene, p, ns, ng, sp, wi_local, u3, families):
    """One-sample NEE direct lighting (no MIS partner: the gather rays
    that produced these points never double-count emitters)."""
    ds = emitterlib.sample_direct(scene, p, u3)
    wo_local = m.to_local(ns, ds.d)
    f, _ = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
    blocked = trace.any_hit(scene, p, ds.d, ds.dist)
    ok = (ds.pdf > 0.0) & ~blocked
    return jnp.where(ok[:, None],
                     f * ds.radiance * m.safe_div(1.0, ds.pdf)[:, None], 0.0)


def build_cache(scene, cfg: RenderConfig, n_points: int = 4096,
                n_hemi: int = 64, seed: int = 77):
    """Returns (positions (M,3), normals (M,3), E (M,3) indirect
    irradiance, R (M,) harmonic-mean distance, grid)."""
    families = scene.bsdf_families
    # area-weighted positions over all triangles
    v = scene.vertices
    i = scene.indices
    p0 = v[i[:, 0]]
    e1 = v[i[:, 1]] - p0
    e2 = v[i[:, 2]] - p0
    areas = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    cdf = jnp.cumsum(areas)
    cdf = cdf / cdf[-1]
    lanes = jnp.arange(n_points, dtype=jnp.uint32)

    def u(dim):
        return uniform(jnp.uint32(seed), lanes, jnp.uint32(0), dim)

    tri = jnp.searchsorted(cdf, u(0)).astype(jnp.int32)
    tri = jnp.minimum(tri, areas.shape[0] - 1)
    b1 = u(1)
    b2 = u(2)
    flip = b1 + b2 > 1.0
    b1 = jnp.where(flip, 1.0 - b1, b1)
    b2 = jnp.where(flip, 1.0 - b2, b2)
    pos = p0[tri] + e1[tri] * b1[:, None] + e2[tri] * b2[:, None]
    ngv = jnp.cross(e1[tri], e2[tri])
    nrm = ngv / m.length(ngv, keepdims=True)

    # hemispherical gather: K cosine rays per cache point. Alongside E
    # we estimate the Ward-Heckbert IRRADIANCE GRADIENTS (the reference
    # cache's accuracy feature, irrcache.h:148) in MC form:
    #   rotational: dE/d(rot about a) = (pi/N) sum L_k (a.(n x w_k))/cos
    #     (differentiating the (n.w) weight of the fixed sample set);
    #   translational: differentiate the area-form measure factor
    #     (n.w) cos_y / r^2 of each sample's FIXED hit point y_k:
    #     grad factor g_k = 4w/r - n/(r cos) + n_y/(r cos_y)
    #     (cosines clamped to 0.1 against grazing blowup).
    # Interpolation then extrapolates each record first-order in both
    # position and normal, the same first-order model the reference uses.
    E = jnp.zeros((n_points, 3))
    g_rot = jnp.zeros((n_points, 3, 3))    # (point, channel, axis)
    g_tr = jnp.zeros((n_points, 3, 3))
    inv_dist = jnp.zeros((n_points,))
    hits_n = jnp.zeros((n_points,))

    def body(carry, k):
        E, g_rot, g_tr, inv_dist, hits_n = carry
        uu = jnp.stack([u(10 + 4 * k), u(11 + 4 * k)], -1)
        local = warp.square_to_cosine_hemisphere(uu)
        d = m.to_world(nrm, local)
        o = pos + nrm * RAY_EPS
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
        wi_local = m.to_local(si["ns"], si["wi_world"])
        u3 = jnp.stack([u(12 + 4 * k), u(13 + 4 * k),
                        u(1000 + k)], -1)
        ld = _direct_at(scene, si["p"], si["ns"], si["ng"], sp, wi_local,
                        u3, families)
        # gather radiance back toward the cache point: diffuse-ish
        # approximation L_out ~ albedo/pi * E_direct (the cache stores
        # one-bounce indirect; emitter hits contribute nothing)
        L = jnp.where(its.valid[:, None], ld, 0.0)
        # cosine pdf cancels the cosine: E += pi * mean(L)
        E = E + L
        cos_l = jnp.maximum(jnp.sum(d * nrm, -1), 0.1)
        axis = jnp.cross(nrm, d) / cos_l[:, None]              # (N,3)
        g_rot = g_rot + L[:, :, None] * axis[:, None, :]
        r_k = jnp.maximum(its.t, 1e-3)
        cos_y = jnp.maximum(-jnp.sum(d * si["ng"], -1), 0.1)
        gfac = (4.0 * d / r_k[:, None]
                - nrm / (r_k * cos_l)[:, None]
                + si["ng"] / (r_k * cos_y)[:, None])
        gfac = jnp.where(its.valid[:, None], gfac, 0.0)
        g_tr = g_tr + L[:, :, None] * gfac[:, None, :]
        inv_dist = inv_dist + jnp.where(its.valid, 1.0 / jnp.maximum(
            its.t, 1e-4), 0.0)
        hits_n = hits_n + its.valid
        return (E, g_rot, g_tr, inv_dist, hits_n), None

    (E, g_rot, g_tr, inv_dist, hits_n), _ = jax.lax.scan(
        body, (E, g_rot, g_tr, inv_dist, hits_n),
        jnp.arange(n_hemi, dtype=jnp.uint32))
    E = E * (jnp.pi / n_hemi)
    g_rot = g_rot * (jnp.pi / n_hemi)
    g_tr = g_tr * (jnp.pi / n_hemi)
    # harmonic mean distance; open hemispheres get a large R
    R = jnp.where(hits_n > 0, hits_n / jnp.maximum(inv_dist, 1e-6), 1e6)
    # clamp R to sane bounds relative to the scene size
    diag = float(jnp.linalg.norm(jnp.max(v, 0) - jnp.min(v, 0)))
    R = jnp.clip(R, 0.01 * diag, 0.5 * diag)
    cell = 0.1 * diag
    grid = hashgrid.build(pos, jnp.ones((n_points,), bool), cell)
    return pos, nrm, E, R, grid, cell, g_rot, g_tr


def interpolate(cache, p, n):
    """Ward-weighted irradiance lookup at (p, n) with first-order
    gradient extrapolation (irrcache.h:148): each record contributes
    E_i + (n_i x n).G_rot,i + (p - p_i).G_tr,i."""
    pos, nrm, E, R, grid, cell, g_rot, g_tr = cache

    def reduce_fn(carry, pidx, mask):
        acc_e, acc_w = carry
        dvec = p[:, None, :] - pos[pidx]
        dist = jnp.linalg.norm(dvec, axis=-1)
        ndot = jnp.clip(jnp.sum(nrm[pidx] * n[:, None, :], -1), -1.0, 1.0)
        w = 1.0 / (dist / R[pidx] + jnp.sqrt(jnp.maximum(1.0 - ndot, 0.0))
                   + 1e-3)
        w = jnp.where(mask & (ndot > 0.1), w, 0.0)
        rot_axis = jnp.cross(nrm[pidx], n[:, None, :])     # (q,w,3)
        e_ext = (E[pidx]
                 + jnp.einsum("qwca,qwa->qwc", g_rot[pidx], rot_axis,
                              precision=jax.lax.Precision.HIGHEST)
                 + jnp.einsum("qwca,qwa->qwc", g_tr[pidx], dvec,
                              precision=jax.lax.Precision.HIGHEST))
        e_ext = jnp.maximum(e_ext, 0.0)
        acc_e = acc_e + jnp.einsum("qw,qwc->qc", w, e_ext,
                                   precision=jax.lax.Precision.HIGHEST)
        acc_w = acc_w + jnp.sum(w, -1)
        return acc_e, acc_w

    radius = jnp.full((p.shape[0],), cell)
    (acc_e, acc_w), _ = hashgrid.query_sum(
        grid, pos, p, radius, reduce_fn,
        (jnp.zeros((p.shape[0], 3)), jnp.zeros((p.shape[0],))))
    return m.safe_div(acc_e, acc_w[:, None])


def li_factory(cache):
    """Returns a li(scene, cam, o, d, stream, cfg) closure rendering
    direct + cached indirect (the irrcache integrator split)."""

    def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig):
        from . import direct as directlib

        L = directlib.li(scene, cam, o, d, stream, cfg)
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
        E = interpolate(cache, si["p"], si["ns"])
        ind = sp.reflectance / jnp.pi * E
        return L + jnp.where(its.valid[:, None], ind, 0.0)

    return li


def render(scene, cam, cfg: RenderConfig, n_points: int = 4096,
           n_hemi: int = 64):
    """Two-pass irradiance-cached render -> (H, W, 3)."""
    from . import common

    cache = build_cache(scene, cfg, n_points, n_hemi, seed=cfg.seed + 77)
    return common.render_jit(scene, cam, li_factory(cache), cfg)
