"""Dipole subsurface scattering (Jensen et al. 2001).

Analog of src/subsurface/dipole.cpp: the reference caches
irradiance at surface sample points in an octree (irrtree) and gathers the
dipole diffusion kernel Rd(r) over it. Here the irradiance cache is a flat
batch of area-weighted surface points whose irradiance is computed in one
wavefront NEE pass, and the render-time gather is a dense (pixels x points)
one-hot-free contraction for small caches — dense matmul-style sums are
faster than spatial culling until the cache is large, at which point
the hash grid (ops/hashgrid.py) takes over.

Dipole BSSRDF (classic better-dipole-free formulation):
  sigma_tr = sqrt(3 sigma_a sigma_t')
  z_r = 1/sigma_t';  z_v = z_r (1 + 4/3 A)
  Rd(r) = alpha'/(4 pi) * [ z_r (1+s_r d_r) e^{-s_r d_r} / d_r^3
                          + z_v (1+s_r d_v) e^{-s_r d_v} / d_v^3 ]
with d_r = sqrt(r^2 + z_r^2), d_v = sqrt(r^2 + z_v^2), s_r = sigma_tr.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import uniform
from ..models import emitter as emitterlib
from ..ops import trace


class DipoleParams(NamedTuple):
    sigma_s: jax.Array   # (3,) scattering
    sigma_a: jax.Array   # (3,) absorption
    g: float             # phase asymmetry (reduces sigma_s)
    eta: float           # relative IOR


def _dipole_constants(p: DipoleParams):
    sigma_sp = p.sigma_s * (1.0 - p.g)
    sigma_tp = sigma_sp + p.sigma_a
    alpha_p = sigma_sp / jnp.maximum(sigma_tp, 1e-9)
    sigma_tr = jnp.sqrt(3.0 * p.sigma_a * sigma_tp)
    # internal diffuse Fresnel reflectance (dipole.cpp Fdr fit)
    eta = p.eta
    fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    a_coef = (1.0 + fdr) / (1.0 - fdr)
    z_r = 1.0 / jnp.maximum(sigma_tp, 1e-9)
    z_v = z_r * (1.0 + 4.0 / 3.0 * a_coef)
    return alpha_p, sigma_tr, z_r, z_v


def rd_profile(p: DipoleParams, r: jax.Array) -> jax.Array:
    """Diffusion profile Rd(r): (N,) radii -> (N, 3)."""
    alpha_p, sigma_tr, z_r, z_v = _dipole_constants(p)
    r2 = (r * r)[:, None]
    d_r = jnp.sqrt(r2 + z_r[None, :] ** 2)
    d_v = jnp.sqrt(r2 + z_v[None, :] ** 2)
    s = sigma_tr[None, :]
    c1 = z_r[None, :] * (1.0 + s * d_r) * jnp.exp(-s * d_r) / jnp.maximum(d_r ** 3, 1e-12)
    c2 = z_v[None, :] * (1.0 + s * d_v) * jnp.exp(-s * d_v) / jnp.maximum(d_v ** 3, 1e-12)
    return alpha_p[None, :] / (4.0 * jnp.pi) * (c1 + c2)


def sample_surface_points(scene, tri_mask: np.ndarray, n_points: int,
                          seed: int = 0, blue_noise: bool = True):
    """Blue-noise sample points on the masked triangles (host-side
    preprocessing, like the reference: src/subsurface/bluenoise.cpp
    blueNoisePointSet — dart throwing with a spatial hash against a
    Poisson-disk radius derived from the target density). Returns
    (points, normals, area_per_point); the returned count can be
    slightly under n_points (the achieved dart count), which
    area_per_point accounts for. blue_noise=False falls back to plain
    area-stratified sampling."""
    rs = np.random.RandomState(seed)
    verts = np.asarray(scene.vertices)
    idx = np.asarray(scene.indices)[tri_mask]
    p0 = verts[idx[:, 0]]
    e1 = verts[idx[:, 1]] - p0
    e2 = verts[idx[:, 2]] - p0
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total_area = areas.sum()
    probs = areas / total_area

    def area_sample(k):
        tri = rs.choice(len(idx), size=k, p=probs)
        u = rs.rand(k, 2).astype(np.float32)
        su = np.sqrt(u[:, 0])
        b1 = (1 - su)
        b2 = u[:, 1] * su
        pts = p0[tri] + e1[tri] * b1[:, None] + e2[tri] * b2[:, None]
        n = np.cross(e1[tri], e2[tri])
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        return pts, n

    if not blue_noise:
        pts, n = area_sample(n_points)
        return (jnp.asarray(pts.astype(np.float32)),
                jnp.asarray(n.astype(np.float32)),
                float(total_area / n_points))

    # Poisson-disk radius for n_points disks covering total_area at
    # ~70% of the hexagonal-packing bound (bluenoise.cpp uses the same
    # density->radius relation); greedy dart throwing over 4x
    # oversampled area-stratified candidates with a cell hash.
    r = 0.7 * np.sqrt(total_area / (2.0 * np.sqrt(3.0) * n_points))
    cand_pts, cand_n = area_sample(4 * n_points)
    cell = r / np.sqrt(3.0)
    keys = np.floor(cand_pts / cell).astype(np.int64)
    grid: dict = {}
    acc_pts, acc_n = [], []
    r2 = r * r
    for i in range(len(cand_pts)):
        c = keys[i]
        p = cand_pts[i]
        ok = True
        for dx in (-2, -1, 0, 1, 2):
            for dy in (-2, -1, 0, 1, 2):
                for dz in (-2, -1, 0, 1, 2):
                    for j in grid.get((c[0] + dx, c[1] + dy, c[2] + dz), ()):
                        q = acc_pts[j]
                        dvec = p - q
                        if dvec @ dvec < r2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid.setdefault(tuple(c), []).append(len(acc_pts))
            acc_pts.append(p)
            acc_n.append(cand_n[i])
            if len(acc_pts) >= n_points:
                break
    pts = np.asarray(acc_pts, np.float32)
    n = np.asarray(acc_n, np.float32)
    return (jnp.asarray(pts), jnp.asarray(n),
            float(total_area / len(pts)))


def compute_irradiance(scene, pts, nrm, cfg, n_samples: int = 8):
    """Batched NEE irradiance estimate at the cache points (the irrtree
    fill pass, dipole.cpp preprocess)."""
    npts = pts.shape[0]
    seed = jnp.uint32(cfg.seed ^ 0xD1901E)
    E = jnp.zeros((npts, 3))
    pid = jnp.arange(npts, dtype=jnp.uint32)
    for k in range(n_samples):
        u3 = jnp.stack([uniform(seed, pid, jnp.uint32(k), j) for j in range(3)], -1)
        ds = emitterlib.sample_direct(scene, pts, u3)
        cos_i = jnp.maximum(m.dot(ds.d, nrm), 0.0)
        blocked = trace.any_hit(scene, pts, ds.d, ds.dist)
        ok = (ds.pdf > 0) & ~blocked & (cos_i > 0)
        E = E + jnp.where(ok[:, None],
                          ds.radiance * (cos_i / jnp.maximum(ds.pdf, 1e-12))[:, None],
                          0.0)
    return E / n_samples


def sss_exitant_radiance(params: DipoleParams, cache_pts, cache_E,
                         area_per_point, query_p, query_ns, wo_world):
    """Outgoing radiance at query points from the dipole gather:
    Lo = (Ft(wo)/pi) * sum_i Rd(|x - x_i|) E_i A_i  (dipole.cpp Lo)."""
    eta = params.eta
    ft_o, _, _, _ = m.fresnel_dielectric(
        jnp.maximum(m.dot(wo_world, query_ns), 0.0), jnp.asarray(eta))
    # dense gather: (Q, P) distances -> profile-weighted sum
    dvec = query_p[:, None, :] - cache_pts[None, :, :]
    r = jnp.sqrt(jnp.maximum(jnp.sum(dvec * dvec, -1), 1e-12))
    q, p = r.shape
    rd = rd_profile(params, r.reshape(-1)).reshape(q, p, 3)
    mo = (rd * cache_E[None, :, :]).sum(1) * area_per_point
    return (1.0 - ft_o)[:, None] / jnp.pi * mo


def _refracted_connection(eta, h, H, d_xy, iters: int = 28):
    """Solve the planar refracted-connection root (Walter et al. 2009 /
    singlescatter.cpp, reduced to the local tangent plane): find the
    in-plane offset r of the exit point between the internal scatter
    point (depth h below the interface) and the light point (height H
    above, horizontal distance d_xy) satisfying Snell's law

        eta * r / sqrt(r^2 + h^2) = (d_xy - r) / sqrt((d_xy-r)^2 + H^2).

    f is monotone increasing on [0, d_xy] with f(0) <= 0 <= f(d_xy), so
    bisection converges unconditionally; at the root sin(theta_out) =
    eta sin(theta_in) <= 1, so total internal reflection never occurs
    at a solution. Returns (r, df/dr at r) — the derivative feeds the
    implicit-function Jacobian (bisection itself has zero derivative)."""

    def f(r):
        return (eta * r / jnp.sqrt(r * r + h * h)
                - (d_xy - r) / jnp.sqrt((d_xy - r) ** 2 + H * H))

    lo = jnp.zeros_like(d_xy)
    hi = d_xy

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        neg = f(mid) < 0.0
        return jnp.where(neg, mid, lo), jnp.where(neg, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    r = 0.5 * (lo + hi)
    df = (eta * h * h / jnp.maximum((r * r + h * h) ** 1.5, 1e-20)
          + H * H / jnp.maximum(((d_xy - r) ** 2 + H * H) ** 1.5, 1e-20))
    return r, df


def single_scatter_radiance(params: DipoleParams, scene, query_p, query_ns,
                            wo_world, cfg, n_samples: int = 4,
                            seed_salt: int = 0x515C, exact_nee: bool = True):
    """Single-scattering BSSRDF term (src/subsurface/singlescatter.cpp,
    Jensen et al. 2001 eq. 12): refract the outgoing ray into the
    medium, sample a scatter depth s' ~ exp(sigma_t), connect to a
    light, attenuate by exp(-sigma_t (s' + s_i)) and both Fresnel
    transmittances.

    exact_nee=True (default) solves for the EXACT refracted connection
    point like the reference's Walter-style root finder
    (singlescatter.cpp): the interface is taken as the local tangent
    plane at the entry point, the Snell root is found by bisection
    (_refracted_connection — exact for flat interfaces), and the
    area-to-solid-angle Jacobian of the bent path comes from implicit
    differentiation of the Snell condition (bisection's own derivative
    is zero). Per-sample fallbacks to Jensen's classical straight-ray
    approximation cover env/delta lights, lights below the interface,
    and points where the real boundary departs >10% from the tangent
    plane (curved surfaces — documented approximation)."""
    n = query_p.shape[0]
    eta = params.eta
    sigma_t = params.sigma_s + params.sigma_a
    sig_mean = jnp.mean(sigma_t)
    pid = jnp.arange(n, dtype=jnp.uint32)
    seed = jnp.uint32(cfg.seed ^ seed_salt)

    # refract wo into the medium (entering: eta_ti = 1/eta)
    ci = jnp.maximum(m.dot(wo_world, query_ns), 1e-4)
    ft_o, cos_t, _, _ = m.fresnel_dielectric(ci, jnp.asarray(eta))
    sin2_t = (1.0 / eta) ** 2 * jnp.maximum(1.0 - ci * ci, 0.0)
    cos_in = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    # transmitted direction (into the surface)
    perp = m.normalize(wo_world - query_ns * ci[:, None])
    w_t = -(perp * jnp.sqrt(sin2_t)[:, None] + query_ns * cos_in[:, None])

    L = jnp.zeros((n, 3))
    for k in range(n_samples):
        def u(j):
            return uniform(seed, pid, jnp.uint32(k), j)

        s_prime = -jnp.log(jnp.maximum(1.0 - u(0), 1e-20)) / sig_mean
        pdf_s = sig_mean * jnp.exp(-sig_mean * s_prime)
        x_s = query_p + w_t * s_prime[:, None]
        u3 = jnp.stack([u(1), u(2), u(3)], -1)
        ds = emitterlib.sample_direct(scene, x_s, u3)
        # --- classical straight-ray connection (fallback path) ----------
        its = trace.closest_hit(scene, x_s, ds.d)
        s_obs = jnp.where(its.valid, its.t, 0.0)
        cos_l = jnp.maximum(m.dot(ds.d, query_ns), 1e-4)
        denom = jnp.sqrt(jnp.maximum(
            1.0 - (1.0 / eta) ** 2 * (1.0 - cos_l * cos_l), 1e-6))
        s_in = s_obs * cos_l / denom
        ft_i, _, _, _ = m.fresnel_dielectric(cos_l, jnp.asarray(eta))
        exit_p = x_s + ds.d * (s_obs + 1e-3)[:, None]
        blocked = trace.any_hit(scene, exit_p, ds.d,
                                jnp.maximum(ds.dist - s_obs, 1e-3))
        # isotropic-reduced phase (the reference defaults to HG(g); g is
        # folded into sigma_s' upstream)
        phase = 1.0 / (4.0 * jnp.pi)
        atten = jnp.exp(-sigma_t[None, :] * (s_prime + s_in)[:, None])
        w = (params.sigma_s[None, :] * phase * atten
             * ((1.0 - ft_i) * (1.0 - ft_o)
                * m.safe_div(1.0, pdf_s * jnp.maximum(ds.pdf, 1e-12)))[:, None])
        ok = (ds.pdf > 0) & ~blocked & its.valid
        contrib = jnp.where(ok[:, None], w * ds.radiance, 0.0)

        if exact_nee:
            contrib_e, ok_e = _exact_nee_contrib(
                params, scene, query_p, query_ns, x_s, ds, s_prime,
                pdf_s, ft_o, sigma_t, eta)
            contrib = jnp.where(ok_e[:, None], contrib_e, contrib)
        L = L + contrib
    return L / n_samples


def _exact_nee_contrib(params, scene, query_p, query_ns, x_s, ds,
                       s_prime, pdf_s, ft_o, sigma_t, eta):
    """Exact refracted-connection NEE contribution for area-light
    samples (see single_scatter_radiance docstring). Returns
    (contrib (N,3), valid (N,))."""
    nrm = query_ns
    y = x_s + ds.d * ds.dist[:, None]
    h = jnp.sum((query_p - x_s) * nrm, -1)
    H = jnp.sum((y - query_p) * nrm, -1)
    rel = y - x_s
    vxy = rel - jnp.sum(rel * nrm, -1, keepdims=True) * nrm
    d_xy = jnp.linalg.norm(vxy, axis=-1)
    what = vxy / jnp.maximum(d_xy, 1e-12)[:, None]
    h_s = jnp.maximum(h, 1e-5)
    H_s = jnp.maximum(H, 1e-5)
    r, dfdr = _refracted_connection(eta, h_s, H_s, d_xy)
    s_i = jnp.sqrt(r * r + h_s * h_s)
    q = d_xy - r
    s_o = jnp.sqrt(q * q + H_s * H_s)
    cos_o = H_s / s_o
    x_e = x_s + what * r[:, None] + nrm * h_s[:, None]
    w_in = (x_e - x_s) / jnp.maximum(s_i, 1e-9)[:, None]
    w_out = (y - x_e) / jnp.maximum(s_o, 1e-9)[:, None]

    # the real boundary along the bent inside leg must sit close to the
    # tangent plane, else fall back to the classical estimate
    its_b = trace.closest_hit(scene, x_s, w_in)
    planar_ok = its_b.valid & (jnp.abs(its_b.t - s_i)
                               < 0.1 * jnp.maximum(s_i, 1e-4))
    blocked = trace.any_hit(scene, x_e + nrm * 1e-3, w_out,
                            jnp.maximum(s_o - 2e-3, 1e-3))

    ft_e, _, _, _ = m.fresnel_dielectric(jnp.maximum(cos_o, 1e-4),
                                         jnp.asarray(eta))

    # Jacobian |d omega_in / dA_y| by implicit differentiation of the
    # Snell root: for a light-plane tangent t_k,
    #   df = df/d(d_xy) * dd_xy + df/dH * dH;  dr = -df / (df/dr)
    #   dx_e = what * dr + dwhat * r;  domega = P_perp(dx_e) / s_i
    denom3 = jnp.maximum((q * q + H_s * H_s) ** 1.5, 1e-20)
    df_ddxy = -(H_s * H_s) / denom3
    df_dH = q * H_s / denom3
    t1, t2 = m.coordinate_system(jnp.where(
        jnp.linalg.norm(ds.n_l, axis=-1, keepdims=True) > 0.5,
        ds.n_l, nrm))

    def dmega(tk):
        dH = jnp.sum(tk * nrm, -1)
        dvxy = tk - dH[:, None] * nrm
        dd_xy = jnp.sum(what * dvxy, -1)
        dwhat = (dvxy - what * dd_xy[:, None])             / jnp.maximum(d_xy, 1e-9)[:, None]
        dr = -(df_ddxy * dd_xy + df_dH * dH) / jnp.maximum(dfdr, 1e-12)
        dx_e = what * dr[:, None] + dwhat * r[:, None]
        dom = (dx_e - w_in * jnp.sum(w_in * dx_e, -1, keepdims=True))             / jnp.maximum(s_i, 1e-9)[:, None]
        return dom

    v1 = dmega(t1)
    v2 = dmega(t2)
    J = jnp.linalg.norm(jnp.cross(v1, v2), axis=-1)

    cos_ly = jnp.abs(jnp.sum(ds.d * ds.n_l, -1))
    p_area = ds.pdf * cos_ly / jnp.maximum(ds.dist * ds.dist, 1e-12)

    phase = 1.0 / (4.0 * jnp.pi)
    atten = jnp.exp(-sigma_t[None, :] * (s_prime + s_i)[:, None])
    contrib = (params.sigma_s[None, :] * phase * atten * ds.radiance
               * ((1.0 - ft_e) * (1.0 - ft_o) * J
                  * m.safe_div(1.0, pdf_s * jnp.maximum(p_area, 1e-14))
                  )[:, None])
    valid = (~ds.is_env & ~ds.is_delta & (ds.pdf > 0)
             & (H > 1e-4) & (h > 1e-5) & (cos_ly > 1e-4)
             & planar_ok & ~blocked & jnp.isfinite(J) & (J > 0))
    return contrib, valid
