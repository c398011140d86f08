"""Phase functions: isotropic, Henyey-Greenstein, Rayleigh, Kajiya-Kay,
and weighted mixtures.

Analog of src/phase/{isotropic,hg,rayleigh,kkay,
mixturephase}.cpp and the PhaseFunction interface
(include/mitsuba/render/phase.h:117,146-177).
Directions follow the flow convention: `wi` points toward the incoming
direction's origin (like BSDF wi), `wo` is the outgoing scatter direction;
HG's cos(theta) is taken between -wi and wo (forward scattering g > 0).
All functions are batched; g is per-lane so mixed media evaluate in one
pass with masks.

Parameterized kinds read a STATIC `params` tuple (carried on
Medium.phase_params, hashable so it jits as a compile-time constant):
  kkay:    (ax, ay, az, ks, kd, exponent) — constant fiber axis; the
           reference reads the axis from an orientation volume
           (kkay.cpp eval uses mRec.orientation); the constvolume case
           is what this covers, varying orientation volumes are not.
  mixture: (kind_a, weight_a, g_a, kind_b, weight_b, g_b) — a two-
           component mixture of the analytic kinds above
           (mixturephase.cpp with N=2; nesting disallowed there too).
  microflake: (ax, ay, az, stddev, norm, c1, sigma_t[16]) built by
           make_microflake_params — Gaussian-fiber flake distribution
           (microflake.cpp / Jakob et al. 2010) about a constant fiber
           axis. The directionally varying extinction sigmaDir is
           exposed via the sigma_t table; the distance sampler currently
           uses the isotropic sigma_t (documented approximation — the
           reference only varies it under heterogeneous media with
           orientation volumes, which carry per-voxel axes we don't).
"""
from __future__ import annotations

import math as pymath

import jax
import jax.numpy as jnp

from ..core import math as m

INV_FOURPI = 1.0 / (4.0 * jnp.pi)

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_KKAY = 3
PHASE_MIXTURE = 4
PHASE_MICROFLAKE = 5

_MF_TABLE_N = 16          # sigma_t(cos theta) lookup resolution


def hg_eval(g: jax.Array, cos_theta: jax.Array) -> jax.Array:
    """HG density (hg.cpp eval): p(cos) = (1-g^2) / (4pi (1+g^2-2g cos)^1.5)."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g2) / jnp.maximum(denom * jnp.sqrt(denom), 1e-12)


def rayleigh_eval(cos_theta: jax.Array) -> jax.Array:
    return (3.0 / (16.0 * jnp.pi)) * (1.0 + cos_theta * cos_theta)


def _kkay_norm(exponent: float) -> float:
    """1 / (2 pi Int_0^pi sin^(e+1) theta dtheta): the perpendicular-
    illumination normalization kkay.cpp computes by Simpson quadrature —
    here the closed form via the Wallis integral (Gamma functions)."""
    e = float(exponent)
    integral = (pymath.sqrt(pymath.pi) * pymath.gamma(0.5 * e + 1.0)
                / pymath.gamma(0.5 * e + 1.5))
    return 1.0 / (2.0 * pymath.pi * integral)


def kkay_eval(params, wi: jax.Array, wo: jax.Array,
              axis: jax.Array | None = None) -> jax.Array:
    """Kajiya-Kay fiber phase (kkay.cpp eval): diffuse kd/4pi plus a
    specular cone about the fiber axis — wo's component along the axis
    replaced by the mirrored -wi one, renormalized, raised to exponent.
    `axis` (per-lane, from an orientation volume — kkay.cpp reads
    mRec.orientation) overrides the static params axis."""
    ax, ay, az, ks, kd, exponent = params
    if axis is None:
        axis = m.normalize(jnp.asarray([ax, ay, az], jnp.float32))
    wo_par = m.dot(wo, axis)
    perp = wo - wo_par[..., None] * axis
    refl_par = -m.dot(wi, axis)
    a = jnp.sqrt(m.safe_div(1.0 - refl_par * refl_par,
                            jnp.maximum(m.dot(perp, perp), 1e-12)))
    r_vec = perp * a[..., None] + refl_par[..., None] * axis
    spec = jnp.maximum(m.dot(r_vec, wo), 0.0) ** exponent
    return spec * (_kkay_norm(exponent) * ks) + kd * INV_FOURPI


def make_microflake_params(stddev: float,
                           axis=(0.0, 0.0, 1.0)) -> tuple:
    """Build the static param tuple for the Gaussian-fiber micro-flake
    phase function (src/phase/microflake.cpp + microflake_fiber.h,
    Jakob et al. 2010 / Zhao et al. 2011).

    Flake normal density D(m) = norm * exp(-m_z^2 / (2 s^2)) in the
    fiber frame. Where the reference interpolates precomputed polynomial
    fits of the projected area sigma_t(cos theta) (fiberSigmaTCoeffs),
    this computes the integral directly by quadrature at construction —
    a 16-entry table linearly interpolated on device.
    """
    import math as pm

    import numpy as np

    s = float(stddev)
    if not (0.01 <= s <= 1.0):
        raise ValueError("microflake stddev must be in [0.01, 1]")
    erf = pm.erf(1.0 / (pm.sqrt(2.0) * s))
    norm = 1.0 / ((2.0 * pm.pi) ** 1.5 * s * erf)
    c1 = 1.0 / erf

    # sigma_t(cos theta_w) = Int_sphere D(m) |m . w| dm  (fiber frame,
    # azimuthally symmetric -> 1D family in theta_w)
    nq, nphi = 256, 256
    mu, wq = np.polynomial.legendre.leggauss(nq)       # m_z in (-1, 1)
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    sin_m = np.sqrt(np.maximum(1 - mu * mu, 0))
    d_density = norm * np.exp(-mu * mu / (2 * s * s))  # (nq,)
    table = []
    for i in range(_MF_TABLE_N):
        ct = i / (_MF_TABLE_N - 1)
        st = np.sqrt(max(1 - ct * ct, 0.0))
        # |m . w| for w = (st, 0, ct)
        dots = np.abs(sin_m[:, None] * np.cos(phi)[None, :] * st
                      + mu[:, None] * ct)
        integ = float(np.sum(wq[:, None] * d_density[:, None] * dots)
                      * (2 * np.pi / nphi))
        table.append(integ)
    ax = np.asarray(axis, np.float64)
    ax = ax / max(np.linalg.norm(ax), 1e-12)
    return (float(ax[0]), float(ax[1]), float(ax[2]),
            s, norm, c1, *table)


def _mf_sigma_t(params, cos_theta):
    """Linear interp of the projected-area table at |cos theta|."""
    tab = jnp.asarray(params[6:6 + _MF_TABLE_N], jnp.float32)
    x = jnp.abs(cos_theta) * (_MF_TABLE_N - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, _MF_TABLE_N - 2)
    f = x - i0
    return tab[i0] * (1.0 - f) + tab[i0 + 1] * f


def _microflake_eval(params, wi, wo, axis=None):
    """microflake.cpp eval: 0.5 D(cos theta_H) / sigma_t(cos theta_wi)
    in the fiber frame (this IS also the sampling pdf). `axis` (per-lane)
    overrides the static fiber axis (orientation volumes)."""
    s = params[3]
    norm = params[4]
    if axis is None:
        ax = m.normalize(jnp.asarray(params[0:3], jnp.float32))
        axis = jnp.broadcast_to(ax, wi.shape)
    wi_l = m.to_local(axis, wi)
    wo_l = m.to_local(axis, wo)
    h = wi_l + wo_l
    hlen = m.length(h)
    cos_h = m.safe_div(h[..., 2], jnp.maximum(hlen, 1e-9))
    d_h = norm * jnp.exp(-cos_h * cos_h / (2.0 * s * s))
    sig = jnp.maximum(_mf_sigma_t(params, wi_l[..., 2]), 1e-9)
    return jnp.where(hlen > 1e-9, 0.5 * d_h / sig, 0.0)


def _microflake_sample(params, wi, u2, n_tries: int = 16, axis=None):
    """Flake-normal sampling (microflake_fiber.h sample + the rejection
    loop of microflake.cpp:146-165, batch-shaped): cos theta_m inverts the
    longitudinal CDF in closed form via erfinv (the reference runs Brent),
    the |wi.m| rejection runs as n_tries parallel candidates with a
    first-accept select instead of a data-dependent loop."""
    from jax.scipy.special import erfinv

    s = params[3]
    c1 = params[5]
    if axis is None:
        ax = m.normalize(jnp.asarray(params[0:3], jnp.float32))
        axis = jnp.broadcast_to(ax, wi.shape)
    wi_l = m.to_local(axis, wi)

    shape = u2.shape[:-1]
    # derive n_tries independent (xi, phi, accept) triples from u2 by
    # counter-hash expansion (pure function of the two input uniforms)
    from ..core.rng import hash_u32, u32_to_uniform
    b0 = (u2[..., 0] * 16777216.0).astype(jnp.uint32)
    b1 = (u2[..., 1] * 16777216.0).astype(jnp.uint32)

    best_wo = jnp.zeros(shape + (3,))
    accepted = jnp.zeros(shape, bool)
    for t in range(n_tries):
        xi = u32_to_uniform(hash_u32(b0, b1, jnp.uint32(3 * t)))
        up = u32_to_uniform(hash_u32(b0, b1, jnp.uint32(3 * t + 1)))
        ua = u32_to_uniform(hash_u32(b0, b1, jnp.uint32(3 * t + 2)))
        arg = jnp.clip((1.0 - 2.0 * xi) / c1, -0.999999, 0.999999)
        ct = jnp.clip(jnp.sqrt(2.0) * s * erfinv(arg), -1.0, 1.0)
        st = m.safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * jnp.pi * up
        h = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], -1)
        dp = m.dot(wi_l, h)
        ok = (ua < jnp.abs(dp)) & ~accepted
        wo_l = h * (2.0 * dp)[..., None] - wi_l
        best_wo = jnp.where(ok[..., None], wo_l, best_wo)
        accepted = accepted | ok

    wo = m.to_world(axis, best_wo)
    pdf = jnp.where(accepted, _microflake_eval(params, wi, wo, axis), 0.0)
    return wo, pdf


def eval_pdf(kind: int, g: jax.Array, wi: jax.Array, wo: jax.Array,
             params: tuple = (), axis: jax.Array | None = None):
    """Returns (value, pdf) — equal for isotropic/HG (perfect importance
    sampling); Rayleigh is sampled exactly too (inversion of the cubic);
    kkay is sampled uniformly (kkay.cpp pdf), so value != pdf there."""
    ct = m.dot(-wi, wo)
    if kind == PHASE_ISOTROPIC:
        v = jnp.full(ct.shape, INV_FOURPI)
        return v, v
    if kind == PHASE_HG:
        v = hg_eval(g, ct)
        return v, v
    if kind == PHASE_RAYLEIGH:
        v = rayleigh_eval(ct)
        return v, v
    if kind == PHASE_KKAY:
        v = kkay_eval(params, wi, wo, axis)
        return v, jnp.full(ct.shape, INV_FOURPI)
    if kind == PHASE_MICROFLAKE:
        v = _microflake_eval(params, wi, wo, axis)
        return v, v
    if kind == PHASE_MIXTURE:
        ka, wa, ga, kb, wb, gb = params
        va, pa = eval_pdf(int(ka), jnp.float32(ga), wi, wo)
        vb, pb = eval_pdf(int(kb), jnp.float32(gb), wi, wo)
        wsum = wa + wb
        return va * wa + vb * wb, (pa * wa + pb * wb) / wsum
    raise ValueError(f"unknown phase kind {kind}")


def sample(kind: int, g: jax.Array, wi: jax.Array, u2: jax.Array,
           params: tuple = (), axis: jax.Array | None = None):
    """Sample wo ~ phase(-wi, .). Returns (wo, pdf). Weight is 1 for the
    exactly-sampled kinds; kkay/mixture callers must apply value/pdf
    (see sample_weight) — kkay is uniform-sphere sampled like kkay.cpp,
    a mixture samples one component and pdf-mixes over both."""
    if kind == PHASE_KKAY:
        z = 1.0 - 2.0 * u2[..., 0]
        r = m.safe_sqrt(1.0 - z * z)
        phi = 2.0 * jnp.pi * u2[..., 1]
        wo = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], -1)
        return wo, jnp.full(u2.shape[:-1], INV_FOURPI)
    if kind == PHASE_MICROFLAKE:
        return _microflake_sample(params, wi, u2, axis=axis)
    if kind == PHASE_MIXTURE:
        ka, wa, ga, kb, wb, gb = params
        p_a = wa / (wa + wb)
        pick_a = u2[..., 0] < p_a
        # reuse the selection number: conditionally rescaled, it is again
        # uniform on [0,1) (mixturephase.cpp uses a separate next1D)
        u0 = jnp.where(pick_a, u2[..., 0] / p_a,
                       (u2[..., 0] - p_a) / max(1.0 - p_a, 1e-9))
        u2r = jnp.stack([u0, u2[..., 1]], axis=-1)
        wo_a, _ = sample(int(ka), jnp.float32(ga), wi, u2r)
        wo_b, _ = sample(int(kb), jnp.float32(gb), wi, u2r)
        wo = jnp.where(pick_a[..., None], wo_a, wo_b)
        _, pdf = eval_pdf(kind, g, wi, wo, params)
        return wo, pdf
    if kind == PHASE_ISOTROPIC:
        z = 1.0 - 2.0 * u2[..., 0]
        r = m.safe_sqrt(1.0 - z * z)
        phi = 2.0 * jnp.pi * u2[..., 1]
        wo = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], -1)
        return wo, jnp.full(u2.shape[:-1], INV_FOURPI)
    if kind == PHASE_HG:
        # hg.cpp:sample — exact inversion; isotropic limit for |g| -> 0
        g_safe = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
        sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u2[..., 0])
        ct_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
        ct = jnp.where(jnp.abs(g) < 1e-4, 1.0 - 2.0 * u2[..., 0], ct_hg)
        ct = jnp.clip(ct, -1.0, 1.0)
        st = m.safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * jnp.pi * u2[..., 1]
        local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], -1)
        wo = m.to_world(-wi, local)
        return wo, hg_eval(g, ct)
    if kind == PHASE_RAYLEIGH:
        # rayleigh.cpp: solve cubic z^3 + 3z = 4(1-2u) via Cardano
        z = 2.0 * (2.0 * u2[..., 0] - 1.0)
        w_ = z + jnp.sqrt(z * z + 1.0)
        cbrt = jnp.sign(w_) * jnp.abs(w_) ** (1.0 / 3.0)
        ct = jnp.clip(cbrt - 1.0 / cbrt, -1.0, 1.0)
        st = m.safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * jnp.pi * u2[..., 1]
        local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], -1)
        wo = m.to_world(-wi, local)
        return wo, rayleigh_eval(ct)
    raise ValueError(f"unknown phase kind {kind}")


def sample_weight(kind: int, g: jax.Array, wi: jax.Array, wo: jax.Array,
                  pdf: jax.Array, params: tuple = (),
                  axis: jax.Array | None = None):
    """Throughput factor value/pdf for a direction drawn by sample().
    Statically 1 for the exactly-sampled kinds, so integrators pay the
    extra eval only when a kkay/mixture medium is actually present."""
    if kind in (PHASE_ISOTROPIC, PHASE_HG, PHASE_RAYLEIGH,
                PHASE_MICROFLAKE):
        # microflake: the flake-normal scheme samples the phase density
        # exactly (pdf == eval), so the weight is 1 (or 0 on the rare
        # all-rejected lane, which pdf=0 already kills)
        return jnp.ones(pdf.shape)
    v, _ = eval_pdf(kind, g, wi, wo, params, axis)
    return m.safe_div(v, jnp.maximum(pdf, 1e-12))
