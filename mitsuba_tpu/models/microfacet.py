"""Microfacet distributions (Beckmann + GGX), anisotropic, with Smith
shadowing and GGX visible-normal (VNDF) sampling.

Analog of the reference's MicrofacetDistribution
(src/bsdfs/microfacet.h: EBeckmann/EGGX, eval/sample/pdf/smithG1, the
sampleVisible=true path at microfacet.h:sampleVisible). All functions are
batched over local-frame directions; the distribution code is a per-ray
integer selected with masks (no divergence). Anisotropy follows
microfacet.h's (alphaU, alphaV) convention (tangent-frame x/y roughness).

Sampling policy: GGX uses Heitz's VNDF sampling (exact visible-normal
distribution — the reference's sampleVisible default); Beckmann uses
classic D*cos sampling (the reference's sampleVisible=false fallback;
Beckmann VNDF needs slope-space erf inversion with poor batched behavior).
`pdf` always matches whichever sampler `sample` uses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import warp

INV_PI = 1.0 / jnp.pi


def _split_alpha(alpha_u, alpha_v=None):
    au = jnp.maximum(alpha_u, 1e-4)
    av = au if alpha_v is None else jnp.maximum(alpha_v, 1e-4)
    # anisotropic only when av was actually provided and differs
    return au, jnp.where(av > 0, av, au)


def d_eval(dist: jax.Array, alpha_u, h: jax.Array,
           alpha_v=None) -> jax.Array:
    """Normal distribution function D(h). dist: 0=Beckmann, 1=GGX."""
    au, av = _split_alpha(alpha_u, alpha_v)
    ct = m.cos_theta(h)
    ct2 = ct * ct
    x2 = h[..., 0] * h[..., 0]
    y2 = h[..., 1] * h[..., 1]
    # clamp: at grazing h (ct ~ 1e-5) the Beckmann denominator's square
    # UNDERFLOWS f32 inside safe_div's derivative (den^2 ~ 1e-40 -> 0)
    # and the tangent becomes 0/0 = NaN even though the value is a clean
    # 0; with ct2 >= 1e-8 the value is still exp(-1e9) = 0 but the
    # adjoint stays finite (poisoned alpha gradients otherwise)
    ct2b = jnp.maximum(ct2, 1e-8)
    beck = m.safe_div(
        jnp.exp(-m.safe_div(x2 / (au * au) + y2 / (av * av), ct2b)),
        jnp.pi * au * av * ct2b * ct2b)
    root = x2 / (au * au) + y2 / (av * av) + ct2
    ggx = m.safe_div(1.0, jnp.pi * au * av * root * root)
    d = jnp.where(dist == 1, ggx, beck)
    return jnp.where(ct > 0.0, d, 0.0)


def _proj_alpha(au, av, v):
    """Projected roughness along v's azimuth (microfacet.h projectRoughness)."""
    inv_st2 = m.safe_div(1.0, jnp.maximum(1.0 - m.cos_theta(v) ** 2, 1e-12))
    c2 = v[..., 0] * v[..., 0] * inv_st2
    s2 = v[..., 1] * v[..., 1] * inv_st2
    iso = jnp.abs(1.0 - m.cos_theta(v) ** 2) < 1e-12
    a2 = jnp.where(iso, au * au, c2 * au * au + s2 * av * av)
    return jnp.sqrt(a2)


def smith_g1(dist: jax.Array, alpha_u, v: jax.Array, h: jax.Array,
             alpha_v=None) -> jax.Array:
    """Smith masking term G1(v, h) (microfacet.h:smithG1)."""
    au, av = _split_alpha(alpha_u, alpha_v)
    alpha = _proj_alpha(au, av, v)
    cv = m.cos_theta(v)
    # sidedness check: v must be on the same side as h
    chi = (m.dot(v, h) * cv) > 0.0
    # clamp: at grazing v, tan -> inf gives a CORRECT value (G1 -> 0)
    # but an INFINITE adjoint w.r.t. alpha (d(at2)/dalpha ~ alpha*inf^2),
    # which poisons roughness gradients through lanes that still pass
    # the cos>0 masks; 1e8 keeps at2 finite with G1 ~ 1e-8 there
    tan_t = jnp.minimum(jnp.abs(m.tan_theta(v)), 1e8)
    a = m.safe_div(1.0, alpha * tan_t)
    # Beckmann rational approximation (Walter et al.)
    beck = jnp.where(
        a < 1.6,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
        1.0,
    )
    at2 = (alpha * tan_t) ** 2
    ggx = 2.0 / (1.0 + jnp.sqrt(1.0 + at2))
    g = jnp.where(dist == 1, ggx, beck)
    g = jnp.where(tan_t < 1e-9, 1.0, g)
    return jnp.where(chi, g, 0.0)


def g_eval(dist, alpha_u, wi, wo, h, alpha_v=None):
    """Separable Smith G(wi, wo, h) = G1(wi) G1(wo) (microfacet.h:G)."""
    return (smith_g1(dist, alpha_u, wi, h, alpha_v)
            * smith_g1(dist, alpha_u, wo, h, alpha_v))


def _ggx_vndf_sample(au, av, wi, u):
    """Heitz 2018 'Sampling the GGX Distribution of Visible Normals':
    stretch wi into the hemisphere configuration, sample a disk point
    weighted by the projected area, unstretch. wi must have z > 0."""
    # transform to hemisphere configuration
    vh = m.normalize(jnp.stack(
        [au * wi[..., 0], av * wi[..., 1], wi[..., 2]], -1))
    # orthonormal basis around vh (stable when vh ~ +z)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 1e-12)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], -1)
        / jnp.sqrt(jnp.maximum(lensq, 1e-12))[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), vh.shape))
    t2 = jnp.cross(vh, t1)
    # parameterize projected area
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = (p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh)
    # unstretch
    h = m.normalize(jnp.stack(
        [au * nh[..., 0], av * nh[..., 1],
         jnp.maximum(nh[..., 2], 1e-6)], -1))
    return h


def sample(dist: jax.Array, alpha_u, wi: jax.Array, u: jax.Array,
           alpha_v=None):
    """Sample a microfacet normal; returns (h, pdf).

    GGX lanes: VNDF (visible normals of `wi`, which must be in the upper
    hemisphere — callers flip by sign(cos_i) first). Beckmann lanes:
    classic D*cos sampling.
    """
    au, av = _split_alpha(alpha_u, alpha_v)
    hb = _beckmann_sample_aniso(au, av, u)
    hg = _ggx_vndf_sample(au, av, wi, u)
    h = jnp.where((dist == 1)[..., None], hg, hb)
    return h, pdf(dist, alpha_u, wi, h, alpha_v)


def _beckmann_sample_aniso(au, av, u):
    """Anisotropic Beckmann D*cos sampling (microfacet.h sampleAll)."""
    phi_iso = 2.0 * jnp.pi * u[..., 1]
    # anisotropic azimuth warp: tan(phi') = (av/au) tan(phi)
    phi = jnp.arctan2(av * jnp.sin(phi_iso), au * jnp.cos(phi_iso))
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    a2 = m.safe_div(1.0, (cp / au) ** 2 + (sp / av) ** 2)
    t2 = -a2 * jnp.log(jnp.maximum(1.0 - u[..., 0], 1e-20))
    ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = m.safe_sqrt(1.0 - ct * ct)
    return jnp.stack([st * cp, st * sp, ct], -1)


def pdf(dist: jax.Array, alpha_u, wi: jax.Array, h: jax.Array,
        alpha_v=None) -> jax.Array:
    """pdf of `sample` in solid angle of h: VNDF pdf for GGX
    (G1(wi) D(h) |wi.h| / |cos_i|), D(h) cos(h) for Beckmann."""
    d = d_eval(dist, alpha_u, h, alpha_v)
    ci = jnp.abs(m.cos_theta(wi))
    vndf = m.safe_div(
        smith_g1(dist, alpha_u, wi, h, alpha_v) * d
        * jnp.abs(m.dot(wi, h)), ci)
    dcos = d * jnp.maximum(m.cos_theta(h), 0.0)
    return jnp.where(dist == 1, vndf, dcos)
