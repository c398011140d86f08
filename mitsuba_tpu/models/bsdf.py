"""BSDF framework: masked SIMD dispatch over material families.

Replacement for the reference's BSDF plugin hierarchy
(include/mitsuba/render/bsdf.h:215, sample/eval/pdf at bsdf.h:369-440 and
src/bsdfs/*): instead of virtual dispatch per intersection, every ray batch
gathers its material record into a ShadePoint SoA and each BSDF *family
present in the scene* is evaluated for all rays, with lane masks selecting
the right result. The set of families is static per scene
(`scene.bsdf_families`), so XLA compiles only the code actually needed.

Conventions (match the reference so renders are comparable):
  * Directions in the local shading frame, z = shading normal.
  * `wi` points toward the viewer, `wo` toward the light/next vertex.
  * eval() returns f(wi,wo) * |cos_theta_o| (bsdf.h:398 ERadiance measure).
  * pdf() is in solid angle; delta lobes report pdf=0 / eval=0 and are only
    reachable through sample() (bsdf.h:224-280 EDeltaReflection semantics).
  * sample() returns (wo, weight = f*cos/pdf, pdf, is_delta).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import warp
from ..scene import ir
from . import microfacet as mf

INV_PI = 1.0 / jnp.pi


class ShadePoint(NamedTuple):
    """Per-ray gathered material record (SoA)."""

    type: jax.Array          # (N,) int32
    reflectance: jax.Array   # (N,3) texture-resolved
    specular: jax.Array      # (N,3)
    eta: jax.Array           # (N,3)
    k: jax.Array             # (N,3)
    alpha: jax.Array         # (N,2)
    extra: jax.Array         # (N,4)
    # one-level nested child record (coating adapters); None unless the
    # scene contains BSDF_COATING rows
    nested: "ShadePoint | None" = None


def gather_shade_point(scene, mat: jax.Array, uv: jax.Array,
                       u_blend=None, aux=None) -> ShadePoint:
    """Gather material rows for each ray; resolve reflectance textures.
    One packed row gather (ops/gather.py) fetches every material field.

    Blend/mixture adapters (src/bsdfs/{blendbsdf,mixturebsdf}.cpp) resolve
    stochastically here: a BLEND row redirects to child A with probability
    extra[0] (else child B) using `u_blend`; the chosen child's record is
    then dispatched normally. Unbiased — the selection probability cancels
    against the mixture weight in expectation."""
    from . import texture as tex
    from ..ops.gather import fetch_packed

    mats = scene.materials
    if int(jnp.ndim(mat)) and ir.BSDF_BLEND in scene.bsdf_families:
        is_blend = mats.type[mat] == ir.BSDF_BLEND
        wgt = mats.extra[mat, 0]
        # textured blend weight = mask.cpp's textured opacity: the blend
        # row's tex_reflectance slot (unused otherwise) holds the map
        btex = jnp.where(is_blend, mats.tex_reflectance[mat], -1)
        if scene.textures.shape[0] > 1 or scene.textures.shape[1] > 1:
            wtex = tex.resolve(scene, btex, uv,
                               jnp.broadcast_to(wgt[..., None],
                                                (*wgt.shape, 3)))
            wgt = jnp.mean(wtex, axis=-1)
        pick = (u_blend if u_blend is not None
                else jnp.full(mat.shape, 0.5)) < wgt
        child = jnp.where(pick, mats.nested[mat, 0], mats.nested[mat, 1])
        mat = jnp.where(is_blend, jnp.maximum(child, 0), mat)
    (typef, refl, spec, eta, kk, alpha, extra, texf) = fetch_packed(
        [
            mats.type[:, None].astype(jnp.float32),
            mats.reflectance,
            mats.specular,
            mats.eta,
            mats.k,
            mats.alpha,
            mats.extra,
            mats.tex_reflectance[:, None].astype(jnp.float32),
        ],
        mat,
    )
    tex_id = jnp.round(texf[:, 0]).astype(jnp.int32)
    footprint = aux.get("footprint") if aux is not None else None
    duvdx = aux.get("duvdx") if aux is not None else None
    duvdy = aux.get("duvdy") if aux is not None else None
    refl = tex.resolve(scene, tex_id, uv, refl, footprint=footprint,
                       duvdx=duvdx, duvdy=duvdy)
    # procedural per-interaction textures, interpolated by
    # surface_interaction and handed through `aux` (the si dict);
    # bidirectional caches that don't carry them fall back to the flat
    # color (documented approximation)
    if aux is not None and scene.has_vtx_colors and "vcolor" in aux:
        refl = jnp.where((tex_id == ir.TEX_VERTEXCOLOR)[..., None],
                         aux["vcolor"], refl)
    if aux is not None and scene.has_wireframe and "wirecolor" in aux:
        refl = jnp.where((tex_id == ir.TEX_WIREFRAME)[..., None],
                         aux["wirecolor"], refl)
    nested_sp = None
    if int(jnp.ndim(mat)) and ir.BSDF_COATING in scene.bsdf_families:
        # one-level child gather for coating adapters (coating.cpp m_nested)
        child = jnp.maximum(mats.nested[mat, 0], 0)
        (ntypef, nrefl, nspec, neta, nkk, nalpha, nextra, ntexf) = fetch_packed(
            [
                mats.type[:, None].astype(jnp.float32),
                mats.reflectance,
                mats.specular,
                mats.eta,
                mats.k,
                mats.alpha,
                mats.extra,
                mats.tex_reflectance[:, None].astype(jnp.float32),
            ],
            child,
        )
        ntex_id = jnp.round(ntexf[:, 0]).astype(jnp.int32)
        nrefl = tex.resolve(scene, ntex_id, uv, nrefl)
        nested_sp = ShadePoint(
            type=jnp.round(ntypef[:, 0]).astype(jnp.int32),
            reflectance=nrefl, specular=nspec, eta=neta, k=nkk,
            alpha=nalpha, extra=nextra,
        )
    types = jnp.round(typef[:, 0]).astype(jnp.int32)
    if (int(jnp.ndim(mat)) and ir.BSDF_IRAWAN in scene.bsdf_families
            and scene.cloth is not None):
        # woven-cloth lanes: uv -> yarn-segment lookup packs the irawan
        # parameters into the generic fields (models/cloth.py gather_yarn)
        from . import cloth as clothlib
        over = clothlib.gather_yarn(scene.cloth, mat, uv)
        is_cloth = (types == ir.BSDF_IRAWAN)[:, None]
        refl = jnp.where(is_cloth, over["reflectance"], refl)
        spec = jnp.where(is_cloth, over["specular"], spec)
        eta = jnp.where(is_cloth, over["eta"], eta)
        kk = jnp.where(is_cloth, over["k"], kk)
        alpha = jnp.where(is_cloth, over["alpha"], alpha)
        extra = jnp.where(is_cloth, over["extra"], extra)
    return ShadePoint(
        type=types,
        reflectance=refl,
        specular=spec,
        eta=eta,
        k=kk,
        alpha=alpha,
        extra=extra,
        nested=nested_sp,
    )


# ---------------------------------------------------------------------------
# Family implementations. Each returns (f_cos (N,3), pdf (N,)) for eval and
# (wo, weight, pdf, is_delta) for sample. Invalid configurations yield zeros.
# ---------------------------------------------------------------------------

def _both_sides_pos(wi, wo):
    return (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)


def _diffuse_eval(sp, wi, wo):
    """src/bsdfs/diffuse.cpp (smooth diffuse)."""
    ok = _both_sides_pos(wi, wo)
    f = sp.reflectance * (INV_PI * jnp.maximum(m.cos_theta(wo), 0.0))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _diffuse_sample(sp, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    ok = m.cos_theta(wi) > 0.0
    weight = jnp.where(ok[..., None], sp.reflectance, 0.0)
    pdf = jnp.where(ok, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)
    return wo, weight, pdf, jnp.zeros_like(ok)


def _diffuse_transmitter_eval(sp, wi, wo):
    """src/bsdfs/difftrans.cpp — diffuse transmission to the other side."""
    ok = (m.cos_theta(wi) * m.cos_theta(wo)) < 0.0
    f = sp.reflectance * (INV_PI * m.abs_cos_theta(wo))[..., None]
    pdf = INV_PI * m.abs_cos_theta(wo)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _diffuse_transmitter_sample(sp, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    sign = jnp.where(m.cos_theta(wi) > 0.0, -1.0, 1.0)
    wo = wo * jnp.stack([jnp.ones_like(sign), jnp.ones_like(sign), sign], -1)
    pdf = INV_PI * m.abs_cos_theta(wo)
    return wo, sp.reflectance, pdf, jnp.zeros(wi.shape[:-1], bool)


def _safe_half(v):
    """Half-vector with a degenerate guard: wi + wo can be the zero
    vector on masked lanes (wo = -wi at grazing/backside NEE samples);
    normalize(0) = 0/0 would be a NaN PRIMAL there, and even though the
    lane's output is where()-masked, reverse-mode evaluates the
    d(microfacet)/d(alpha) chain AT that NaN and 0 * NaN poisons the
    alpha gradients. Degenerate lanes get +z (their f/pdf are masked)."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    ok = n2 > 1e-18
    safe = v * jax.lax.rsqrt(jnp.where(ok, n2, 1.0))
    z = jnp.zeros_like(v).at[..., 2].set(1.0)
    return jnp.where(ok, safe, z)


def _conductor_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/conductor.cpp — smooth mirror with conductor Fresnel."""
    wo = m.reflect_local(wi)
    ci = m.cos_theta(wi)
    f = m.fresnel_conductor(ci, sp.eta, sp.k) * sp.specular
    ok = ci > 0.0
    weight = jnp.where(ok[..., None], f, 0.0)
    return wo, weight, jnp.where(ok, 1.0, 0.0), jnp.ones_like(ok)


def _rough_conductor_eval(sp, wi, wo):
    """src/bsdfs/roughconductor.cpp eval/pdf (anisotropic alphaU/alphaV,
    GGX lanes pdf-matched to VNDF sampling)."""
    ok = _both_sides_pos(wi, wo)
    h = _safe_half(wi + wo)
    dist = sp.extra[..., 3].astype(jnp.int32)
    au, av = sp.alpha[..., 0], sp.alpha[..., 1]
    d = mf.d_eval(dist, au, h, av)
    g = mf.g_eval(dist, au, wi, wo, h, av)
    fr = m.fresnel_conductor(m.dot(wi, h), sp.eta, sp.k) * sp.specular
    ci = jnp.maximum(m.cos_theta(wi), 1e-8)
    f_cos = fr * (d * g / (4.0 * ci))[..., None]
    pdf = m.safe_div(mf.pdf(dist, au, wi, h, av), 4.0 * jnp.abs(m.dot(wo, h)))
    return (
        jnp.where(ok[..., None], f_cos, 0.0),
        jnp.where(ok, pdf, 0.0),
    )


def _rough_conductor_sample(sp, wi, u_lobe, u2):
    dist = sp.extra[..., 3].astype(jnp.int32)
    au, av = sp.alpha[..., 0], sp.alpha[..., 1]
    h, _ = mf.sample(dist, au, wi, u2, av)
    wo = 2.0 * m.dot(wi, h, keepdims=True) * h - wi
    f_cos, pdf = _rough_conductor_eval(sp, wi, wo)
    weight = m.safe_div(f_cos, pdf[..., None])
    ok = (pdf > 1e-12) & (m.cos_theta(wi) > 0.0)
    return (
        wo,
        jnp.where(ok[..., None], weight, 0.0),
        jnp.where(ok, pdf, 0.0),
        jnp.zeros_like(ok),
    )


def _dielectric_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/dielectric.cpp — smooth dielectric, two delta lobes.

    Radiance transport: transmission carries the 1/eta^2 scaling
    (dielectric.cpp:241, 'radiance compression').
    """
    eta = sp.eta[..., 0]
    ci = m.cos_theta(wi)
    fr, cos_t, eta_it, eta_ti = m.fresnel_dielectric(ci, eta)
    pick_reflect = u_lobe <= fr
    wo_r = m.reflect_local(wi)
    wo_t = m.refract_local(wi, eta, cos_t)
    wo = jnp.where(pick_reflect[..., None], wo_r, wo_t)
    w_r = sp.specular            # specular reflectance tint
    w_t = sp.reflectance * (eta_ti * eta_ti)[..., None]  # transmittance tint
    weight = jnp.where(pick_reflect[..., None], w_r, w_t)
    pdf = jnp.where(pick_reflect, fr, 1.0 - fr)
    return wo, weight, pdf, jnp.ones_like(pick_reflect)


def _thin_dielectric_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/thindielectric.cpp — thin slab: R' = 2R/(1+R), pass-through."""
    eta = sp.eta[..., 0]
    ci = m.cos_theta(wi)
    fr, _, _, _ = m.fresnel_dielectric(jnp.abs(ci), eta)
    fr = m.safe_div(2.0 * fr, 1.0 + fr)
    pick_reflect = u_lobe <= fr
    wo = jnp.where(pick_reflect[..., None], m.reflect_local(wi), -wi)
    weight = jnp.where(pick_reflect[..., None], sp.specular, sp.reflectance)
    pdf = jnp.where(pick_reflect, fr, 1.0 - fr)
    return wo, weight, pdf, jnp.ones_like(pick_reflect)


def _plastic_fdr(sp):
    return m.fresnel_diffuse_reflectance(1.0 / sp.eta[..., 0])


def _plastic_spec_prob(sp, wi):
    """Specular selection probability (plastic.cpp specularSamplingWeight)."""
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), sp.eta[..., 0])
    return jnp.clip(fi, 0.05, 0.95)


def _plastic_eval(sp, wi, wo):
    """src/bsdfs/plastic.cpp — smooth plastic: delta coat + internal diffuse.

    eval covers only the diffuse component (the coat is delta);
    nonlinear internal-scattering compensation per plastic.cpp:142-170.
    """
    ok = _both_sides_pos(wi, wo)
    eta = sp.eta[..., 0]
    fi, _, _, eta_ti_i = m.fresnel_dielectric(m.cos_theta(wi), eta)
    fo, _, _, _ = m.fresnel_dielectric(m.cos_theta(wo), eta)
    fdr = _plastic_fdr(sp)
    refl = sp.reflectance
    denom = 1.0 - refl * fdr[..., None]
    inv_eta2 = (1.0 / eta) ** 2
    f = (
        refl / jnp.maximum(denom, 1e-6)
        * ((1.0 - fi) * (1.0 - fo) * inv_eta2 * INV_PI * jnp.maximum(m.cos_theta(wo), 0.0))[..., None]
    )
    spec_p = _plastic_spec_prob(sp, wi)
    pdf = (1.0 - spec_p) * warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _plastic_sample(sp, wi, u_lobe, u2):
    spec_p = _plastic_spec_prob(sp, wi)
    pick_spec = u_lobe <= spec_p
    # specular branch
    wo_s = m.reflect_local(wi)
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), sp.eta[..., 0])
    w_s = sp.specular * m.safe_div(fi, spec_p)[..., None]
    # diffuse branch
    wo_d = warp.square_to_cosine_hemisphere(u2)
    f_d, pdf_d = _plastic_eval(sp, wi, wo_d)
    w_d = m.safe_div(f_d, pdf_d[..., None])
    wo = jnp.where(pick_spec[..., None], wo_s, wo_d)
    weight = jnp.where(pick_spec[..., None], w_s, w_d)
    pdf = jnp.where(pick_spec, spec_p, pdf_d)
    ok = m.cos_theta(wi) > 0.0
    return (
        wo,
        jnp.where(ok[..., None], weight, 0.0),
        jnp.where(ok, pdf, 0.0),
        pick_spec,
    )


def _phong_eval(sp, wi, wo):
    """src/bsdfs/phong.cpp — modified Phong (diffuse + cos^n specular lobe)."""
    ok = _both_sides_pos(wi, wo)
    exponent = sp.extra[..., 0]
    refl_r = m.reflect_local(wi)
    cos_a = jnp.maximum(m.dot(refl_r, wo), 0.0)
    spec = sp.specular * ((exponent + 2.0) * INV_PI * 0.5 * jnp.power(cos_a, exponent))[..., None]
    diff = sp.reflectance * INV_PI
    f_cos = (diff + spec) * jnp.maximum(m.cos_theta(wo), 0.0)[..., None]
    # pdf mixes the two lobes by their sampling weights
    kd = jnp.mean(sp.reflectance, -1)
    ks = jnp.mean(sp.specular, -1)
    w_spec = m.safe_div(ks, kd + ks)
    pdf = (
        w_spec * _phong_lobe_pdf(refl_r, wo, exponent)
        + (1.0 - w_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    )
    return jnp.where(ok[..., None], f_cos, 0.0), jnp.where(ok, pdf, 0.0)


def _phong_lobe_pdf(axis, wo, exponent):
    cos_a = jnp.maximum(m.dot(axis, wo), 0.0)
    return (exponent + 1.0) * (0.5 * INV_PI) * jnp.power(cos_a, exponent)


def _phong_sample(sp, wi, u_lobe, u2):
    exponent = sp.extra[..., 0]
    kd = jnp.mean(sp.reflectance, -1)
    ks = jnp.mean(sp.specular, -1)
    w_spec = m.safe_div(ks, kd + ks)
    pick_spec = u_lobe <= w_spec
    refl_r = m.reflect_local(wi)
    # sample around reflected direction with cos^(n+1) lobe
    local = _sample_phong_lobe(u2, exponent)
    wo_s = m.to_world(refl_r, local)
    wo_d = warp.square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_spec[..., None], wo_s, wo_d)
    f_cos, pdf = _phong_eval(sp, wi, wo)
    weight = m.safe_div(f_cos, pdf[..., None])
    ok = (pdf > 1e-12) & (m.cos_theta(wo) > 0.0) & (m.cos_theta(wi) > 0.0)
    return (
        wo,
        jnp.where(ok[..., None], weight, 0.0),
        jnp.where(ok, pdf, 0.0),
        jnp.zeros_like(ok),
    )


def _sample_phong_lobe(u2, exponent):
    ct = jnp.power(jnp.maximum(u2[..., 0], 1e-20), 1.0 / (exponent + 1.0))
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * jnp.pi * u2[..., 1]
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def _rough_diffuse_eval(sp, wi, wo):
    """src/bsdfs/roughdiffuse.cpp — Oren-Nayar (qualitative fast variant)."""
    ok = _both_sides_pos(wi, wo)
    sigma = sp.alpha[..., 0] * (jnp.pi / 2.0) * 0.7978845608  # conversion per roughdiffuse.cpp
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    si, so = m.sin_theta(wi), m.sin_theta(wo)
    cos_dphi = jnp.clip(
        m.cos_phi(wi) * m.cos_phi(wo) + m.sin_phi(wi) * m.sin_phi(wo), -1.0, 1.0
    )
    sin_alpha = jnp.where(ci > co, so, si)
    tan_beta = jnp.where(ci > co, m.safe_div(si, ci), m.safe_div(so, co))
    f = sp.reflectance * (
        INV_PI * jnp.maximum(co, 0.0)
        * (a + b * jnp.maximum(cos_dphi, 0.0) * sin_alpha * tan_beta)
    )[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _rough_diffuse_sample(sp, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    f_cos, pdf = _rough_diffuse_eval(sp, wi, wo)
    weight = m.safe_div(f_cos, pdf[..., None])
    ok = pdf > 1e-12
    return wo, jnp.where(ok[..., None], weight, 0.0), pdf, jnp.zeros_like(ok)


def _rough_dielectric_eval(sp, wi, wo):
    """src/bsdfs/roughdielectric.cpp eval/pdf: microfacet reflection AND
    refraction lobes (Walter et al. 2007), radiance transport (the 1/eta^2
    compression matches the smooth dielectric's convention)."""
    eta = sp.eta[..., 0]
    dist = sp.extra[..., 3].astype(jnp.int32)
    alpha = sp.alpha[..., 0]
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    reflect = ci * co > 0.0
    eta_it = jnp.where(ci >= 0, eta, 1.0 / eta)

    # half vectors (Walter eq. 13/16), oriented to the +z hemisphere
    h_r = _safe_half(wi + wo)
    h_t = _safe_half(-(wi + wo * eta_it[..., None]))
    h = jnp.where(reflect[..., None], h_r, h_t)
    h = h * jnp.sign(m.cos_theta(h) + 1e-20)[..., None]

    wi_up = wi * jnp.sign(ci)[..., None]
    d_h = mf.d_eval(dist, alpha, h)
    g = mf.g_eval(dist, alpha, wi_up, wo * jnp.sign(co)[..., None], h)
    wi_dot_h = m.dot(wi, h)
    wo_dot_h = m.dot(wo, h)
    fr, _, _, _ = m.fresnel_dielectric(wi_dot_h, eta)

    # eval convention: return f * |cos_o|
    val_r = fr * d_h * g / jnp.maximum(4.0 * jnp.abs(ci), 1e-8)
    sqrt_denom = wi_dot_h + eta_it * wo_dot_h
    val_t = (
        (1.0 - fr) * d_h * g * jnp.abs(wi_dot_h * wo_dot_h)
        / jnp.maximum(jnp.abs(ci) * sqrt_denom * sqrt_denom, 1e-10)
    )
    tint = jnp.where(reflect[..., None], sp.specular, sp.reflectance)
    f_cos = tint * jnp.where(reflect, val_r, val_t)[..., None]

    pdf_h = mf.pdf(dist, alpha, wi_up, h)
    jac_r = m.safe_div(1.0, 4.0 * jnp.abs(wo_dot_h))
    jac_t = m.safe_div(
        (eta_it * eta_it) * jnp.abs(wo_dot_h), sqrt_denom * sqrt_denom
    )
    pdf = jnp.where(reflect, pdf_h * jac_r * fr, pdf_h * jac_t * (1.0 - fr))
    # Walter's chi+ side consistency: each direction must lie on the same
    # side of the microfacet as of the macro surface, else the sampler can
    # never produce this configuration and the pdf must be 0
    side_ok = ((wi_dot_h * jnp.sign(ci) > 0.0)
               & (wo_dot_h * jnp.sign(co) > 0.0))
    ok = (d_h > 0.0) & (jnp.abs(ci) > 1e-8) & side_ok
    return jnp.where(ok[..., None], f_cos, 0.0), jnp.where(ok, pdf, 0.0)


def _rough_dielectric_sample(sp, wi, u_lobe, u2):
    eta = sp.eta[..., 0]
    dist = sp.extra[..., 3].astype(jnp.int32)
    alpha = sp.alpha[..., 0]
    wi_up = wi * jnp.sign(m.cos_theta(wi))[..., None]
    h, _ = mf.sample(dist, alpha, wi_up, u2)
    wi_dot_h = m.dot(wi, h)
    fr, _, _, eta_ti = m.fresnel_dielectric(wi_dot_h, eta)
    pick_reflect = u_lobe <= fr
    wo_r = 2.0 * wi_dot_h[..., None] * h - wi
    # refraction about h (Walter eq. 40)
    c = wi_dot_h
    root = jnp.sqrt(jnp.maximum(
        1.0 + eta_ti * eta_ti * (c * c - 1.0), 0.0
    ))
    wo_t = (eta_ti * c - jnp.sign(c) * root)[..., None] * h \
        - eta_ti[..., None] * wi
    wo = jnp.where(pick_reflect[..., None], wo_r, wo_t)
    f_cos, pdf = _rough_dielectric_eval(sp, wi, wo)
    # reject side-mismatched outputs (a "reflection" off a grazing
    # microfacet can land below the horizon — Walter et al. discard these)
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    side_ok = jnp.where(pick_reflect, ci * co > 0.0, ci * co < 0.0)
    # clamp pathological weights from grazing microfacets (reference clamps
    # via its sampleVisible path; we use D-sampling, so guard here)
    weight = jnp.clip(m.safe_div(f_cos, pdf[..., None]), 0.0, 4.0)
    ok = (pdf > 1e-10) & side_ok
    return (wo, jnp.where(ok[..., None], weight, 0.0),
            jnp.where(ok, pdf, 0.0), jnp.zeros_like(ok))


def _rough_plastic_eval(sp, wi, wo):
    """src/bsdfs/roughplastic.cpp: microfacet coat + internal diffuse."""
    ok = _both_sides_pos(wi, wo)
    dist = sp.extra[..., 3].astype(jnp.int32)
    alpha = sp.alpha[..., 0]
    eta = sp.eta[..., 0]
    # specular microfacet lobe (already includes the 1/cos_o, so the eval
    # convention f*|cos_o| gives F D G / (4 ci))
    h = _safe_half(wi + wo)
    d_h = mf.d_eval(dist, alpha, h)
    g = mf.g_eval(dist, alpha, wi, wo, h)
    fr_h, _, _, _ = m.fresnel_dielectric(m.dot(wi, h), eta)
    spec_cos = sp.specular * (
        fr_h * d_h * g / jnp.maximum(4.0 * m.cos_theta(wi), 1e-8)
    )[..., None]
    pdf_h = mf.pdf(dist, alpha, wi, h)
    # diffuse lobe with internal scattering compensation (plastic.cpp)
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), eta)
    fo, _, _, _ = m.fresnel_dielectric(m.cos_theta(wo), eta)
    fdr = _plastic_fdr(sp)
    refl = sp.reflectance
    denom = 1.0 - refl * fdr[..., None]
    inv_eta2 = (1.0 / eta) ** 2
    diff_cos = refl / jnp.maximum(denom, 1e-6) * (
        (1.0 - fi) * (1.0 - fo) * inv_eta2 * INV_PI
        * jnp.maximum(m.cos_theta(wo), 0.0)
    )[..., None]
    f_cos = spec_cos + diff_cos
    # pdf mixes microfacet and cosine by the fresnel selection weight
    spec_p = jnp.clip(fi, 0.05, 0.95)
    pdf_spec = m.safe_div(pdf_h, 4.0 * jnp.abs(m.dot(wo, h)))
    pdf = spec_p * pdf_spec + (1.0 - spec_p) * warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok[..., None], f_cos, 0.0), jnp.where(ok, pdf, 0.0)


def _rough_plastic_sample(sp, wi, u_lobe, u2):
    dist = sp.extra[..., 3].astype(jnp.int32)
    alpha = sp.alpha[..., 0]
    eta = sp.eta[..., 0]
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), eta)
    spec_p = jnp.clip(fi, 0.05, 0.95)
    pick_spec = u_lobe <= spec_p
    h, _ = mf.sample(dist, alpha, wi, u2)
    wo_s = 2.0 * m.dot(wi, h, keepdims=True) * h - wi
    wo_d = warp.square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_spec[..., None], wo_s, wo_d)
    f_cos, pdf = _rough_plastic_eval(sp, wi, wo)
    weight = jnp.clip(m.safe_div(f_cos, pdf[..., None]), 0.0, 4.0)
    ok = (pdf > 1e-10) & (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return (wo, jnp.where(ok[..., None], weight, 0.0),
            jnp.where(ok, pdf, 0.0), jnp.zeros_like(ok))


def _ward_eval(sp, wi, wo):
    """src/bsdfs/ward.cpp (balanced variant): anisotropic Gaussian lobe +
    diffuse base."""
    ok = _both_sides_pos(wi, wo)
    ax = jnp.maximum(sp.alpha[..., 0], 1e-4)
    ay = jnp.maximum(sp.alpha[..., 1], 1e-4)
    h = wi + wo
    hn = m.normalize(h)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    exp_arg = -(
        (hn[..., 0] / ax) ** 2 + (hn[..., 1] / ay) ** 2
    ) / jnp.maximum(hn[..., 2] ** 2, 1e-8)
    spec_f = sp.specular * (
        jnp.exp(exp_arg)
        / jnp.maximum(4.0 * jnp.pi * ax * ay * jnp.sqrt(jnp.maximum(ci * co, 1e-8)), 1e-8)
    )[..., None]
    diff_f = sp.reflectance * INV_PI
    f_cos = (diff_f + spec_f) * jnp.maximum(co, 0.0)[..., None]
    # pdf: mix of cosine + ward half-vector sampling
    kd = jnp.mean(sp.reflectance, -1)
    ks = jnp.mean(sp.specular, -1)
    w_spec = m.safe_div(ks, kd + ks)
    # half-vector pdf: p(h) = exp/(pi ax ay cos^3), jacobian 1/(4 wo.h)
    p_h = m.safe_div(jnp.exp(exp_arg),
                     jnp.pi * ax * ay * jnp.maximum(hn[..., 2] ** 3, 1e-8))
    p_spec = m.safe_div(p_h, 4.0 * jnp.abs(m.dot(wo, hn)))
    pdf = w_spec * p_spec + (1.0 - w_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok[..., None], f_cos, 0.0), jnp.where(ok, pdf, 0.0)


def _ward_sample(sp, wi, u_lobe, u2):
    ax = jnp.maximum(sp.alpha[..., 0], 1e-4)
    ay = jnp.maximum(sp.alpha[..., 1], 1e-4)
    kd = jnp.mean(sp.reflectance, -1)
    ks = jnp.mean(sp.specular, -1)
    w_spec = m.safe_div(ks, kd + ks)
    pick_spec = u_lobe <= w_spec
    # sample anisotropic half vector (ward.cpp:sample)
    phi = jnp.arctan2(ay * jnp.sin(2 * jnp.pi * u2[..., 1]),
                      ax * jnp.cos(2 * jnp.pi * u2[..., 1]))
    cp, sp_ = jnp.cos(phi), jnp.sin(phi)
    t2 = -jnp.log(jnp.maximum(u2[..., 0], 1e-20)) / (
        (cp / ax) ** 2 + (sp_ / ay) ** 2
    )
    ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = m.safe_sqrt(1.0 - ct * ct)
    hv = jnp.stack([st * cp, st * sp_, ct], -1)
    wo_s = 2.0 * m.dot(wi, hv, keepdims=True) * hv - wi
    wo_d = warp.square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_spec[..., None], wo_s, wo_d)
    f_cos, pdf = _ward_eval(sp, wi, wo)
    weight = jnp.clip(m.safe_div(f_cos, pdf[..., None]), 0.0, 8.0)
    ok = (pdf > 1e-10) & (m.cos_theta(wo) > 0.0) & (m.cos_theta(wi) > 0.0)
    return (wo, jnp.where(ok[..., None], weight, 0.0),
            jnp.where(ok, pdf, 0.0), jnp.zeros_like(ok))


def _mask_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/mask.cpp: opacity in extra[0]; with prob (1-opacity) pass
    straight through (null), else behave as diffuse with `reflectance`.
    (General nested BSDFs compose via models/bsdf.py blend machinery.)"""
    opacity = jnp.clip(sp.extra[..., 0], 0.0, 1.0)
    pass_through = u_lobe > opacity
    # rescale u_lobe for the inner lobe decision
    wo_d, w_d, pdf_d, _ = _diffuse_sample(sp, wi, u_lobe / jnp.maximum(opacity, 1e-6), u2)
    wo = jnp.where(pass_through[..., None], -wi, wo_d)
    weight = jnp.where(pass_through[..., None], jnp.ones_like(w_d), w_d)
    pdf = jnp.where(pass_through, 1.0 - opacity, opacity * pdf_d)
    return wo, weight, pdf, pass_through


def _mask_eval(sp, wi, wo):
    opacity = jnp.clip(sp.extra[..., 0], 0.0, 1.0)
    f, pdf = _diffuse_eval(sp, wi, wo)
    return f * opacity[..., None], pdf * opacity


# ---------------------------------------------------------------------------
# Coating adapter (src/bsdfs/coating.cpp Weidlich-Wilkie smooth dielectric
# coat; src/bsdfs/roughcoating.cpp when alpha[0] > 0). The nested BSDF is a
# one-level child record gathered into sp.nested; the coat's eval/pdf/sample
# refract wi/wo through the dielectric interface and dispatch the nested
# family set with the bent directions. Record layout:
#   reflectance = sigmaA * thickness   (coat absorption optical depth)
#   specular    = specularReflectance  (coat tint)
#   eta[0]      = coating eta (int/ext)
#   alpha[0]    = coat roughness (0 = smooth delta coat)
#   extra[0]    = specularSamplingWeight (1/(avgAbsorption+1), coating.cpp
#                 configure())
#   extra[3]    = coat microfacet distribution code
# ---------------------------------------------------------------------------

def _coat_refract_in(wi, eta):
    """coating.cpp refractIn: bend into the layer, preserve hemisphere
    sign; returns (wi', R12). TIR lanes get z'=0 and R=1."""
    fr, cos_t, _, _ = m.fresnel_dielectric(jnp.abs(m.cos_theta(wi)), eta)
    inv_eta = 1.0 / eta
    sign = jnp.where(m.cos_theta(wi) >= 0.0, 1.0, -1.0)
    wip = jnp.stack([inv_eta * wi[..., 0], inv_eta * wi[..., 1],
                     sign * jnp.abs(cos_t)], -1)
    return wip, fr


def _coat_refract_out(wop, eta):
    """coating.cpp refractOut: bend out of the layer; returns (wo, R21)."""
    fr, cos_t, _, _ = m.fresnel_dielectric(
        jnp.abs(m.cos_theta(wop)), 1.0 / eta)
    sign = jnp.where(m.cos_theta(wop) >= 0.0, 1.0, -1.0)
    wo = jnp.stack([eta * wop[..., 0], eta * wop[..., 1],
                    sign * jnp.abs(cos_t)], -1)
    return wo, fr


def _coat_prob_specular(sp, r12):
    w_s = jnp.clip(sp.extra[..., 0], 1e-3, 1.0 - 1e-3)
    return jnp.clip(
        m.safe_div(r12 * w_s, r12 * w_s + (1.0 - r12) * (1.0 - w_s)),
        0.0, 1.0 - 1e-4)


def _coating_eval(sp, wi, wo, families):
    eta = sp.eta[..., 0]
    inv_eta = 1.0 / eta
    wip, r12 = _coat_refract_in(wi, eta)
    wop, r21 = _coat_refract_in(wo, eta)
    nested_fams = tuple(f for f in families if f != ir.BSDF_COATING)
    f_n, pdf_n = eval_pdf(sp.nested, wip, wop, nested_fams)
    aci_p = jnp.maximum(jnp.abs(m.cos_theta(wip)), 1e-6)
    aco_p = jnp.maximum(jnp.abs(m.cos_theta(wop)), 1e-6)
    absorb = jnp.exp(-sp.reflectance * (1.0 / aci_p + 1.0 / aco_p)[..., None])
    compression = inv_eta * inv_eta * m.safe_div(
        jnp.abs(m.cos_theta(wo)), aco_p)
    no_tir = (r12 < 1.0 - 1e-6) & (r21 < 1.0 - 1e-6)
    f = f_n * ((1.0 - r12) * (1.0 - r21) * compression)[..., None] * absorb
    prob_spec = _coat_prob_specular(sp, r12)
    pdf = pdf_n * compression * (1.0 - prob_spec)
    f = jnp.where(no_tir[..., None], f, 0.0)
    pdf = jnp.where(no_tir, pdf, 0.0)

    # glossy coat lobe for roughcoating lanes (alpha[0] > 0): microfacet
    # reflection with dielectric Fresnel (roughcoating.cpp eval)
    alpha_c = sp.alpha[..., 0]
    rough = alpha_c > 1e-5
    same_side = m.cos_theta(wi) * m.cos_theta(wo) > 0.0
    sgn = jnp.where(m.cos_theta(wi) >= 0.0, 1.0, -1.0)[..., None]
    wi_up, wo_up = wi * sgn, wo * sgn
    h = _safe_half(wi_up + wo_up)
    dist = sp.extra[..., 3].astype(jnp.int32)
    d_h = mf.d_eval(dist, alpha_c, h)
    g_h = mf.g_eval(dist, alpha_c, wi_up, wo_up, h)
    fr_h, _, _, _ = m.fresnel_dielectric(m.dot(wi_up, h), eta)
    f_coat = sp.specular * m.safe_div(
        fr_h * d_h * g_h, 4.0 * jnp.maximum(m.cos_theta(wi_up), 1e-6)
    )[..., None]
    pdf_coat = prob_spec * m.safe_div(
        mf.pdf(dist, alpha_c, wi_up, h), 4.0 * jnp.abs(m.dot(wo_up, h)))
    add = rough & same_side
    f = f + jnp.where(add[..., None], f_coat, 0.0)
    pdf = pdf + jnp.where(add, pdf_coat, 0.0)
    return f, pdf


def _coating_sample(sp, wi, u_lobe, u2, families):
    eta = sp.eta[..., 0]
    inv_eta = 1.0 / eta
    alpha_c = sp.alpha[..., 0]
    rough = alpha_c > 1e-5
    wip, r12 = _coat_refract_in(wi, eta)
    prob_spec = _coat_prob_specular(sp, r12)
    pick_spec = u_lobe < prob_spec

    # --- specular coat branch -------------------------------------------
    # smooth: delta mirror; rough: VNDF microfacet reflection
    sgn = jnp.where(m.cos_theta(wi) >= 0.0, 1.0, -1.0)[..., None]
    wi_up = wi * sgn
    dist = sp.extra[..., 3].astype(jnp.int32)
    h, _ = mf.sample(dist, jnp.maximum(alpha_c, 1e-4), wi_up, u2)
    wo_rough = (2.0 * m.dot(wi_up, h, keepdims=True) * h - wi_up) * sgn
    wo_smooth = m.reflect_local(wi)
    wo_s = jnp.where(rough[..., None], wo_rough, wo_smooth)
    w_smooth = sp.specular * m.safe_div(r12, prob_spec)[..., None]
    f_r, pdf_r = _coating_eval(sp, wi, wo_rough, families)
    w_rough = m.safe_div(f_r, pdf_r[..., None])
    rough_ok = (pdf_r > 1e-10) & (m.cos_theta(wi) * m.cos_theta(wo_rough) > 0)
    w_s = jnp.where(rough[..., None],
                    jnp.where(rough_ok[..., None],
                              jnp.clip(w_rough, 0.0, 8.0), 0.0),
                    w_smooth)
    pdf_s = jnp.where(rough, pdf_r, prob_spec)
    delta_s = ~rough

    # --- nested branch ---------------------------------------------------
    u_n = m.safe_div(u_lobe - prob_spec, 1.0 - prob_spec)
    nested_fams = tuple(f for f in families if f != ir.BSDF_COATING)
    wop, w_n, pdf_n, delta_n = sample(sp.nested, wip, u_n, u2, nested_fams)
    aci_p = jnp.maximum(jnp.abs(m.cos_theta(wip)), 1e-6)
    aco_p = jnp.maximum(jnp.abs(m.cos_theta(wop)), 1e-6)
    absorb = jnp.exp(-sp.reflectance * (1.0 / aci_p + 1.0 / aco_p)[..., None])
    wo_n, r21 = _coat_refract_out(wop, eta)
    ok_n = (r12 < 1.0 - 1e-6) & (r21 < 1.0 - 1e-6) & (jnp.max(w_n, -1) > 0)
    # delta-nested lanes (coat over a smooth base): branch weighting
    w_delta = w_n * absorb * (
        (1.0 - r12) * (1.0 - r21) / jnp.maximum(1.0 - prob_spec, 1e-6)
    )[..., None]
    pdf_delta = pdf_n * (1.0 - prob_spec)
    # non-delta lanes: one-sample MIS over the combined lobe set — weight
    # f_total/pdf_total from the same eval the MIS pdf queries use (exact
    # sample/eval consistency; also folds the rough-coat lobe pdf in)
    f_e, pdf_e = _coating_eval(sp, wi, wo_n, families)
    w_eval = m.safe_div(f_e, pdf_e[..., None])
    w_nested = jnp.where(delta_n[..., None], w_delta,
                         jnp.where((pdf_e > 1e-12)[..., None],
                                   jnp.clip(w_eval, 0.0, 16.0), 0.0))
    pdf_nested = jnp.where(delta_n, pdf_delta, pdf_e)
    w_nested = jnp.where(ok_n[..., None], w_nested, 0.0)
    pdf_nested = jnp.where(ok_n, pdf_nested, 0.0)

    wo = jnp.where(pick_spec[..., None], wo_s, wo_n)
    weight = jnp.where(pick_spec[..., None], w_s, w_nested)
    pdf = jnp.where(pick_spec, pdf_s, pdf_nested)
    is_delta = jnp.where(pick_spec, delta_s, delta_n)
    return wo, weight, pdf, is_delta


# ---------------------------------------------------------------------------
# Hanrahan-Krueger single-scattering slab (src/bsdfs/hk.cpp). Record layout:
#   reflectance = sigmaS * thickness   (tau_s)
#   specular    = sigmaA * thickness   (tau_a)
#   extra[0]    = HG asymmetry g (0 -> isotropic limit)
# Components: glossy reflection + glossy transmission (single scattering,
# hk.cpp:229-260) and an attenuated delta transmission (hk.cpp:205).
# ---------------------------------------------------------------------------

def _hk_terms(sp, wi):
    from . import phase as phaselib
    tau_s = jnp.maximum(sp.reflectance, 0.0)
    tau_d = tau_s + jnp.maximum(sp.specular, 0.0)
    albedo = m.safe_div(tau_s, jnp.maximum(tau_d, 1e-20))
    aci = jnp.maximum(m.abs_cos_theta(wi), 1e-6)
    p_dt = jnp.mean(jnp.exp(-tau_d / aci[..., None]), -1)
    return phaselib, tau_d, albedo, aci, p_dt


def _hk_eval(sp, wi, wo):
    phaselib, tau_d, albedo, aci, p_dt = _hk_terms(sp, wi)
    g = sp.extra[..., 0]
    aco = jnp.maximum(m.abs_cos_theta(wo), 1e-6)
    phase_val, phase_pdf = phaselib.eval_pdf(phaselib.PHASE_HG, g, wi, wo)
    # reflection: Hanrahan et al. 93 eq. for a single-scatter slab
    f_r = albedo * (phase_val * m.safe_div(aci, aci + aco))[..., None] * (
        1.0 - jnp.exp(-tau_d * (1.0 / aci + 1.0 / aco)[..., None]))
    # transmission (guard the |ci| == |co| removable singularity)
    near = jnp.abs(aci - aco) < 1e-4
    e_i = jnp.exp(-tau_d / aci[..., None])
    e_o = jnp.exp(-tau_d / aco[..., None])
    f_t = albedo * phase_val[..., None] * jnp.where(
        near[..., None],
        tau_d / aco[..., None] * e_o,
        m.safe_div(aci, aci - aco)[..., None] * (e_i - e_o))
    reflect = m.cos_theta(wi) * m.cos_theta(wo) > 0.0
    f = jnp.where(reflect[..., None], f_r, f_t) * aco[..., None]
    pdf = phase_pdf * (1.0 - p_dt)
    return jnp.maximum(f, 0.0), jnp.maximum(pdf, 0.0)


def _hk_sample(sp, wi, u_lobe, u2):
    phaselib, tau_d, albedo, aci, p_dt = _hk_terms(sp, wi)
    g = sp.extra[..., 0]
    pick_dt = u_lobe < p_dt
    # delta transmission: attenuated pass-through
    wo_dt = -wi
    w_dt = jnp.exp(-tau_d / aci[..., None]) / jnp.maximum(p_dt, 1e-6)[..., None]
    # single scattering: phase-function direction
    wo_p, _ = phaselib.sample(phaselib.PHASE_HG, g, wi, u2)
    f_p, pdf_p = _hk_eval(sp, wi, wo_p)
    w_p = m.safe_div(f_p, pdf_p[..., None])
    ok_p = pdf_p > 1e-10
    wo = jnp.where(pick_dt[..., None], wo_dt, wo_p)
    weight = jnp.where(pick_dt[..., None], w_dt,
                       jnp.where(ok_p[..., None], jnp.clip(w_p, 0.0, 16.0),
                                 0.0))
    pdf = jnp.where(pick_dt, p_dt, pdf_p)
    return wo, weight, pdf, pick_dt


def _null_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/null.cpp — pass-through (for mask/medium boundaries)."""
    wo = -wi
    ones = jnp.ones(wi.shape[:-1] + (3,), wi.dtype)
    return wo, ones, jnp.ones(wi.shape[:-1], wi.dtype), jnp.ones(wi.shape[:-1], bool)


def _zero_eval(sp, wi, wo):
    z = jnp.zeros(wi.shape[:-1] + (3,), wi.dtype)
    return z, jnp.zeros(wi.shape[:-1], wi.dtype)


def _irawan_eval(sp, wi, wo):
    """src/bsdfs/irawan.cpp — woven cloth; parameters were packed into
    the generic fields at gather time (models/cloth.py gather_yarn)."""
    from . import cloth as clothlib

    return clothlib.eval_packed(sp, wi, wo)


def _irawan_sample(sp, wi, u_lobe, u2):
    """Cosine-hemisphere sampling, weight = eval/pdf (irawan.cpp:354)."""
    wo = warp.square_to_cosine_hemisphere(u2)
    f, pdf = _irawan_eval(sp, wi, wo)
    weight = jnp.where(pdf[..., None] > 1e-9,
                       f / jnp.maximum(pdf[..., None], 1e-9), 0.0)
    return wo, weight, pdf, jnp.zeros(pdf.shape, bool)


_EVAL = {
    ir.BSDF_DIFFUSE: _diffuse_eval,
    ir.BSDF_ROUGH_CONDUCTOR: _rough_conductor_eval,
    ir.BSDF_PLASTIC: _plastic_eval,
    ir.BSDF_ROUGH_PLASTIC: _rough_plastic_eval,
    ir.BSDF_ROUGH_DIELECTRIC: _rough_dielectric_eval,
    ir.BSDF_PHONG: _phong_eval,
    ir.BSDF_ROUGH_DIFFUSE: _rough_diffuse_eval,
    ir.BSDF_DIFFUSE_TRANSMITTER: _diffuse_transmitter_eval,
    ir.BSDF_WARD: _ward_eval,
    ir.BSDF_MASK: _mask_eval,
    ir.BSDF_CONDUCTOR: _zero_eval,
    ir.BSDF_DIELECTRIC: _zero_eval,
    ir.BSDF_THIN_DIELECTRIC: _zero_eval,
    ir.BSDF_NULL: _zero_eval,
    ir.BSDF_HK: _hk_eval,
    ir.BSDF_IRAWAN: _irawan_eval,
}

_SAMPLE = {
    ir.BSDF_DIFFUSE: _diffuse_sample,
    ir.BSDF_ROUGH_CONDUCTOR: _rough_conductor_sample,
    ir.BSDF_PLASTIC: _plastic_sample,
    ir.BSDF_ROUGH_PLASTIC: _rough_plastic_sample,
    ir.BSDF_ROUGH_DIELECTRIC: _rough_dielectric_sample,
    ir.BSDF_PHONG: _phong_sample,
    ir.BSDF_ROUGH_DIFFUSE: _rough_diffuse_sample,
    ir.BSDF_DIFFUSE_TRANSMITTER: _diffuse_transmitter_sample,
    ir.BSDF_WARD: _ward_sample,
    ir.BSDF_MASK: _mask_sample,
    ir.BSDF_CONDUCTOR: _conductor_sample,
    ir.BSDF_DIELECTRIC: _dielectric_sample,
    ir.BSDF_THIN_DIELECTRIC: _thin_dielectric_sample,
    ir.BSDF_NULL: _null_sample,
    ir.BSDF_HK: _hk_sample,
    ir.BSDF_IRAWAN: _irawan_sample,
}

# Families whose sample() is (partly) a delta lobe.
DELTA_FAMILIES = frozenset(
    [ir.BSDF_CONDUCTOR, ir.BSDF_DIELECTRIC, ir.BSDF_THIN_DIELECTRIC, ir.BSDF_NULL,
     ir.BSDF_PLASTIC, ir.BSDF_COATING, ir.BSDF_HK]
)

# Families that can transmit (frame flipping must keep both sides).
TRANSMISSIVE = frozenset(
    [ir.BSDF_DIELECTRIC, ir.BSDF_THIN_DIELECTRIC, ir.BSDF_NULL,
     ir.BSDF_DIFFUSE_TRANSMITTER, ir.BSDF_ROUGH_DIELECTRIC, ir.BSDF_HK]
)


def _apply_twosided(sp: ShadePoint, wi):
    """extra[:,2] > 0.5 marks a twosided adapter (src/bsdfs/twosided.cpp):
    flip the frame when hit from behind."""
    flip = (sp.extra[..., 2] > 0.5) & (m.cos_theta(wi) < 0.0)
    s = jnp.where(flip, -1.0, 1.0)
    flip_vec = jnp.stack([jnp.ones_like(s), jnp.ones_like(s), s], axis=-1)
    return flip_vec


def eval_pdf(sp: ShadePoint, wi: jax.Array, wo: jax.Array, families: tuple):
    """Masked dispatch of eval+pdf over the scene's static family set."""
    flip = _apply_twosided(sp, wi)
    wi = wi * flip
    wo = wo * flip
    f = jnp.zeros(wi.shape[:-1] + (3,), wi.dtype)
    pdf = jnp.zeros(wi.shape[:-1], wi.dtype)
    for fam in families:
        if fam == ir.BSDF_BLEND:
            continue  # adapter: resolved to a child in gather_shade_point
        if fam == ir.BSDF_COATING:
            fe, fp = _coating_eval(sp, wi, wo, families)
        else:
            fe, fp = _EVAL[fam](sp, wi, wo)
        mask = sp.type == fam
        f = jnp.where(mask[..., None], fe, f)
        pdf = jnp.where(mask, fp, pdf)
    return f, pdf


def sample(sp: ShadePoint, wi: jax.Array, u_lobe: jax.Array, u2: jax.Array,
           families: tuple):
    """Masked dispatch of sample(). Returns (wo, weight, pdf, is_delta)."""
    flip = _apply_twosided(sp, wi)
    wi_f = wi * flip
    wo = jnp.zeros_like(wi)
    weight = jnp.zeros(wi.shape[:-1] + (3,), wi.dtype)
    pdf = jnp.zeros(wi.shape[:-1], wi.dtype)
    is_delta = jnp.zeros(wi.shape[:-1], bool)
    for fam in families:
        if fam == ir.BSDF_BLEND:
            continue  # adapter: resolved to a child in gather_shade_point
        if fam == ir.BSDF_COATING:
            fwo, fw, fp, fd = _coating_sample(sp, wi_f, u_lobe, u2, families)
        else:
            fwo, fw, fp, fd = _SAMPLE[fam](sp, wi_f, u_lobe, u2)
        mask = sp.type == fam
        wo = jnp.where(mask[..., None], fwo, wo)
        weight = jnp.where(mask[..., None], fw, weight)
        pdf = jnp.where(mask, fp, pdf)
        is_delta = jnp.where(mask, fd, is_delta)
    wo = wo * flip
    return wo, weight, pdf, is_delta
