"""Sample warping library: [0,1)^2 -> distributions on spheres/disks/cones.

Equivalent of the reference warp library
(include/mitsuba/core/warp.h:40-89, src/libcore/warp.cpp) — every mapping is
a batched pure function plus its pdf, so `sample` and `pdf` can be
chi-square-tested against each other (the reference's core QA idea,
include/mitsuba/core/chisquare.h:81; see tests/test_warp.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import math as m

INV_PI = 1.0 / jnp.pi
INV_TWOPI = 0.5 / jnp.pi
INV_FOURPI = 0.25 / jnp.pi


def square_to_uniform_sphere(u: jax.Array) -> jax.Array:
    """warp.cpp squareToUniformSphere."""
    z = 1.0 - 2.0 * u[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_sphere_pdf():
    return INV_FOURPI


def square_to_uniform_hemisphere(u: jax.Array) -> jax.Array:
    z = u[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_hemisphere_pdf():
    return INV_TWOPI


def square_to_cosine_hemisphere(u: jax.Array) -> jax.Array:
    """Concentric-disk lift (warp.cpp squareToCosineHemisphere)."""
    d = square_to_uniform_disk_concentric(u)
    z = m.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return jnp.stack([d[..., 0], d[..., 1], z], axis=-1)


def square_to_cosine_hemisphere_pdf(v: jax.Array) -> jax.Array:
    return jnp.maximum(v[..., 2], 0.0) * INV_PI


def square_to_uniform_cone(u: jax.Array, cos_cutoff) -> jax.Array:
    """Uniform direction inside a cone around +z (warp.cpp squareToUniformCone)."""
    z = 1.0 - u[..., 0] * (1.0 - cos_cutoff)
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_cone_pdf(cos_cutoff) -> jax.Array:
    return INV_TWOPI / (1.0 - cos_cutoff)


def square_to_uniform_disk(u: jax.Array) -> jax.Array:
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_uniform_disk_concentric(u: jax.Array) -> jax.Array:
    """Shirley-Chiu concentric mapping (warp.cpp:86-120), branchless."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = jnp.logical_and(x == 0.0, y == 0.0)
    quad1 = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(quad1, x, y)
    safe_r = jnp.where(is_zero, 1.0, r)
    phi = jnp.where(
        quad1,
        (jnp.pi / 4.0) * m.safe_div(y, safe_r),
        (jnp.pi / 2.0) - (jnp.pi / 4.0) * m.safe_div(x, safe_r),
    )
    r = jnp.where(is_zero, 0.0, r)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_uniform_triangle(u: jax.Array) -> jax.Array:
    """Barycentric warp (warp.cpp squareToUniformTriangle): returns (b1, b2)."""
    a = m.safe_sqrt(1.0 - u[..., 0])
    return jnp.stack([1.0 - a, a * u[..., 1]], axis=-1)


def square_to_std_normal(u: jax.Array) -> jax.Array:
    """Box-Muller (warp.cpp squareToStdNormal)."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(1.0 - u[..., 0], 1e-20)))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_tent(u: jax.Array) -> jax.Array:
    """1D tent over [-1, 1] applied per-component (warp.cpp intervalToNonuniformTent)."""
    def tent(t):
        lo = t < 0.5
        return jnp.where(lo, jnp.sqrt(2.0 * t) - 1.0, 1.0 - jnp.sqrt(2.0 - 2.0 * t))
    return tent(u)


def square_to_beckmann(u: jax.Array, alpha) -> jax.Array:
    """Beckmann-distributed microfacet normal (warp.cpp squareToBeckmann)."""
    phi = 2.0 * jnp.pi * u[..., 1]
    tan2 = -alpha * alpha * jnp.log(jnp.maximum(1.0 - u[..., 0], 1e-20))
    ct = 1.0 / jnp.sqrt(1.0 + tan2)
    st = m.safe_sqrt(1.0 - ct * ct)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def square_to_beckmann_pdf(v: jax.Array, alpha) -> jax.Array:
    ct = v[..., 2]
    t2 = m.tan_theta2(v)
    pdf = INV_PI / (alpha * alpha * ct * ct * ct) * jnp.exp(-t2 / (alpha * alpha))
    return jnp.where(ct > 1e-9, pdf, 0.0)


def square_to_ggx(u: jax.Array, alpha) -> jax.Array:
    """GGX/Trowbridge-Reitz-distributed half vector."""
    phi = 2.0 * jnp.pi * u[..., 1]
    tan2 = alpha * alpha * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-20)
    ct = 1.0 / jnp.sqrt(1.0 + tan2)
    st = m.safe_sqrt(1.0 - ct * ct)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def square_to_ggx_pdf(v: jax.Array, alpha) -> jax.Array:
    ct = v[..., 2]
    a2 = alpha * alpha
    denom = ct * ct * (a2 - 1.0) + 1.0
    pdf = a2 * ct * INV_PI / jnp.maximum(denom * denom, 1e-20)
    return jnp.where(ct > 1e-9, pdf, 0.0)


def square_to_von_mises_fisher(u: jax.Array, kappa) -> jax.Array:
    """vMF sampling around +z (core/vmf.h analog), numerically stable."""
    # w = 1 + log(u0 + (1-u0) e^{-2 kappa}) / kappa
    e = jnp.exp(-2.0 * kappa)
    w = 1.0 + jnp.log(jnp.maximum(u[..., 0] + (1.0 - u[..., 0]) * e, 1e-30)) / kappa
    r = m.safe_sqrt(1.0 - w * w)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), w], axis=-1)


def square_to_von_mises_fisher_pdf(v: jax.Array, kappa) -> jax.Array:
    # kappa / (2 pi (1 - e^{-2 kappa})) * e^{kappa (cos - 1)}
    norm = kappa / (2.0 * jnp.pi * (1.0 - jnp.exp(-2.0 * kappa)))
    return norm * jnp.exp(kappa * (v[..., 2] - 1.0))


def square_to_phong_lobe(u: jax.Array, exponent) -> jax.Array:
    """cos^n lobe around +z (used by the phong BSDF, bsdfs/phong.cpp)."""
    ct = jnp.power(jnp.maximum(u[..., 0], 1e-20), 1.0 / (exponent + 2.0))
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def square_to_phong_lobe_pdf(v: jax.Array, exponent) -> jax.Array:
    ct = jnp.maximum(v[..., 2], 0.0)
    return (exponent + 2.0) * INV_TWOPI * jnp.power(ct, exponent + 1.0)
