"""Vector math for batched rays/shading frames.

Analog of the reference's math/geometry layer
(reference: include/mitsuba/core/{vector.h,normal.h,frame.h,util.h}).
Everything operates on trailing-dim-3 float32 arrays so it vectorizes;
no per-element Python objects, no scalar control flow.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-4
# plain Python float: a module-level jnp scalar would initialize the
# device backend at import time, before the CLI's --cpu config.update
# can run
INF = 3.0e38


def dot(a: jax.Array, b: jax.Array, keepdims: bool = False) -> jax.Array:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def length(v: jax.Array, keepdims: bool = False) -> jax.Array:
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-30))


def normalize(v: jax.Array) -> jax.Array:
    return v / length(v, keepdims=True)


def safe_sqrt(x: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_rsqrt(x: jax.Array) -> jax.Array:
    return jax.lax.rsqrt(jnp.maximum(x, 1e-30))


def safe_div(a: jax.Array, b: jax.Array, eps: float = 1e-20) -> jax.Array:
    """a / b with 0 where |b| is tiny (replaces reference's scalar guards)."""
    safe_b = jnp.where(jnp.abs(b) < eps, 1.0, b)
    return jnp.where(jnp.abs(b) < eps, 0.0, a / safe_b)


def lerp(a, b, t):
    return a + (b - a) * t


def sqr(x):
    return x * x


# ---------------------------------------------------------------------------
# Shading frames (reference: include/mitsuba/core/frame.h)
# ---------------------------------------------------------------------------

def coordinate_system(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017).

    Replaces Frame::Frame(n) (frame.h:60-72) without the sign branch.
    n: (..., 3) unit vectors -> (s, t) each (..., 3).
    """
    nz = n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    s = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    t = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return s, t


def to_local(n: jax.Array, v: jax.Array) -> jax.Array:
    """World->local where local z = n (Frame::toLocal, frame.h:80)."""
    s, t = coordinate_system(n)
    return jnp.stack([dot(v, s), dot(v, t), dot(v, n)], axis=-1)


def to_world(n: jax.Array, v: jax.Array) -> jax.Array:
    """Local->world where local z = n (Frame::toWorld, frame.h:85)."""
    s, t = coordinate_system(n)
    return (
        s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]
    )


# Frame trig helpers over local directions (frame.h:90-140).
def cos_theta(v):
    return v[..., 2]


def abs_cos_theta(v):
    return jnp.abs(v[..., 2])


def sin_theta2(v):
    return jnp.maximum(1.0 - v[..., 2] * v[..., 2], 0.0)


def sin_theta(v):
    return jnp.sqrt(sin_theta2(v))


def tan_theta(v):
    return safe_div(sin_theta(v), v[..., 2])


def tan_theta2(v):
    return safe_div(sin_theta2(v), v[..., 2] * v[..., 2])


def sin_phi(v):
    s = sin_theta(v)
    return jnp.where(s < 1e-9, 0.0, jnp.clip(safe_div(v[..., 1], s), -1.0, 1.0))


def cos_phi(v):
    s = sin_theta(v)
    return jnp.where(s < 1e-9, 1.0, jnp.clip(safe_div(v[..., 0], s), -1.0, 1.0))


# ---------------------------------------------------------------------------
# Reflection / refraction (reference: libcore/util.cpp:*, bsdf helpers)
# ---------------------------------------------------------------------------

def reflect_local(wi: jax.Array) -> jax.Array:
    """Mirror reflection in the local frame (z = normal)."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)


def reflect(wi: jax.Array, n: jax.Array) -> jax.Array:
    """Reflect wi (pointing away from surface) about n."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def refract_local(wi: jax.Array, eta: jax.Array, cos_theta_t: jax.Array) -> jax.Array:
    """Refraction in local frame given precomputed transmitted cosine.

    eta: relative IOR for the actual transmission direction
    (reference: util.cpp refract / bsdfs/dielectric.cpp:202-213).
    """
    scale = jnp.where(cos_theta_t < 0.0, 1.0 / eta, eta)[..., None]
    out = jnp.stack(
        [-wi[..., 0], -wi[..., 1], jnp.zeros_like(wi[..., 2])], axis=-1
    ) * scale
    return out.at[..., 2].set(cos_theta_t)


def fresnel_dielectric(cos_theta_i: jax.Array, eta: jax.Array):
    """Exact unpolarized Fresnel for dielectrics.

    Returns (F, cos_theta_t, eta_it, eta_ti) following the convention of
    the reference's fresnelDielectricExt (libcore/util.cpp:618-648):
    eta = int_ior/ext_ior, cos_theta_i signed (positive = outside).
    """
    outside = cos_theta_i >= 0.0
    eta_it = jnp.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_it
    # Snell's law (using squared sines).
    cti = jnp.abs(cos_theta_i)
    sin2_t = eta_ti * eta_ti * jnp.maximum(1.0 - cti * cti, 0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_s = safe_div(cti - eta_it * cos_t, cti + eta_it * cos_t)
    r_p = safe_div(eta_it * cti - cos_t, eta_it * cti + cos_t)
    f = jnp.where(tir, 1.0, 0.5 * (r_s * r_s + r_p * r_p))
    cos_theta_t = jnp.where(outside, -cos_t, cos_t)
    return f, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i: jax.Array, eta: jax.Array, k: jax.Array):
    """Unpolarized Fresnel for conductors (libcore/util.cpp:686-702).

    eta, k: (..., 3) spectral IOR; cos_theta_i: (...,).
    """
    c2 = (cos_theta_i * cos_theta_i)[..., None]
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * jnp.abs(cos_theta_i)[..., None]
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta: jax.Array) -> jax.Array:
    """Polynomial fit of the diffuse Fresnel reflectance
    (reference: libcore/util.cpp:744-770, fresnelDiffuseReflectance fast path)."""
    eta = jnp.asarray(eta)
    above = (
        -1.4399 / (eta * eta)
        + 0.7099 / eta
        + 0.6681
        + 0.0636 * eta
    )
    inv_eta = 1.0 / eta
    inv_eta2 = inv_eta * inv_eta
    inv_eta3 = inv_eta2 * inv_eta
    inv_eta4 = inv_eta3 * inv_eta
    inv_eta5 = inv_eta4 * inv_eta
    below = (
        0.919317 - 3.4793 * inv_eta + 6.75335 * inv_eta2
        - 7.80989 * inv_eta3 + 4.98554 * inv_eta4 - 1.36881 * inv_eta5
    )
    return jnp.where(eta < 1.0, below, above)


def spherical_direction(theta: jax.Array, phi: jax.Array) -> jax.Array:
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def spherical_coordinates(d: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Direction -> (theta, phi) with phi in [0, 2pi)."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return theta, phi
