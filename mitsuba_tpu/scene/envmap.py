"""Lat-long environment emitter with 2D CDF importance sampling.

Analog of src/emitters/envmap.cpp: the reference importance-
samples the luminance-weighted lat-long bitmap via hierarchical 2D sample
warping; here we precompute a marginal row CDF + per-row conditional CDFs
(host side) and sample with two batched searchsorteds — O(log n) gathers,
no divergence. Radiance lookup is bilinear and differentiable w.r.t. the
texel array (the path for envmap gradients).

Direction convention matches the reference (envmap.cpp dirToUV): y-up,
u = (1 + atan2(dx, -dz) / pi) / 2,  v = acos(clamp(dy)) / pi.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import math as m


@struct.dataclass
class EnvMap:
    image: jax.Array      # (H, W, 3) radiance
    row_cdf: jax.Array    # (H,) inclusive marginal CDF over rows
    cond_cdf: jax.Array   # (H, W) inclusive conditional CDF per row
    pdf_map: jax.Array    # (H, W) discrete selection probability (sums to 1)
    scale: jax.Array      # () overall scale
    # optional true-spectral radiance stack (H, W, B) at the Hosek band
    # wavelengths (models/hosek.SPEC_BANDS) — consumed by the
    # hero-wavelength spectral integrator instead of RGB upsampling
    spectral: object = None


def build_envmap(image: np.ndarray, scale: float = 1.0) -> EnvMap:
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, -1)
    h, w = image.shape[:2]
    lum = image @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    # solid-angle weight per row: sin(theta) (envmap.cpp applies the same)
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None] + 1e-12
    pdf_map = weight / weight.sum()
    row = pdf_map.sum(1)
    row_cdf = np.cumsum(row)
    row_cdf[-1] = 1.0
    cond = pdf_map / row[:, None]
    cond_cdf = np.cumsum(cond, axis=1)
    cond_cdf[:, -1] = 1.0
    return EnvMap(
        image=jnp.asarray(image),
        row_cdf=jnp.asarray(row_cdf.astype(np.float32)),
        cond_cdf=jnp.asarray(cond_cdf.astype(np.float32)),
        pdf_map=jnp.asarray(pdf_map.astype(np.float32)),
        scale=jnp.float32(scale),
    )


def attach_envmap(scene, image: np.ndarray, scale: float = 1.0,
                  spectral: np.ndarray | None = None):
    em = build_envmap(image, scale)
    if spectral is not None:
        em = em.replace(spectral=jnp.asarray(spectral, jnp.float32))
    return scene.replace(envmap=em, has_env=True)


# Hosek band wavelengths of EnvMap.spectral (320..720 nm step 40)
SPEC_BANDS_MIN = 320.0
SPEC_BANDS_STEP = 40.0


def eval_radiance_spectral(em: EnvMap, d: jax.Array,
                           lam: jax.Array) -> jax.Array:
    """Spectral radiance lookup: bilinear in (u, v), linear across the
    band axis at wavelengths lam (..., K) -> (..., K)."""
    spec = em.spectral                                  # (H, W, B)
    h, w, B = spec.shape
    u, v = dir_to_uv(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    bands = (
        spec[y0i, x0i] * (1 - fx) * (1 - fy)
        + spec[y0i, x1i] * fx * (1 - fy)
        + spec[y1i, x0i] * (1 - fx) * fy
        + spec[y1i, x1i] * fx * fy
    )                                                   # (..., B)
    pos = (lam - SPEC_BANDS_MIN) / SPEC_BANDS_STEP      # (..., K)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, B - 1)
    hi = jnp.minimum(lo + 1, B - 1)
    f = jnp.clip(pos - lo, 0.0, 1.0)
    out = (jnp.take_along_axis(bands, lo, axis=-1) * (1.0 - f)
           + jnp.take_along_axis(bands, hi, axis=-1) * f)
    return out * em.scale


def dir_to_uv(d: jax.Array):
    """Direction -> (u, v) in [0,1)^2, y-up lat-long (envmap.cpp)."""
    u = (1.0 + jnp.arctan2(d[..., 0], -d[..., 2]) / jnp.pi) * 0.5
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / jnp.pi
    return u, v


def uv_to_dir(u: jax.Array, v: jax.Array) -> jax.Array:
    phi = (2.0 * u - 1.0) * jnp.pi
    theta = v * jnp.pi
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi)], -1)


def eval_radiance(em: EnvMap, d: jax.Array) -> jax.Array:
    """Bilinear lookup of emitted radiance along -d (escaped ray dir d)."""
    h, w = em.image.shape[:2]
    u, v = dir_to_uv(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    img = em.image
    c = (
        img[y0i, x0i] * (1 - fx) * (1 - fy)
        + img[y0i, x1i] * fx * (1 - fy)
        + img[y1i, x0i] * (1 - fx) * fy
        + img[y1i, x1i] * fx * fy
    )
    return c * em.scale


def sample_direction(em: EnvMap, u2: jax.Array):
    """Importance-sample a direction ~ luminance * sin(theta).

    u2: (N,2). Returns (d (N,3), pdf_solid_angle (N,), radiance (N,3))."""
    h, w = em.image.shape[:2]
    row = jnp.clip(
        jnp.searchsorted(em.row_cdf, u2[..., 0], side="left"), 0, h - 1
    ).astype(jnp.int32)
    # rescale u within the row stratum for stratification reuse
    lo_r = jnp.where(row > 0, em.row_cdf[jnp.maximum(row - 1, 0)], 0.0)
    du_r = m.safe_div(u2[..., 0] - lo_r, em.row_cdf[row] - lo_r)
    col = jnp.clip(
        jax.vmap(lambda cdf_row, uu: jnp.searchsorted(cdf_row, uu, side="left"))(
            em.cond_cdf[row], u2[..., 1]
        ),
        0, w - 1,
    ).astype(jnp.int32)
    lo_c = jnp.where(col > 0, em.cond_cdf[row, jnp.maximum(col - 1, 0)], 0.0)
    du_c = m.safe_div(u2[..., 1] - lo_c, em.cond_cdf[row, col] - lo_c)

    v = (row.astype(jnp.float32) + jnp.clip(du_r, 0.0, 0.9999)) / h
    u = (col.astype(jnp.float32) + jnp.clip(du_c, 0.0, 0.9999)) / w
    d = uv_to_dir(u, v)
    theta = v * jnp.pi
    sin_t = jnp.maximum(jnp.sin(theta), 1e-8)
    # discrete pixel prob -> solid angle density
    pdf = em.pdf_map[row, col] * (h * w) / (2.0 * jnp.pi * jnp.pi * sin_t)
    rad = eval_radiance(em, d)
    return d, pdf, rad


def pdf_direction(em: EnvMap, d: jax.Array) -> jax.Array:
    """Solid-angle pdf that sample_direction produces `d` (for MIS)."""
    h, w = em.image.shape[:2]
    u, v = dir_to_uv(d)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    sin_t = jnp.maximum(jnp.sin(v * jnp.pi), 1e-8)
    return em.pdf_map[y, x] * (h * w) / (2.0 * jnp.pi * jnp.pi * sin_t)


def rotate_latlong(image: np.ndarray, to_world: np.ndarray) -> np.ndarray:
    """Bake an envmap <transform name="toWorld"> rotation into the
    lat-long image (envmap.cpp applies m_worldTransform per lookup; a
    one-time host-side resample keeps the runtime lookup unchanged).
    new(d_world) = old(latlong(R^-1 d_world)), bilinear."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    r = np.asarray(to_world, np.float32)[:3, :3]
    r_inv = np.linalg.inv(r)
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = (2.0 * u - 1.0) * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([
        np.broadcast_to(np.sin(phi)[None, :], (h, w)) * st,
        np.broadcast_to(np.cos(theta)[:, None], (h, w)),
        np.broadcast_to(-np.cos(phi)[None, :], (h, w)) * st,
    ], -1)                                              # (H, W, 3) world
    dl = d @ r_inv.T                                    # envmap-local
    ul = (1.0 + np.arctan2(dl[..., 0], -dl[..., 2]) / np.pi) / 2.0
    vl = np.arccos(np.clip(dl[..., 1], -1, 1)) / np.pi
    fx = ul * w - 0.5
    fy = vl * h - 0.5
    x0 = np.floor(fx).astype(np.int32)
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, h - 1)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = np.mod(x0, w)
    x1w = np.mod(x0 + 1, w)
    y1 = np.minimum(y0 + 1, h - 1)
    out = (img[y0, x0w] * (1 - tx) * (1 - ty) + img[y0, x1w] * tx * (1 - ty)
           + img[y1, x0w] * (1 - tx) * ty + img[y1, x1w] * tx * ty)
    return out.astype(np.float32)
