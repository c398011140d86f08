"""Texture lookup over the scene's padded texture stack.

Replacement for the texture plugins (src/textures/{bitmap.cpp,
checkerboard.cpp,gridtexture.cpp,...} + the EWA mipmap, mipmap.h:91): all
bitmaps live in one (K, TH, TW, 3) array so a per-ray lookup is a single
gather; procedural checkerboard/grid textures are expressed as tiny
nearest-filtered bitmaps (exactly equivalent under uv tiling). Lookups are
differentiable w.r.t. texels — the path for texture gradients.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m


EWA_TAPS = 8          # fixed anisotropic tap count (static for XLA)
EWA_MAX_ANISO = 8.0   # max major/minor ratio (mipmap.h m_maxAnisotropy)


def resolve(scene, tex_id: jax.Array, uv: jax.Array, fallback: jax.Array,
            footprint=None, duvdx=None, duvdy=None) -> jax.Array:
    """Per-ray reflectance: texture sample where tex_id >= 0, else fallback.

    tex_id: (N,) int32; uv: (N,2); fallback: (N,3). `footprint` (N,) is
    the world-space pixel footprint times the triangle's uv density
    (texels-per-pixel before the resolution factor); with mips built it
    selects the trilinear level (mipmap.h ETrilinear). duvdx/duvdy (N,2)
    uv gradients of a 1-pixel raster step enable the EWA anisotropic
    filter (mipmap.h:161 evalEWA) on the lanes that carry them; lanes
    with zero gradients fall back to isotropic trilinear."""
    if scene.textures.shape[0] == 1 and scene.textures.shape[1] == 1:
        # No real textures in this scene: compile nothing.
        return fallback
    tid = jnp.maximum(tex_id, 0)
    value = sample_bilinear(scene, tid, uv)
    if scene.tex_mips is not None and footprint is not None:
        tri = _trilinear_at(scene, tid, uv,
                            _lod_from_footprint(scene, tid, footprint),
                            value)
        if duvdx is not None and duvdy is not None:
            ewa, has_grad = _ewa(scene, tid, uv, duvdx, duvdy)
            value = jnp.where(has_grad[..., None], ewa, tri)
        else:
            value = tri
    return jnp.where((tex_id >= 0)[..., None], value, fallback)


def _lod_from_footprint(scene, tid, footprint):
    """Isotropic lod = log2(texels per pixel) from the scalar footprint."""
    w_tex = scene.tex_size[tid, 1].astype(jnp.float32)
    xf = scene.tex_transform[tid]
    # uv tiling multiplies the texel density
    tile = jnp.maximum(jnp.abs(xf[..., 0]), jnp.abs(xf[..., 1]))
    texels = jnp.maximum(footprint * w_tex * tile, 1e-8)
    return jnp.log2(texels)


def _clip_lod(scene, tid, lod):
    max_l = jnp.floor(jnp.log2(jnp.maximum(
        jnp.minimum(scene.tex_size[tid, 0],
                    scene.tex_size[tid, 1]).astype(jnp.float32), 1.0)))
    return jnp.clip(lod, 0.0, max_l - 1.0)


def _mip_bilinear(scene, tid, uv, level):
    """Bilinear from the mip strip at integer level >= 1 (per-lane).
    Level l of texture k lives at x offset W*(1 - 2^(1-l)) with size
    (h>>l, w>>l) in scene.tex_mips."""
    xf = scene.tex_transform[tid]
    lvl = jnp.maximum(level, 1.0)
    h = jnp.maximum(
        (scene.tex_size[tid, 0].astype(jnp.float32)
         / jnp.exp2(lvl)).astype(jnp.int32), 1)
    w = jnp.maximum(
        (scene.tex_size[tid, 1].astype(jnp.float32)
         / jnp.exp2(lvl)).astype(jnp.int32), 1)
    x_off = (scene.tex_size[tid, 1].astype(jnp.float32)
             * (1.0 - jnp.exp2(1.0 - lvl))).astype(jnp.int32)
    u = uv[..., 0] * xf[..., 0] + xf[..., 2]
    v = uv[..., 1] * xf[..., 1] + xf[..., 3]
    x = u * w.astype(jnp.float32) - 0.5
    y = (1.0 - v) * h.astype(jnp.float32) - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = jnp.mod(x0f.astype(jnp.int32), w)
    x1 = jnp.mod(x0f.astype(jnp.int32) + 1, w)
    y0 = jnp.mod(y0f.astype(jnp.int32), h)
    y1 = jnp.mod(y0f.astype(jnp.int32) + 1, h)
    t = scene.tex_mips
    c00 = t[tid, y0, x_off + x0]
    c01 = t[tid, y0, x_off + x1]
    c10 = t[tid, y1, x_off + x0]
    c11 = t[tid, y1, x_off + x1]
    return (c00 * ((1 - fx) * (1 - fy))[..., None]
            + c01 * (fx * (1 - fy))[..., None]
            + c10 * ((1 - fx) * fy)[..., None]
            + c11 * (fx * fy)[..., None])


def _trilinear_at(scene, tid, uv, lod, level0=None):
    """Trilinear sample at an explicit lod (mipmap.h ETrilinear).
    level0: optional precomputed base-level bilinear at uv."""
    lod = _clip_lod(scene, tid, lod)
    l0 = jnp.floor(lod)
    frac = lod - l0
    if level0 is None:
        level0 = sample_bilinear(scene, tid, uv)
    lo = jnp.where((l0 < 1.0)[..., None], level0,
                   _mip_bilinear(scene, tid, uv, l0))
    hi = _mip_bilinear(scene, tid, uv, l0 + 1.0)
    return lo * (1.0 - frac)[..., None] + hi * frac[..., None]


def _ewa(scene, tid, uv, duvdx, duvdy):
    """Fixed-tap EWA anisotropic filtering (mipmap.h:161 evalEWA).

    The reference integrates a Gaussian over the exact texel ellipse with
    a data-dependent loop; a wavefront wants static shapes, so this
    uses the hardware-anisotropic formulation: EWA_TAPS Gaussian-weighted
    trilinear probes along the ellipse MAJOR axis at the lod set by the
    clamped MINOR axis — the same filter family, O(1) compile shape.
    Returns (value, has_gradients)."""
    xf = scene.tex_transform[tid]
    h = scene.tex_size[tid, 0].astype(jnp.float32)
    w = scene.tex_size[tid, 1].astype(jnp.float32)
    # gradients in texel units (v flip does not change magnitudes)
    gx = jnp.stack([duvdx[..., 0] * xf[..., 0] * w,
                    duvdx[..., 1] * xf[..., 1] * h], -1)
    gy = jnp.stack([duvdy[..., 0] * xf[..., 0] * w,
                    duvdy[..., 1] * xf[..., 1] * h], -1)
    lx = m.length(gx)
    ly = m.length(gy)
    has_grad = (lx + ly) > 1e-8
    major_is_x = lx >= ly
    l_maj = jnp.maximum(lx, ly)
    l_min = jnp.minimum(lx, ly)
    aniso = jnp.clip(m.safe_div(l_maj, jnp.maximum(l_min, 1e-8)),
                     1.0, EWA_MAX_ANISO)
    lod = jnp.log2(jnp.maximum(l_maj / aniso, 1e-8))
    major_uv = jnp.where(major_is_x[..., None], duvdx, duvdy)

    acc = 0.0
    wsum = 0.0
    for i in range(EWA_TAPS):
        s = (i + 0.5) / EWA_TAPS - 0.5
        wgt = jnp.exp(-2.0 * (2.0 * s) ** 2)        # Gaussian lobe
        tap = _trilinear_at(scene, tid, uv + s * major_uv, lod)
        acc = acc + wgt * tap
        wsum = wsum + wgt
    return acc / wsum, has_grad


def sample_bilinear(scene, tid: jax.Array, uv: jax.Array) -> jax.Array:
    """Repeat-wrapped bilinear (or nearest) lookup. tid: (N,), uv: (N,2)."""
    xf = scene.tex_transform[tid]                       # (N,4)
    u = uv[..., 0] * xf[..., 0] + xf[..., 2]
    v = uv[..., 1] * xf[..., 1] + xf[..., 3]
    h = scene.tex_size[tid, 0].astype(jnp.float32)
    w = scene.tex_size[tid, 1].astype(jnp.float32)
    # uv -> continuous pixel coords, v flipped (image row 0 = top, v=1)
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    nearest = scene.tex_nearest[tid] == 1

    def wrap(i, n):
        return jnp.mod(i, jnp.maximum(n, 1)).astype(jnp.int32)

    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    hn = scene.tex_size[tid, 0]
    wn = scene.tex_size[tid, 1]
    x0 = wrap(x0f.astype(jnp.int32), wn)
    x1 = wrap(x0f.astype(jnp.int32) + 1, wn)
    y0 = wrap(y0f.astype(jnp.int32), hn)
    y1 = wrap(y0f.astype(jnp.int32) + 1, hn)
    t = scene.textures
    c00 = t[tid, y0, x0]
    c01 = t[tid, y0, x1]
    c10 = t[tid, y1, x0]
    c11 = t[tid, y1, x1]
    bil = (
        c00 * ((1 - fx) * (1 - fy))[..., None]
        + c01 * (fx * (1 - fy))[..., None]
        + c10 * ((1 - fx) * fy)[..., None]
        + c11 * (fx * fy)[..., None]
    )
    # nearest: round instead of blend
    xn = wrap(jnp.round(x).astype(jnp.int32), wn)
    yn = wrap(jnp.round(y).astype(jnp.int32), hn)
    near = t[tid, yn, xn]
    return jnp.where(nearest[..., None], near, bil)


def checkerboard(color0, color1) -> dict:
    """Procedural checkerboard as a 2x2 nearest bitmap
    (src/textures/checkerboard.cpp semantics under repeat tiling)."""
    c0 = np.asarray(color0, np.float32)
    c1 = np.asarray(color1, np.float32)
    data = np.stack([np.stack([c0, c1]), np.stack([c1, c0])])
    return {"data": data, "nearest": True, "transform": (2.0, 2.0, 0.0, 0.0)}
