"""Film accumulation: reconstruction-filtered splatting into the image.

Analog of Film/ImageBlock (include/mitsuba/render/film.h:37,
imageblock.h:40,103: filter-weighted splat with border) and the rfilter
plugins (src/rfilters/): the filter footprint is a static SxS neighborhood
splat done with scatter-add (`.at[].add`), and weights are normalized at
develop time. For the common box-filter + pixel-ordered-rays case the splat
degenerates to a reshape+mean — no scatter at all (the fast path used by the
benchmark).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Filter kinds (src/rfilters/*.cpp)
FILTER_BOX = 0
FILTER_TENT = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_CATMULLROM = 4
FILTER_LANCZOS = 5

_FILTER_RADIUS = {
    FILTER_BOX: 0.5,
    FILTER_TENT: 1.0,
    FILTER_GAUSSIAN: 2.0,
    FILTER_MITCHELL: 2.0,
    FILTER_CATMULLROM: 2.0,
    FILTER_LANCZOS: 3.0,
}


def filter_eval(kind: int, x: jax.Array) -> jax.Array:
    """1D filter kernel value at offset x (filters are separable here;
    the reference discretizes into a LUT, imageblock.h:170 — we evaluate
    exactly, it's just elementwise math)."""
    ax = jnp.abs(x)
    if kind == FILTER_BOX:
        return (ax <= 0.5).astype(jnp.float32)
    if kind == FILTER_TENT:
        return jnp.maximum(1.0 - ax, 0.0)
    if kind == FILTER_GAUSSIAN:
        # gaussian.cpp: stddev 0.5, radius 2, offset so it reaches 0
        alpha = 2.0
        r = _FILTER_RADIUS[FILTER_GAUSSIAN]
        return jnp.maximum(
            jnp.exp(-alpha * ax * ax) - jnp.exp(-alpha * r * r), 0.0
        )
    if kind in (FILTER_MITCHELL, FILTER_CATMULLROM):
        if kind == FILTER_MITCHELL:
            b = c = 1.0 / 3.0
        else:
            b, c = 0.0, 0.5
        x2 = ax * ax
        x3 = x2 * ax
        inner = (
            (12.0 - 9.0 * b - 6.0 * c) * x3
            + (-18.0 + 12.0 * b + 6.0 * c) * x2
            + (6.0 - 2.0 * b)
        ) / 6.0
        outer = (
            (-b - 6.0 * c) * x3
            + (6.0 * b + 30.0 * c) * x2
            + (-12.0 * b - 48.0 * c) * ax
            + (8.0 * b + 24.0 * c)
        ) / 6.0
        return jnp.where(ax < 1.0, inner, jnp.where(ax < 2.0, outer, 0.0))
    if kind == FILTER_LANCZOS:
        tau = 3.0
        px = jnp.pi * ax
        sinc = jnp.where(ax < 1e-6, 1.0, jnp.sin(px) / jnp.maximum(px, 1e-9))
        wind = jnp.where(
            ax < 1e-6, 1.0, jnp.sin(px / tau) / jnp.maximum(px / tau, 1e-9)
        )
        return jnp.where(ax < tau, sinc * wind, 0.0)
    raise ValueError(f"unknown filter {kind}")


def splat(
    width: int,
    height: int,
    px: jax.Array,
    py: jax.Array,
    value: jax.Array,
    kind: int = FILTER_BOX,
):
    """Scatter-add filtered splats. px/py: (N,) continuous pixel coords,
    value: (N,3). Returns (image (H,W,3), weight (H,W))."""
    radius = _FILTER_RADIUS[kind]
    supp = int(np.ceil(radius - 0.5)) * 2 + 1  # odd footprint width
    img = jnp.zeros((height, width, 3), value.dtype)
    wgt = jnp.zeros((height, width), value.dtype)
    cx = jnp.floor(px).astype(jnp.int32)
    cy = jnp.floor(py).astype(jnp.int32)
    half = supp // 2
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            ix = cx + dx
            iy = cy + dy
            fx = (ix.astype(jnp.float32) + 0.5) - px
            fy = (iy.astype(jnp.float32) + 0.5) - py
            w = filter_eval(kind, fx) * filter_eval(kind, fy)
            inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
            w = jnp.where(inside, w, 0.0)
            ixc = jnp.clip(ix, 0, width - 1)
            iyc = jnp.clip(iy, 0, height - 1)
            img = img.at[iyc, ixc].add(value * w[:, None])
            wgt = wgt.at[iyc, ixc].add(w)
    return img, wgt


def develop(img: jax.Array, wgt: jax.Array) -> jax.Array:
    """Normalize accumulated splats (Film::develop, hdrfilm.cpp:481)."""
    return img / jnp.maximum(wgt, 1e-8)[..., None]


def accumulate_box_ordered(width: int, height: int, spp: int, value: jax.Array):
    """Fast path: rays laid out pixel-major, one box-filtered sample each —
    accumulate by reshape+mean (no scatter)."""
    return jnp.mean(value.reshape(height, width, spp, 3), axis=2)
