"""Render orchestration: sample generation, spp-chunking, film accumulation.

Analog of RenderJob/BlockedRenderProcess/renderBlock
(src/librender/renderjob.cpp:87, renderproc.cpp:26-115,
integrator.cpp:99-196): instead of a scheduler farming 32x32 pixel blocks to
worker threads in Hilbert order, the film is rendered as giant ray batches
(all pixels x spp_chunk samples) inside one jitted scan — XLA pipelines the
chunks; block/spiral ordering is meaningless at batch level. Sharding over
devices is layered on top in parallel/render_sharded.py.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.rng import SampleStream, hash_u32, u32_to_uniform
from ..film import film as filmlib


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the analog of the integrator Properties +
    film config in scene XML)."""

    spp: int = 16
    max_depth: int = 8          # path edges, Mitsuba convention (maxDepth)
    rr_depth: int = 5           # start Russian roulette after this depth
    seed: int = 0
    filter: int = filmlib.FILTER_BOX
    spp_chunk: int = 0          # 0 = auto
    strict_normals: bool = False
    sampler: int = 0            # samplers/qmc.py SAMPLER_* family
    unroll: bool = True         # unroll the bounce loop (static QMC dims)
    # MIS heuristic switch (the fork's myPath m_MISmode: Uniform/Balance/
    # Power, src/integrators/myPath/myPath.cpp class fields)
    mis_mode: int = 0           # 0=power, 1=balance, 2=uniform
    # approximate NEE visibility via the occupancy grid (fork's
    # myPath2_OM / LVCBPT_OM, src/integrators/testOM/myOM.h)
    occupancy_shadows: bool = False
    # integrator-specific knobs
    ao_length: float = -1.0     # <0 = unbounded occlusion rays
    hide_emitters: bool = False
    # tiledhdrfilm: stream row bands to disk (film/tiled.py)
    film_tiled: bool = False
    # spectral mode: Cauchy B coefficient (um^2) for dispersive
    # dielectrics in integrators/spectral.py (0 = no dispersion)
    cauchy_b: float = 0.0

    def resolve_chunk(self, width: int, height: int) -> int:
        if self.spp_chunk > 0:
            return min(self.spp_chunk, self.spp)
        target_rays = 1 << 19   # ~512k rays per wavefront batch
        c = max(1, target_rays // max(width * height, 1))
        while self.spp % c:
            c -= 1
        return min(c, self.spp)


# An integrator Li is: (scene, cam, o, d, stream, cfg) -> (N,3) radiance.
LiFn = Callable


def render(scene, cam, li_fn: LiFn, cfg: RenderConfig, sample_offset=0) -> jax.Array:
    """Full-frame render -> (H, W, 3) float32. Jit-compatible; differentiable
    w.r.t. scene leaves.

    sample_offset shifts the per-pixel sample indices (traced, no recompile):
    the progressive/checkpoint driver renders samples [offset, offset+spp)
    of the same global sample set (utils/checkpoint.py)."""
    w, h = cam.width, cam.height
    chunk = cfg.resolve_chunk(w, h)
    nchunks = cfg.spp // chunk
    n = w * h * chunk

    pixel_ids = jnp.arange(w * h, dtype=jnp.uint32)
    pixel_ids = jnp.repeat(pixel_ids, chunk)                       # pixel-major
    sample_slot = jnp.tile(jnp.arange(chunk, dtype=jnp.uint32), (w * h,))
    px_base = (pixel_ids % w).astype(jnp.float32)
    py_base = (pixel_ids // w).astype(jnp.float32)

    use_fast_film = cfg.filter == filmlib.FILTER_BOX

    def render_chunk(carry, ci):
        img, wgt = carry
        sample_ids = (sample_slot + ci.astype(jnp.uint32) * jnp.uint32(chunk)
                      + jnp.uint32(sample_offset))
        stream = SampleStream(jnp.uint32(cfg.seed), pixel_ids, sample_ids, 0,
                              kind=cfg.sampler, spp=cfg.spp)
        # pixel jitter + lens sample (sampler dims 0-3, like the reference's
        # sampleRayDifferential consuming samplePos/apertureSample)
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        px = px_base + jx
        py = py_base + jy
        from ..models import sensor as sensorlib

        o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)
        radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
        radiance = jnp.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
        if use_fast_film:
            img = img + jnp.sum(radiance.reshape(h, w, chunk, 3), axis=2)
            wgt = wgt + jnp.float32(chunk)
        else:
            ci_img, ci_wgt = filmlib.splat(w, h, px, py, radiance, cfg.filter)
            img = img + ci_img
            wgt = wgt + ci_wgt
        return (img, wgt), None

    img0 = jnp.zeros((h, w, 3), jnp.float32)
    wgt0 = jnp.zeros((h, w) if not use_fast_film else (), jnp.float32)
    (img, wgt), _ = jax.lax.scan(
        render_chunk, (img0, wgt0), jnp.arange(nchunks)
    )
    if use_fast_film:
        return img / jnp.maximum(wgt, 1e-8)
    return filmlib.develop(img, wgt)


from functools import lru_cache


@lru_cache(maxsize=128)
def _jitted_render(li_fn, cfg: RenderConfig):
    return jax.jit(
        lambda scene, cam, sample_offset: render(scene, cam, li_fn, cfg,
                                                 sample_offset)
    )


def render_jit(scene, cam, li_fn: LiFn, cfg: RenderConfig,
               sample_offset: int = 0) -> jax.Array:
    """Convenience: jit `render` treating cfg/li statically. The jitted
    callable is cached so repeated calls with the same (li, cfg) reuse the
    compiled executable; sample_offset is traced (no recompile per pass)."""
    return _jitted_render(li_fn, cfg)(scene, cam, jnp.uint32(sample_offset))


def power_heuristic(pdf_a: jax.Array, pdf_b: jax.Array) -> jax.Array:
    """Power heuristic (beta=2) MIS weight for strategy a
    (reference miWeight, src/integrators/path/path.cpp:176).

    Written in ratio form 1/(1 + (b/a)^2) so an infinite pdf_a (grazing
    area-light samples: dist^2/cos -> inf) yields weight 1 instead of the
    inf/inf = NaN of the naive a^2/(a^2+b^2) — masked-lane NaNs poison
    reverse-mode AD through 0*nan cotangents."""
    r = pdf_b / jnp.maximum(pdf_a, 1e-30)
    return jnp.where(pdf_a > 0.0, 1.0 / (1.0 + r * r), 0.0)


def balance_heuristic(pdf_a: jax.Array, pdf_b: jax.Array) -> jax.Array:
    r = pdf_b / jnp.maximum(pdf_a, 1e-30)
    return jnp.where(pdf_a > 0.0, 1.0 / (1.0 + r), 0.0)


def uniform_heuristic(pdf_a: jax.Array, pdf_b: jax.Array) -> jax.Array:
    """Uniform strategy weight: 1/2 wherever both strategies can produce
    the sample, else 1 (the fork's Uniform MIS mode, myPath.cpp)."""
    return jnp.where(pdf_a > 0.0, jnp.where(pdf_b > 0.0, 0.5, 1.0), 0.0)


def mis_weight(mode: int, pdf_a: jax.Array, pdf_b: jax.Array) -> jax.Array:
    """Dispatch on the static cfg.mis_mode (myPath m_MISmode switch)."""
    if mode == 1:
        return balance_heuristic(pdf_a, pdf_b)
    if mode == 2:
        return uniform_heuristic(pdf_a, pdf_b)
    return power_heuristic(pdf_a, pdf_b)
