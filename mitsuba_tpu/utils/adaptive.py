"""Adaptive sampling driver (t-test-guided supersampling).

Analog of src/integrators/misc/adaptive.cpp: the reference
supersamples 32x32 blocks whose sample mean fails a t-test against the
configured relative error. Blocks make no sense on a wavefront machine;
instead every refinement pass picks the K pixels with the widest relative
confidence interval (one jax.lax.top_k — K is static so shapes stay fixed)
and renders `batch_spp` more samples for exactly those pixels, using the
same pure (pixel, sample-index) streams so refinement composes with the
base pass unbiasedly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rng import SampleStream
from ..integrators.common import RenderConfig

LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _accumulate(scene, cam, li_fn, cfg, pixel_ids, sample_base, n_samples):
    """Render n_samples for each given pixel; returns (sum_rgb (K,3),
    sum_lum_sq (K,))."""
    from ..models import sensor as sensorlib

    k = pixel_ids.shape[0]
    w = cam.width
    pids = jnp.repeat(pixel_ids, n_samples)
    slot = jnp.tile(jnp.arange(n_samples, dtype=jnp.uint32), (k,))
    sample_ids = slot + sample_base.repeat(n_samples).astype(jnp.uint32)
    stream = SampleStream(jnp.uint32(cfg.seed), pids, sample_ids, 0,
                          kind=cfg.sampler, spp=cfg.spp)
    jx = stream.next_1d()
    jy = stream.next_1d()
    u_lens = stream.next_2d()
    px = (pids % w).astype(jnp.float32) + jx
    py = (pids // w).astype(jnp.float32) + jy
    o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)
    radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
    radiance = jnp.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
    r = radiance.reshape(k, n_samples, 3)
    lum = r @ LUM
    return r.sum(1), (lum * lum).sum(1)


def render_adaptive(scene, cam, li_fn, cfg: RenderConfig,
                    base_spp: int = 16, batch_spp: int = 16,
                    max_spp: int = 256, max_error: float = 0.05,
                    refine_frac: float = 0.25):
    """Adaptive render -> (image (H,W,3), spp_map (H,W)).

    Pixels whose 95% CI of mean luminance exceeds max_error * mean keep
    receiving batches until max_spp (adaptive.cpp maxError/pValue logic).
    """
    w, h = cam.width, cam.height
    npix = w * h
    k = max(int(npix * refine_frac), 1)

    all_pix = jnp.arange(npix, dtype=jnp.uint32)
    sum_rgb, sum_l2 = _accumulate(scene, cam, li_fn, cfg, all_pix,
                                  jnp.zeros((npix,), jnp.uint32), base_spp)
    n = jnp.full((npix,), base_spp, jnp.float32)

    refine = jax.jit(lambda s, c, pix, base: _accumulate(
        s, c, li_fn, cfg, pix, base, batch_spp))

    max_rounds = max((max_spp - base_spp) // batch_spp, 0)
    for _ in range(max_rounds):
        mean_l = (sum_rgb @ LUM) / n
        var = jnp.maximum(sum_l2 / n - mean_l * mean_l, 0.0)
        ci = 1.96 * jnp.sqrt(var / n)
        score = ci / jnp.maximum(mean_l, 1e-4)
        score = jnp.where(n >= max_spp, -1.0, score)
        if float(jnp.max(score)) <= max_error:
            break
        _, idx = jax.lax.top_k(score, k)
        idx = idx.astype(jnp.uint32)
        add_rgb, add_l2 = refine(scene, cam, idx, n[idx].astype(jnp.uint32))
        sum_rgb = sum_rgb.at[idx].add(add_rgb)
        sum_l2 = sum_l2.at[idx].add(add_l2)
        n = n.at[idx].add(batch_spp)

    img = (sum_rgb / n[:, None]).reshape(h, w, 3)
    return np.asarray(img), np.asarray(n.reshape(h, w))
