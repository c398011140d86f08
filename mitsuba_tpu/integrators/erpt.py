"""Energy redistribution path tracing (Cline et al. 2005).

Analog of src/integrators/erpt (erpt_proc.cpp): ordinary path
tracing generates seed paths; each seed's energy is redistributed over the
image by a short Metropolis chain in primary sample space, depositing a
fixed quantum per mutation. Like pssmlt.py, thousands of chains run in
lockstep as one wavefront; the chain machinery (vector stream, Kelemen
small steps) is shared with PSSMLT, but acceptance deposits EQUAL energy
(the redistribution idea) rather than luminance-weighted splats.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import RenderConfig
from .pssmlt import LUM, _eval, _small_step


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
           chain_length: int = 64, n_bootstrap: int = 1 << 17):
    """ERPT render -> (H, W, 3).

    Seeds are drawn by plain path tracing (uniform primary vectors); a seed
    with luminance L spawns a chain that deposits L_avg-sized quanta along
    `chain_length` small mutations (erpt.cpp's numChains/mutation logic,
    pooled over the whole wavefront)."""
    w, h = cam.width, cam.height
    from . import path as pathlib

    ndims = 4 + cfg.max_depth * 8
    key = jax.random.PRNGKey(cfg.seed ^ 0xE897)

    kb, kr, km = jax.random.split(key, 3)
    u_boot = jax.random.uniform(kb, (n_bootstrap, ndims))
    _, lum_boot, _ = _eval(scene, cam, cfg, u_boot)
    b = jnp.mean(lum_boot)   # mean image-plane luminance (the energy quantum
    #                          baseline, erpt.cpp computes the same)

    # seed selection proportional to luminance (each chain redistributes
    # one "energy packet"; selection prob ~ L makes packets equal-sized)
    cdf = jnp.cumsum(lum_boot)
    picks = jax.random.uniform(kr, (n_chains,)) * cdf[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, picks), 0, n_bootstrap - 1)
    u0 = u_boot[idx]
    c0, l0, p0 = _eval(scene, cam, cfg, u0)

    deposit = b / (chain_length)  # luminance quantum per mutation

    def step(carry, k):
        u_cur, c_cur, l_cur, p_cur, img = carry
        k1, k2, k3 = jax.random.split(k, 3)
        u_prop = _small_step(
            u_cur,
            jax.random.uniform(k1, (n_chains, ndims)),
            jax.random.uniform(k2, (n_chains, ndims)),
        )
        c_prop, l_prop, p_prop = _eval(scene, cam, cfg, u_prop)
        a = jnp.clip(l_prop / jnp.maximum(l_cur, 1e-12), 0.0, 1.0)

        # deposit the energy quantum split between the two states, colored
        # by each state's spectrum (Cline's equal-deposition rule)
        w_cur = (1.0 - a) * deposit / jnp.maximum(l_cur, 1e-12)
        w_prop = a * deposit / jnp.maximum(l_prop, 1e-12)
        w_cur = jnp.where(l_cur > 0, w_cur, 0.0)
        w_prop = jnp.where(l_prop > 0, w_prop, 0.0)
        img = img.at[p_cur].add(c_cur * w_cur[:, None])
        img = img.at[p_prop].add(c_prop * w_prop[:, None])

        accept = jax.random.uniform(k3, (n_chains,)) < a
        u_cur = jnp.where(accept[:, None], u_prop, u_cur)
        c_cur = jnp.where(accept[:, None], c_prop, c_cur)
        l_cur = jnp.where(accept, l_prop, l_cur)
        p_cur = jnp.where(accept, p_prop, p_cur)
        return (u_cur, c_cur, l_cur, p_cur, img), None

    img0 = jnp.zeros((w * h, 3))
    keys = jax.random.split(km, chain_length)
    (_, _, _, _, img), _ = jax.lax.scan(step, (u0, c0, l0, p0, img0), keys)
    img = img / n_chains * (w * h)
    return img.reshape(h, w, 3)


def render_jit(scene, cam, cfg: RenderConfig, **kw):
    return jax.jit(partial(render, cfg=cfg, **kw))(scene, cam)
