"""Primary-sample-space Metropolis light transport (Kelemen-style).

Analog of src/integrators/pssmlt (two-stage bootstrap at
pssmlt.cpp:331-335, Kelemen small/large mutations in pssmlt_sampler.cpp,
seed work units in pssmlt_proc.cpp:91): instead of a handful of
long chains farmed to workers, we run tens of thousands of SHORT chains in
lockstep — every chain is one lane of the wavefront, a mutation step is one
batched path evaluation, and the film update is a scatter-add of all chain
states. Seeding resamples bootstrap paths proportionally to luminance
(two-stage PSSMLT), which removes start-up bias in expectation exactly like
the reference.

The primary sample space vector u in [0,1]^D replaces the reference's lazy
PSSMLTSampler: dims 0-3 drive the sensor sample, each bounce consumes the
same 8-dim window as path.py, so the target function IS path.li evaluated
through a vector-backed sample stream.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rng import uniform
from .common import RenderConfig

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


class VectorStream:
    """SampleStream look-alike backed by an explicit (N, D) vector —
    the reference's ReplayableSampler/PSSMLTSampler analog."""

    __slots__ = ("u", "dim")

    def __init__(self, u):
        self.u = u
        self.dim = 0

    def at_dim(self, dim):
        return self.u[:, dim]

    def next_1d(self):
        v = self.u[:, self.dim]
        self.dim += 1
        return v

    def next_2d(self):
        v = self.u[:, self.dim:self.dim + 2]
        self.dim += 2
        return v


def _eval(scene, cam, cfg, u):
    """Target evaluation: primary vector -> (color, luminance, pixel idx)."""
    from ..models import sensor as sensorlib
    from . import path as pathlib

    w, h = cam.width, cam.height
    px = u[:, 0] * w
    py = u[:, 1] * h
    o, d, imp = sensorlib.sample_rays(cam, px, py, u[:, 2:4])
    stream = VectorStream(u)
    color = pathlib.li(scene, cam, o, d, stream, cfg) * imp[:, None]
    color = jnp.nan_to_num(color, nan=0.0, posinf=0.0, neginf=0.0)
    lum = jnp.matmul(color, LUM, precision=jax.lax.Precision.HIGHEST)
    xi = jnp.clip(px.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(py.astype(jnp.int32), 0, h - 1)
    return color, lum, yi * w + xi


def _small_step(u, r1, r2):
    """Kelemen mutation (pssmlt_sampler.cpp mutate): exponential-scale
    perturbation of every dim, wrapped to [0,1)."""
    s1, s2 = 1.0 / 1024.0, 1.0 / 64.0
    mag = s2 * jnp.exp(-jnp.log(s2 / s1) * r1)
    delta = jnp.where(r2 < 0.5, mag, -mag)
    return jnp.mod(u + delta, 1.0)


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
           n_mutations: int = 256, p_large: float = 0.3,
           n_bootstrap: int = 1 << 17):
    """PSSMLT render -> (H, W, 3).

    Total path evaluations = n_bootstrap + n_chains * n_mutations.
    """
    w, h = cam.width, cam.height
    ndims = SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE
    key = jax.random.PRNGKey(cfg.seed)

    # --- stage 1: bootstrap, b estimate, luminance-resampled seeds ------
    kb, kr, km = jax.random.split(key, 3)
    u_boot = jax.random.uniform(kb, (n_bootstrap, ndims))
    _, lum_boot, _ = _eval(scene, cam, cfg, u_boot)
    b = jnp.mean(lum_boot)
    cdf = jnp.cumsum(lum_boot)
    total = cdf[-1]
    picks = jax.random.uniform(kr, (n_chains,)) * total
    seed_idx = jnp.clip(jnp.searchsorted(cdf, picks), 0, n_bootstrap - 1)
    u0 = u_boot[seed_idx]
    c0, l0, p0 = _eval(scene, cam, cfg, u0)

    # --- stage 2: parallel Kelemen chains -------------------------------
    def step(carry, k):
        u_cur, c_cur, l_cur, p_cur, img = carry
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        large = jax.random.uniform(k1, (n_chains,)) < p_large
        u_fresh = jax.random.uniform(k2, (n_chains, ndims))
        u_small = _small_step(
            u_cur,
            jax.random.uniform(k3, (n_chains, ndims)),
            jax.random.uniform(k4, (n_chains, ndims)),
        )
        u_prop = jnp.where(large[:, None], u_fresh, u_small)
        c_prop, l_prop, p_prop = _eval(scene, cam, cfg, u_prop)

        a = jnp.clip(l_prop / jnp.maximum(l_cur, 1e-12), 0.0, 1.0)
        a = jnp.where(l_cur <= 0.0, jnp.where(l_prop > 0, 1.0, 0.0), a)

        # expected-value splatting (Kelemen): both states contribute
        w_cur = (1.0 - a) * b / jnp.maximum(l_cur, 1e-12)
        w_prop = a * b / jnp.maximum(l_prop, 1e-12)
        w_cur = jnp.where(l_cur > 0, w_cur, 0.0)
        w_prop = jnp.where(l_prop > 0, w_prop, 0.0)
        img = img.at[p_cur].add(c_cur * w_cur[:, None])
        img = img.at[p_prop].add(c_prop * w_prop[:, None])

        accept = jax.random.uniform(k5, (n_chains,)) < a
        u_cur = jnp.where(accept[:, None], u_prop, u_cur)
        c_cur = jnp.where(accept[:, None], c_prop, c_cur)
        l_cur = jnp.where(accept, l_prop, l_cur)
        p_cur = jnp.where(accept, p_prop, p_cur)
        return (u_cur, c_cur, l_cur, p_cur, img), None

    img0 = jnp.zeros((w * h, 3))
    keys = jax.random.split(km, n_mutations)
    (_, _, _, _, img), _ = jax.lax.scan(
        step, (u0, c0, l0, p0, img0), keys
    )
    # each mutation deposits expected weight b/(...) per chain; the image
    # estimator normalizes by samples-per-pixel-equivalent
    img = img / (n_chains * n_mutations) * (w * h)
    return img.reshape(h, w, 3)


def render_jit(scene, cam, cfg: RenderConfig, **kw):
    return jax.jit(partial(render, cfg=cfg, **kw))(scene, cam)
