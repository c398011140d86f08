"""Volumetric photon mapping with a stepped beam radiance estimate.

Analog of src/integrators/photonmapper/bre.cpp (192 LoC):
the reference builds a BVH over volume photons and intersects the camera
beam with per-photon spheres; here the beam integral is a fixed-step
jittered quadrature along the ray — each step queries a hash grid of
volume photons with a 3D kernel (static shapes, no per-photon tree), the
same trade the SPPM port makes for surface photons.

  photon pass: light paths scatter through the scene medium (distance
  sampling + HG phase), depositing a photon at every volume event;
  camera pass: L = sum_k Tr(0,t_k) * sigma_s(x_k) * L_i(x_k, w) * dt,
  L_i = (1 / (4/3 pi r^3)) * sum_p W_p * phase(w_p -> w).

Homogeneous and grid media both work (density modulates deposition and
transmittance through the medium module's samplers).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import uniform
from ..models import emitter as emitterlib
from ..models import medium as medlib
from ..models import phase as phaselib
from ..ops import hashgrid, trace
from .common import RenderConfig

MAX_VOL_BOUNCES = 4


def trace_volume_photons(scene, cfg: RenderConfig, n_paths: int, seed: int):
    """Light paths through scene.medium; returns (pos (P,3), dir (P,3),
    power (P,3), valid (P,)) with P = n_paths * MAX_VOL_BOUNCES."""
    med = scene.medium
    lanes = jnp.arange(n_paths, dtype=jnp.uint32)

    def u(dim):
        return uniform(jnp.uint32(seed), lanes, jnp.uint32(1), dim)

    ers = emitterlib.sample_emitter_ray(
        scene, u(0), jnp.stack([u(1), u(2)], -1), jnp.stack([u(3), u(4)], -1))
    o, d, beta = ers.o, ers.d, ers.beta

    ppos, pdir, ppow, pval = [], [], [], []
    active = jnp.max(beta, -1) > 0
    for b in range(MAX_VOL_BOUNCES):
        its = trace.closest_hit(scene, o, d)
        t_surf = jnp.where(its.valid, its.t, 1e30)
        if med.kind in (medlib.MEDIUM_GRID, medlib.MEDIUM_HGRID):
            t_m, is_med, w_med, w_surf = medlib.sample_distance_grid(
                med, lambda j: u(100 + b * 200 + j), o, d, t_surf)
        else:
            t_m, is_med, w_med, w_surf = medlib.sample_distance(
                med, u(10 + 8 * b), u(11 + 8 * b), t_surf)
        t_m = jnp.minimum(t_m, 3e7)
        event = active & is_med
        x = o + d * t_m[:, None]
        beta_evt = beta * w_med
        ppos.append(x)
        pdir.append(d)
        ppow.append(jnp.where(event[:, None], beta_evt, 0.0))
        pval.append(event)
        # continue by phase sampling
        u2 = jnp.stack([u(12 + 8 * b), u(13 + 8 * b)], -1)
        ph_ax = medlib.phase_axis(med, x)
        wo, pdf_ph = phaselib.sample(med.phase, med.g, -d, u2,
                                     med.phase_params, ph_ax)
        w_ph = phaselib.sample_weight(med.phase, med.g, -d, wo, pdf_ph,
                                      med.phase_params, ph_ax)
        o = x
        d = jnp.where(event[:, None], wo, d)
        beta = jnp.where(event[:, None], beta_evt * w_ph[:, None], 0.0)
        active = event
    return (jnp.concatenate(ppos), jnp.concatenate(pdir),
            jnp.concatenate(ppow), jnp.concatenate(pval))


def render(scene, cam, cfg: RenderConfig, n_paths: int = 1 << 16,
           steps: int = 32, radius: float | None = None,
           window: int = 64):
    """Beam-gathered volumetric render -> (H, W, 3). Surfaces contribute
    their directly visible emission only (the reference pairs bre with
    the photonmapper's surface estimate; pair with `direct` here)."""
    from ..models import sensor as sensorlib

    med = scene.medium
    assert med is not None, "bre needs a participating medium"
    w, h = cam.width, cam.height
    npix = w * h

    v = scene.vertices
    diag = jnp.linalg.norm(jnp.max(v, 0) - jnp.min(v, 0))
    r = radius if radius is not None else 0.02 * diag

    pos, pdir, ppow, pval = trace_volume_photons(
        scene, cfg, n_paths, cfg.seed + 3)
    grid = hashgrid.build(pos, pval, r)
    kernel = 1.0 / (4.0 / 3.0 * np.pi * r ** 3)

    lanes = jnp.arange(npix, dtype=jnp.uint32)

    def upix(dim):
        return uniform(jnp.uint32(cfg.seed), lanes, jnp.uint32(0), dim)

    px = (lanes % w).astype(jnp.float32) + upix(0)
    py = (lanes // w).astype(jnp.float32) + upix(1)
    o, d, imp = sensorlib.sample_rays(cam, px, py, upix(2)[:, None].repeat(2, 1))
    its = trace.closest_hit(scene, o, d)
    t_far = jnp.where(its.valid, its.t, 0.3 * diag * 3.0)

    dt = t_far / steps
    L = jnp.zeros((npix, 3))

    def step(carry, k):
        L = carry
        tk = (k.astype(jnp.float32) + upix(3)) * dt
        x = o + d * tk[:, None]

        def reduce_fn(acc, pidx, mask):
            ph_ax = medlib.phase_axis(
                med, jnp.broadcast_to(x[:, None, :],
                                      pdir[pidx].shape).reshape(-1, 3))
            ph_val, ph_pdf = phaselib.eval_pdf(
                med.phase, med.g,
                -pdir[pidx].reshape(-1, 3),
                jnp.broadcast_to(d[:, None, :], pdir[pidx].shape).reshape(-1, 3),
                med.phase_params, ph_ax)
            ph = ph_val.reshape(mask.shape)
            contrib = ppow[pidx] * ph[..., None]
            return acc + jnp.sum(
                jnp.where(mask[..., None], contrib, 0.0), axis=1)

        (li,), _ = hashgrid.query_sum(
            grid, pos, x, jnp.full((npix,), r),
            lambda c, i, msk: (reduce_fn(c[0], i, msk),),
            (jnp.zeros((npix, 3)),), window=window)
        li = li * kernel / n_paths
        dens = medlib.density_at(med, x) if med.kind in (medlib.MEDIUM_GRID, medlib.MEDIUM_HGRID) \
            else jnp.ones((npix,))
        sigma_s = med.sigma_t * med.albedo
        # transmittance to tk (closed form; jittered quadrature for grids)
        if med.kind in (medlib.MEDIUM_GRID, medlib.MEDIUM_HGRID):
            tr = medlib.transmittance_grid(med, o, d, tk, upix(4), steps=16)
        else:
            tr = jnp.exp(-med.sigma_t[None, :] * tk[:, None])
        L = L + tr * sigma_s[None, :] * dens[:, None] * li * dt[:, None]
        return L, None

    L, _ = jax.lax.scan(step, L, jnp.arange(steps, dtype=jnp.uint32))
    # directly visible emitters through the medium
    em_id = jnp.zeros((npix,), jnp.int32)
    si = trace.surface_interaction(scene, o, d, its)
    em_id = si["emitter"]
    cos_l = m.dot(si["wi_world"], si["ng"])
    le = scene.emitters.radiance[jnp.maximum(em_id, 0)]
    vis = its.valid & (em_id >= 0) & (cos_l > 0)
    tr_s = jnp.exp(-med.sigma_t[None, :] * jnp.minimum(t_far, 1e30)[:, None])
    L = L + jnp.where(vis[:, None], tr_s * le, 0.0)
    return (L * imp[:, None]).reshape(h, w, 3)


def render_jit(scene, cam, cfg: RenderConfig, **kw):
    return jax.jit(partial(render, cfg=cfg, **kw))(scene, cam)
