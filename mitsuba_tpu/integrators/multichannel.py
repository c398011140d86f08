"""Multichannel rendering: radiance + AOVs in one jitted pass.

Analog of src/integrators/misc/multichannel.cpp (run several
sub-integrators and write a multi-layer result): the wavefront evaluates
every requested channel per ray batch — the AOVs reuse the primary
intersection, so the extra channels are nearly free.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..ops import trace
from .common import RenderConfig


def render(scene, cam, cfg: RenderConfig, channels=("radiance", "depth",
                                                    "normal", "albedo")):
    """Returns dict channel -> (H, W, 3) float32 arrays."""
    from . import common as cm, path
    from ..models import bsdf as bsdflib, sensor as sensorlib
    from ..core.rng import SampleStream

    w, h = cam.width, cam.height
    npix = w * h
    spp = cfg.spp

    def fn(scene, cam):
        pids = jnp.repeat(jnp.arange(npix, dtype=jnp.uint32), spp)
        slot = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), (npix,))
        stream = SampleStream(jnp.uint32(cfg.seed), pids, slot, 0,
                              kind=cfg.sampler, spp=spp)
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        px = (pids % w).astype(jnp.float32) + jx
        py = (pids // w).astype(jnp.float32) + jy
        o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)

        outs = {}
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        if "radiance" in channels:
            rad = path.li(scene, cam, o, d, stream, cfg) * imp[:, None]
            outs["radiance"] = jnp.nan_to_num(rad)
        if "depth" in channels:
            outs["depth"] = jnp.repeat(
                jnp.where(its.valid, its.t, 0.0)[:, None], 3, -1)
        if "normal" in channels:
            outs["normal"] = jnp.where(its.valid[:, None], si["ns"], 0.0)
        if "position" in channels:
            outs["position"] = jnp.where(its.valid[:, None], si["p"], 0.0)
        if "albedo" in channels:
            sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
            outs["albedo"] = jnp.where(its.valid[:, None], sp.reflectance, 0.0)
        return {
            k: jnp.mean(v.reshape(h, w, spp, 3), axis=2)
            for k, v in outs.items()
        }

    return jax.jit(fn)(scene, cam)
