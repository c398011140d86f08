"""Virtual point light renderer — the interactive-preview workhorse.

Analog of the reference's VPL machinery: generateVPLs' random
walk (src/librender/vpl.cpp:76) is the LVC-BPT light-cache builder, and the
GPU preview's per-VPL accumulation (src/mtsgui/preview.h:73-77, integrator
plugin src/integrators/vpl/vpl.cpp) becomes: one eye hit per pixel, then M
sampled VPL connections with clamped geometry terms (the classic VPL bias
for fireflies, vpl.cpp m_clamping). Much cheaper than path tracing —
intended as the preview/draft mode, like the reference GUI's progressive
preview.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..ops import trace
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from .common import RenderConfig
from .lvcbpt import build_light_cache

RAY_EPS = 1e-3
CLAMP_DIST2 = 0.05  # geometry-term clamp (vpl.cpp m_clamping analog)


def li(scene, cam, o, d, stream, cfg: RenderConfig) -> jax.Array:
    n = o.shape[0]
    families = scene.bsdf_families
    n_paths = max(n // 16, 256)
    M = 8
    cache = build_light_cache(scene, cfg, n_paths, 1.0)
    V = cache.pos.shape[0]

    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    ns, ng, p = si["ns"], si["ng"], si["p"]
    wi_local = m.to_local(ns, si["wi_world"])
    active = its.valid

    # visible emitters + env
    em_id = si["emitter"]
    cos_l = m.dot(si["wi_world"], ng)
    le = scene.emitters.radiance[jnp.maximum(em_id, 0)]
    L = jnp.where((active & (em_id >= 0) & (cos_l > 0))[:, None], le, 0.0)
    L = L + jnp.where(active[:, None], 0.0, emitterlib.env_radiance(scene, d))

    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])

    for j in range(M):
        uj = stream.at_dim(4 + j)
        vidx = jnp.minimum((uj * V).astype(jnp.int32), V - 1)
        lp = cache.pos[vidx]
        lns = cache.ns[vidx]
        lbeta = cache.beta[vidx]
        lmat = cache.mat[vidx]
        lvalid = cache.valid[vidx]
        to_l = lp - p
        d2 = jnp.maximum(m.dot(to_l, to_l), CLAMP_DIST2)  # clamped G
        dist = m.length(to_l)
        cdir = to_l / jnp.maximum(dist, 1e-9)[:, None]
        wo_local = m.to_local(ns, cdir)
        f_e, _ = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        is_emit = lmat < 0
        cos_le = jnp.maximum(m.dot(lns, -cdir), 0.0)
        l_wi = m.to_local(lns, cache.wi[vidx])
        l_wo = m.to_local(lns, -cdir)
        sp_l = bsdflib.gather_shade_point(scene, jnp.maximum(lmat, 0),
                                          cache.uv[vidx])
        f_l, _ = bsdflib.eval_pdf(sp_l, l_wi, l_wo, families)
        light_term = jnp.where(is_emit[:, None],
                               cos_le[:, None] * jnp.ones(3), f_l)
        contrib = f_e * light_term * lbeta * (
            jnp.float32(V) / (M * n_paths) / d2
        )[:, None]
        ok = active & lvalid & (jnp.max(contrib, -1) > 0)
        blocked = trace.any_hit(scene, p, cdir, dist)
        L = L + jnp.where((ok & ~blocked)[:, None], contrib, 0.0)

    return L
