"""Classic two-map photon mapper (Jensen).

Analog of src/integrators/photonmapper/photonmapper.cpp: one
big photon shooting pass builds TWO maps split by path class
(gatherproc.h ECausticPhotons / ESurfacePhotons):

  * caustic map — deposits whose PREVIOUS bounce was a delta lobe
    (L S+ D paths), looked up directly at the camera gather point with a
    tight radius;
  * indirect map — deposits with at least one earlier non-delta bounce
    (L D .+ D paths), covering multi-bounce diffuse transport.

Direct illumination and the first specular chain come from the analytic
camera pass shared with SPPM (emitted light + NEE). The reference's
balanced kd-tree + kNN lookups become the wavefront spatial hash of
ops/hashgrid.py with a fixed scene-scaled radius (the batched redesign:
fixed-radius density estimation instead of kNN — kNN's per-query
variable work is lockstep-hostile; radius control is the
`radius_scale` knob). Biased like the original; SPPM remains the
consistent progressive alternative."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..models import bsdf as bsdflib
from ..ops import hashgrid
from .common import RenderConfig
from .sppm import _camera_pass, _photon_pass


def render(scene, cam, cfg: RenderConfig, n_photons: int = 1 << 18,
           n_passes: int = 4, radius_scale: float = 1.0,
           window: int = 64):
    """-> (H, W, 3). n_passes camera samples per pixel are averaged;
    the photon maps are shot once per pass as well (photonCount
    analog)."""
    w, h = cam.width, cam.height
    npix = w * h
    ext = jnp.max(jnp.max(scene.vertices, 0) - jnp.min(scene.vertices, 0))
    r_global = float(ext) * 5.0 / max(w, h) * radius_scale
    r_caustic = r_global * 0.5
    families = scene.bsdf_families
    max_depth = cfg.max_depth

    @jax.jit
    def one_pass(pass_idx):
        gp = _camera_pass(scene, cam, cfg, pass_idx)
        pos, pdir, ppow, pvalid, pdepth, pprev = _photon_pass(
            scene, cfg, pass_idx, n_photons, max_depth, with_tags=True)
        # map split (photonmapper.cpp shoots caustic + surface maps)
        caustic = pvalid & pprev & (pdepth >= 1)
        indirect = pvalid & ~pprev & (pdepth >= 1)

        sp = bsdflib.gather_shade_point(scene, gp["mat"], gp["uv"])

        def estimate(valid_mask, radius):
            grid = hashgrid.build(pos, valid_mask, radius)

            def reduce_fn(carry, pidx, mask):
                flux = carry[0]
                wo_local = m.to_local(gp["ns"][:, None, :], pdir[pidx])
                wi_local = m.to_local(gp["ns"][:, None, :],
                                      gp["wi"][:, None, :])
                sp_b = bsdflib.ShadePoint(*(
                    (None if x is None
                     else x[:, None] if x.ndim == 1 else x[:, None, :])
                    for x in sp))
                f, _ = bsdflib.eval_pdf(sp_b, wi_local, wo_local, families)
                cos_o = jnp.maximum(m.cos_theta(wo_local), 1e-6)
                contrib = f / cos_o[..., None] * ppow[pidx]
                keep = mask & valid_mask[pidx]
                flux = flux + jnp.where(keep[..., None], contrib, 0.0).sum(1)
                return (flux,)

            (flux,), _ = hashgrid.query_sum(
                grid, pos, gp["pos"], jnp.full((npix,), radius), reduce_fn,
                (jnp.zeros((npix, 3)),), window=window)
            return flux / (jnp.pi * radius * radius * n_photons)

        li = estimate(indirect, r_global) + estimate(caustic, r_caustic)
        li = jnp.where(gp["valid"][:, None], li * gp["beta"], 0.0)
        return gp["direct"] + li

    img = jnp.zeros((npix, 3))
    for i in range(n_passes):
        img = img + one_pass(jnp.asarray(i))
    return (img / n_passes).reshape(h, w, 3)
