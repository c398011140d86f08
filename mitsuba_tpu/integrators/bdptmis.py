"""Recursive MIS bookkeeping for the bidirectional tier (BDPT / LVC-BPT).

The reference computes Veach MIS weights by walking cached per-vertex
pdf arrays (libbidir's Path::miWeight over PathVertex pdf[] fields,
include/mitsuba/bidir/path.h). A wavefront can't afford per-connection
O(depth) re-walks over gathered vertices, so this module keeps the
*streaming* form of the same sums — the two recursive quantities
(here `dvcm`, `dvc`) popularized by the SmallVCM/VCM technical report
(Georgiev 2012, "Implementing Vertex Connection and Merging"; merging
terms dropped since this is pure BDPT):

  after scattering at a vertex with forward solid-angle pdf p_fwd,
  reverse pdf p_rev and outgoing cosine c:
      dvc  <- (c / p_fwd)^b * (dvc * p_rev^b + dvcm)
      dvcm <- (1 / p_fwd)^b
  and on arriving at the next vertex across distance d with incident
  cosine c_in:
      dvcm <- dvcm * d^(2b) / |c_in|^b ,   dvc <- dvc / |c_in|^b

`b` is the MIS exponent (1 = balance heuristic, 2 = power heuristic —
the fork's m_MISmode switch, myBDPT/LVCBPT.cpp:50-55). Every weight
formula below then needs only the junction-adjacent reverse pdfs, which
depend on the connection geometry and are evaluated at connection time.

Delta (specular) lobes zero `dvcm` and carry `dvc` through with the
cosine only — the Veach specular-chain pdf cancellation.

Russian roulette probabilities are deliberately EXCLUDED from every pdf
here: MIS weights are unbiased for any weights that sum to 1 over the
strategy set, which holds iff all strategies share one pdf definition.
The reference's libbidir makes the same choice.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as m
from ..models.emitter import (EV_AREA, EV_DIR, EV_ENV,
                              emitter_dir_pdf_area, emitter_hit_pdf)


class MisState(NamedTuple):
    dvcm: jax.Array   # (N,)
    dvc: jax.Array    # (N,)


def _mis(x, b):
    if b == 1.0:
        return x
    if b == 2.0:
        return x * x
    return x ** b


def light_start(ers, b) -> MisState:
    """State after sampling the emitter ray (pre first-hit update).

    With pdf_pos = the NEE/direct pdf of z0 in z0's own measure and
    pdf_dir the remaining ray pdf (models.emitter.EmitterRaySample
    conventions), dvcm = (direct/emission)^b = (1/pdf_dir)^b. dvc carries
    the s=0 eye-hit strategy: only emitters a random walk can hit (area,
    env) have one; its numerator cosine is the emission cosine for area
    lights and 1 for the infinite env."""
    dvcm = _mis(m.safe_div(1.0, ers.pdf_dir), b)
    cos0 = jnp.where(ers.kind == EV_AREA,
                     jnp.maximum(m.dot(ers.d, ers.ng), 0.0), 1.0)
    can_hit = (ers.kind == EV_AREA) | (ers.kind == EV_ENV)
    emission_pdf = ers.pdf_pos * ers.pdf_dir
    dvc = jnp.where(can_hit,
                    _mis(m.safe_div(cos0, emission_pdf), b), 0.0)
    return MisState(dvcm=dvcm, dvc=dvc)


def camera_start(n_light_paths, pdf_cam_sa, b, light_image: bool) -> MisState:
    """Camera-path state. dvcm is the t=1 (light-tracing splat) strategy's
    entry — n_light_paths light subpaths compete with the one eye path per
    pixel (bdpt_proc.cpp:163 minT=1 iff lightImage). Without a light image
    the t=1 strategy doesn't exist, so its term is zero."""
    n = pdf_cam_sa.shape[0]
    if not light_image:
        return MisState(dvcm=jnp.zeros((n,)), dvc=jnp.zeros((n,)))
    return MisState(
        dvcm=_mis(m.safe_div(jnp.float32(n_light_paths), pdf_cam_sa), b),
        dvc=jnp.zeros((n,)),
    )


def on_hit(st: MisState, dist2, cos_in, b, skip_dist2=None) -> MisState:
    """Arriving at a surface across dist2 with incident cosine cos_in.
    skip_dist2 masks lanes whose previous vertex is an infinite light
    (env/directional first segment: parallel-ray density, no 1/d^2)."""
    scale = _mis(dist2, b)
    if skip_dist2 is not None:
        scale = jnp.where(skip_dist2, 1.0, scale)
    c = _mis(jnp.maximum(jnp.abs(cos_in), 1e-8), b)
    return MisState(dvcm=st.dvcm * scale / c, dvc=st.dvc / c)


def scatter(st: MisState, pdf_fwd_sa, pdf_rev_sa, cos_out, is_delta,
            b) -> MisState:
    """Continuing the walk through a sampled lobe."""
    c = _mis(jnp.abs(cos_out), b)
    pf = _mis(m.safe_div(1.0, jnp.maximum(pdf_fwd_sa, 1e-20)), b)
    dvc_s = st.dvc * c                      # specular chain
    dvc_ns = c * pf * (st.dvc * _mis(pdf_rev_sa, b) + st.dvcm)
    return MisState(
        dvcm=jnp.where(is_delta, 0.0, pf),
        dvc=jnp.where(is_delta, dvc_s, dvc_ns),
    )


# ---------------------------------------------------------------------------
# Per-strategy weights. All bsdf pdfs are SOLID ANGLE; measure conversions
# live inside dvcm/dvc and the emitter pdf helpers.
# ---------------------------------------------------------------------------


def weight_hit_area(st: MisState, direct_pdf_a, emission_pdf, b):
    """Eye path hits an area emitter (the s=0 strategy). direct_pdf_a =
    NEE area pdf of the hit point incl. pick prob; emission_pdf =
    pdf_pos*pdf_dir of emitting the arriving ray."""
    w_cam = _mis(direct_pdf_a, b) * st.dvcm + _mis(emission_pdf, b) * st.dvc
    return 1.0 / (1.0 + w_cam)


def weight_hit_env(st_pre: MisState, direct_pdf_sa, disk_pdf, b):
    """Eye path escapes to the environment. Uses the PRE-on-hit state
    (the env vertex's measure is solid angle)."""
    w_cam = (_mis(direct_pdf_sa, b) * st_pre.dvcm
             + _mis(direct_pdf_sa * disk_pdf, b) * st_pre.dvc)
    return 1.0 / (1.0 + w_cam)


def weight_connect_z0(st_y: MisState, ers_kind, z0_pos, z0_ng, z0_aux,
                      z0_cut, z0_pdf_pos, disk_pdf,
                      y_p, y_ng, pdf_y_sa, pdf_y_rev_sa, b):
    """Eye vertex y connects to the light-path origin z0 (the s=1 / NEE
    strategy). pdf_y_sa: y scatters toward z0; pdf_y_rev_sa: y scatters
    back toward its predecessor given incoming from z0."""
    # strategy s=0: eye walk hits z0 instead (0 for delta lights)
    p_hit = emitter_hit_pdf(ers_kind, z0_pos, z0_ng, y_p, pdf_y_sa)
    w_light = _mis(m.safe_div(p_hit, jnp.maximum(z0_pdf_pos, 1e-20)), b)
    # strategies s>=2: the light walk continues past z0 to y and beyond
    p_emit_area = emitter_dir_pdf_area(ers_kind, z0_pos, z0_ng, z0_aux,
                                       z0_cut, disk_pdf, y_p, y_ng)
    w_cam = _mis(p_emit_area, b) * (st_y.dvcm
                                    + st_y.dvc * _mis(pdf_y_rev_sa, b))
    return 1.0 / (w_light + 1.0 + w_cam)


def weight_connect_inner(st_y: MisState, st_z: MisState,
                         pdf_y_sa, pdf_y_rev_sa, pdf_z_sa, pdf_z_rev_sa,
                         cos_y, cos_z, d2, b):
    """Inner connection y_t <-> z_s (both surface vertices, s>=2, t>=2).
    pdf_y_sa: y scatters toward z; pdf_z_sa: z scatters toward y;
    *_rev_sa: each re-scatters toward its own predecessor given incoming
    from the connection. cos_y/cos_z: |n . connection dir| at each end."""
    pdf_y_to_z_area = pdf_y_sa * jnp.abs(cos_z) / jnp.maximum(d2, 1e-12)
    pdf_z_to_y_area = pdf_z_sa * jnp.abs(cos_y) / jnp.maximum(d2, 1e-12)
    w_light = _mis(pdf_y_to_z_area, b) * (
        st_z.dvcm + st_z.dvc * _mis(pdf_z_rev_sa, b))
    w_cam = _mis(pdf_z_to_y_area, b) * (
        st_y.dvcm + st_y.dvc * _mis(pdf_y_rev_sa, b))
    return 1.0 / (w_light + 1.0 + w_cam)


def weight_splat(st_z: MisState, pdf_cam_area, n_light_paths,
                 pdf_z_rev_sa, b):
    """Light vertex z splats to the camera (the t=1 strategy).
    pdf_cam_area: camera importance pdf at z in area measure
    (W/(d^2) conversion); pdf_z_rev_sa: z re-scatters toward its
    predecessor given incoming from the camera."""
    w_light = _mis(pdf_cam_area / jnp.float32(n_light_paths), b) * (
        st_z.dvcm + st_z.dvc * _mis(pdf_z_rev_sa, b))
    return 1.0 / (w_light + 1.0)


def weight_splat_z0(z0_pdf_pos, pdf_cam_area, n_light_paths, is_area, b):
    """The (s=1, t=1) strategy: the emitter vertex itself splats to the
    camera (a directly visible light). The only competing strategy for a
    1-edge path is the eye ray hitting the emitter (s=0)."""
    r = m.safe_div(pdf_cam_area,
                   jnp.float32(n_light_paths) * jnp.maximum(z0_pdf_pos, 1e-20))
    return jnp.where(is_area, 1.0 / (1.0 + _mis(r, b)), 0.0)
