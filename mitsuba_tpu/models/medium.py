"""Participating media: homogeneous (and grid-density heterogeneous).

Analog of src/medium/homogeneous.cpp (closed-form transmittance,
per-channel distance sampling) and Medium::sampleDistance/evalTransmittance
(include/mitsuba/render/medium.h:120,151). The medium is a scene-global
pytree leaf (sigma_t/albedo differentiable); heterogeneous grids use
ratio/delta tracking over a dense density grid (src/medium/heterogeneous.cpp
+ src/volume/gridvolume.cpp analog).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import math as m
from . import phase as phaselib

MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1
MEDIUM_HGRID = 2       # block-sparse hierarchical grid (hgridvolume.cpp)


@struct.dataclass
class Medium:
    sigma_t: jax.Array    # (3,) extinction
    albedo: jax.Array     # (3,) single-scattering albedo (sigma_s/sigma_t)
    g: jax.Array          # () HG asymmetry
    # grid media (kind=MEDIUM_GRID): density modulates sigma_t
    density: jax.Array = None          # (D,H,W) or (1,1,1); for
                                       # MEDIUM_HGRID: (NB, bz, by, bx)
    box_min: jax.Array = None          # (3,)
    box_max: jax.Array = None          # (3,)
    # hierarchical grids: (BZ,BY,BX) int32 cell -> block id, -1 = empty
    block_table: jax.Array = None
    # optional per-voxel fiber axis (D,H,W,3) over the same box — the
    # reference's orientation volumes (kkay.cpp mRec.orientation,
    # heterogeneous.cpp m_orientation); None = static phase_params axis
    orientation: jax.Array = None
    kind: int = struct.field(pytree_node=False, default=MEDIUM_HOMOGENEOUS)
    phase: int = struct.field(pytree_node=False, default=phaselib.PHASE_HG)
    # static parameter tuple for kkay/mixture phases (phase.py docstring)
    phase_params: tuple = struct.field(pytree_node=False, default=())


def make_homogeneous(sigma_s, sigma_a, g=0.0,
                     phase: int = phaselib.PHASE_HG,
                     phase_params: tuple = ()) -> Medium:
    sigma_s = jnp.asarray(sigma_s, jnp.float32) * jnp.ones(3, jnp.float32)
    sigma_a = jnp.asarray(sigma_a, jnp.float32) * jnp.ones(3, jnp.float32)
    sigma_t = sigma_s + sigma_a
    albedo = jnp.where(sigma_t > 0, sigma_s / jnp.maximum(sigma_t, 1e-20), 0.0)
    return Medium(
        sigma_t=sigma_t, albedo=albedo, g=jnp.float32(g),
        density=jnp.ones((1, 1, 1), jnp.float32),
        box_min=jnp.zeros(3, jnp.float32), box_max=jnp.ones(3, jnp.float32),
        kind=MEDIUM_HOMOGENEOUS, phase=phase, phase_params=phase_params,
    )


def make_grid(density: np.ndarray, sigma_t_scale, albedo, g=0.0,
              box_min=(0, 0, 0), box_max=(1, 1, 1),
              phase: int = phaselib.PHASE_HG,
              phase_params: tuple = (), orientation=None) -> Medium:
    """Heterogeneous medium: sigma_t(x) = density(x) * sigma_t_scale.
    `orientation` is an optional (D,H,W,3) per-voxel fiber-axis grid for
    the kkay/microflake phases (orientation volumes)."""
    return Medium(
        sigma_t=jnp.asarray(sigma_t_scale, jnp.float32) * jnp.ones(3),
        albedo=jnp.asarray(albedo, jnp.float32) * jnp.ones(3),
        g=jnp.float32(g),
        density=jnp.asarray(density, jnp.float32),
        box_min=jnp.asarray(box_min, jnp.float32),
        box_max=jnp.asarray(box_max, jnp.float32),
        orientation=None if orientation is None
        else jnp.asarray(orientation, jnp.float32),
        kind=MEDIUM_GRID, phase=phase, phase_params=phase_params,
    )


def make_hgrid(block_table: np.ndarray, block_data: np.ndarray,
               sigma_t_scale, albedo, g=0.0,
               box_min=(0, 0, 0), box_max=(1, 1, 1),
               phase: int = phaselib.PHASE_HG,
               phase_params: tuple = ()) -> Medium:
    """Block-sparse hierarchical grid medium (hgridvolume.cpp).

    The reference keeps a cell grid of per-block gridvolume plugins and
    virtual-dispatches per lookup; here empty cells are a -1 row in one
    int32 table and the occupied blocks stack into a single (NB,bz,by,bx)
    array, so a lookup is two static gathers — no pointers, no dispatch."""
    return Medium(
        sigma_t=jnp.asarray(sigma_t_scale, jnp.float32) * jnp.ones(3),
        albedo=jnp.asarray(albedo, jnp.float32) * jnp.ones(3),
        g=jnp.float32(g),
        density=jnp.asarray(block_data, jnp.float32),
        box_min=jnp.asarray(box_min, jnp.float32),
        box_max=jnp.asarray(box_max, jnp.float32),
        block_table=jnp.asarray(block_table, jnp.int32),
        kind=MEDIUM_HGRID, phase=phase, phase_params=phase_params,
    )


def bake_dense(med: Medium, resolution) -> Medium:
    """volcache.cpp analog: evaluate any medium's density onto a dense
    grid. The reference caches expensive hierarchical lookups in runtime
    blocks; here the dense array IS the fast path, so caching becomes a
    one-time load-side bake (resolution-controlled)."""
    d, h, w = resolution
    zs = (jnp.arange(d) + 0.5) / d
    ys = (jnp.arange(h) + 0.5) / h
    xs = (jnp.arange(w) + 0.5) / w
    Z, Y, X = jnp.meshgrid(zs, ys, xs, indexing="ij")
    rel = jnp.stack([X, Y, Z], -1).reshape(-1, 3)
    pts = med.box_min + rel * (med.box_max - med.box_min)
    dens = density_at(med, pts).reshape(d, h, w)
    return Medium(
        sigma_t=med.sigma_t, albedo=med.albedo, g=med.g,
        density=dens, box_min=med.box_min, box_max=med.box_max,
        kind=MEDIUM_GRID, phase=med.phase, phase_params=med.phase_params,
    )


def _density_hgrid(med: Medium, p: jax.Array) -> jax.Array:
    """Block-sparse lookup: cell gather -> in-block trilinear
    (hgridvolume.cpp lookupFloat, minus the virtual dispatch)."""
    rel = (p - med.box_min) / jnp.maximum(med.box_max - med.box_min, 1e-9)
    inside = jnp.all((rel >= 0.0) & (rel <= 1.0), axis=-1)
    BZ, BY, BX = med.block_table.shape
    cx = jnp.clip((rel[..., 0] * BX).astype(jnp.int32), 0, BX - 1)
    cy = jnp.clip((rel[..., 1] * BY).astype(jnp.int32), 0, BY - 1)
    cz = jnp.clip((rel[..., 2] * BZ).astype(jnp.int32), 0, BZ - 1)
    bid = med.block_table[cz, cy, cx]
    occupied = bid >= 0
    b = jnp.maximum(bid, 0)
    # local coords within the cell, trilinear inside the block
    lx = jnp.clip(rel[..., 0] * BX - cx, 0.0, 1.0)
    ly = jnp.clip(rel[..., 1] * BY - cy, 0.0, 1.0)
    lz = jnp.clip(rel[..., 2] * BZ - cz, 0.0, 1.0)
    _, bd, bh, bw = med.density.shape
    fx = lx * (bw - 1)
    fy = ly * (bh - 1)
    fz = lz * (bd - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, max(bw - 2, 0))
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, max(bh - 2, 0))
    z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, max(bd - 2, 0))
    tx = jnp.clip(fx - x0, 0.0, 1.0)
    ty = jnp.clip(fy - y0, 0.0, 1.0)
    tz = jnp.clip(fz - z0, 0.0, 1.0)
    x1 = jnp.minimum(x0 + 1, bw - 1)
    y1 = jnp.minimum(y0 + 1, bh - 1)
    z1 = jnp.minimum(z0 + 1, bd - 1)
    g = med.density
    c = (
        g[b, z0, y0, x0] * (1 - tx) * (1 - ty) * (1 - tz)
        + g[b, z0, y0, x1] * tx * (1 - ty) * (1 - tz)
        + g[b, z0, y1, x0] * (1 - tx) * ty * (1 - tz)
        + g[b, z0, y1, x1] * tx * ty * (1 - tz)
        + g[b, z1, y0, x0] * (1 - tx) * (1 - ty) * tz
        + g[b, z1, y0, x1] * tx * (1 - ty) * tz
        + g[b, z1, y1, x0] * (1 - tx) * ty * tz
        + g[b, z1, y1, x1] * tx * ty * tz
    )
    return jnp.where(inside & occupied, c, 0.0)


def orientation_at(med: Medium, p: jax.Array) -> jax.Array:
    """Trilinear fiber-axis lookup (gridvolume.cpp lookupVector: the
    reference interpolates then normalizes). Degenerate interpolants
    (opposing axes cancelling) and out-of-box points fall back to +z so
    the phase frame stays well-defined."""
    rel = (p - med.box_min) / jnp.maximum(med.box_max - med.box_min, 1e-9)
    o_ = med.orientation
    d_, h_, w_ = o_.shape[:3]
    fx = rel[..., 0] * (w_ - 1)
    fy = rel[..., 1] * (h_ - 1)
    fz = rel[..., 2] * (d_ - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, max(w_ - 2, 0))
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, max(h_ - 2, 0))
    z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, max(d_ - 2, 0))
    tx = jnp.clip(fx - x0, 0.0, 1.0)[..., None]
    ty = jnp.clip(fy - y0, 0.0, 1.0)[..., None]
    tz = jnp.clip(fz - z0, 0.0, 1.0)[..., None]
    x1 = jnp.minimum(x0 + 1, w_ - 1)
    y1 = jnp.minimum(y0 + 1, h_ - 1)
    z1 = jnp.minimum(z0 + 1, d_ - 1)
    v = (
        o_[z0, y0, x0] * (1 - tx) * (1 - ty) * (1 - tz)
        + o_[z0, y0, x1] * tx * (1 - ty) * (1 - tz)
        + o_[z0, y1, x0] * (1 - tx) * ty * (1 - tz)
        + o_[z0, y1, x1] * tx * ty * (1 - tz)
        + o_[z1, y0, x0] * (1 - tx) * (1 - ty) * tz
        + o_[z1, y0, x1] * tx * (1 - ty) * tz
        + o_[z1, y1, x0] * (1 - tx) * ty * tz
        + o_[z1, y1, x1] * tx * ty * tz
    )
    ln = jnp.linalg.norm(v, axis=-1, keepdims=True)
    fallback = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), v.shape)
    return jnp.where(ln > 1e-6, v / jnp.maximum(ln, 1e-6), fallback)


def phase_axis(med: Medium, p: jax.Array):
    """Per-lane fiber axis for the phase function at points p, or None
    when the medium has no orientation volume (static params axis)."""
    if med.orientation is None:
        return None
    return orientation_at(med, p)


def density_at(med: Medium, p: jax.Array) -> jax.Array:
    """Trilinear density lookup in the grid's box; 0 outside
    (gridvolume.cpp lookupFloat; hgridvolume.cpp for block-sparse)."""
    if med.kind == MEDIUM_HGRID:
        return _density_hgrid(med, p)
    rel = (p - med.box_min) / jnp.maximum(med.box_max - med.box_min, 1e-9)
    inside = jnp.all((rel >= 0.0) & (rel <= 1.0), axis=-1)
    d_, h_, w_ = med.density.shape
    # grid is indexed [z, y, x] like gridvolume's row-major layout
    fx = rel[..., 0] * (w_ - 1)
    fy = rel[..., 1] * (h_ - 1)
    fz = rel[..., 2] * (d_ - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, max(w_ - 2, 0))
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, max(h_ - 2, 0))
    z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, max(d_ - 2, 0))
    tx = jnp.clip(fx - x0, 0.0, 1.0)
    ty = jnp.clip(fy - y0, 0.0, 1.0)
    tz = jnp.clip(fz - z0, 0.0, 1.0)
    x1 = jnp.minimum(x0 + 1, w_ - 1)
    y1 = jnp.minimum(y0 + 1, h_ - 1)
    z1 = jnp.minimum(z0 + 1, d_ - 1)
    g = med.density
    c = (
        g[z0, y0, x0] * (1 - tx) * (1 - ty) * (1 - tz)
        + g[z0, y0, x1] * tx * (1 - ty) * (1 - tz)
        + g[z0, y1, x0] * (1 - tx) * ty * (1 - tz)
        + g[z0, y1, x1] * tx * ty * (1 - tz)
        + g[z1, y0, x0] * (1 - tx) * (1 - ty) * tz
        + g[z1, y0, x1] * tx * (1 - ty) * tz
        + g[z1, y1, x0] * (1 - tx) * ty * tz
        + g[z1, y1, x1] * tx * ty * tz
    )
    return jnp.where(inside, c, 0.0)


# ---------------------------------------------------------------------------
# Homogeneous closed forms (homogeneous.cpp)
# ---------------------------------------------------------------------------

def transmittance(med: Medium, dist: jax.Array) -> jax.Array:
    """Tr over a straight segment of length dist: (N,3)."""
    return jnp.exp(-med.sigma_t[None, :] * jnp.minimum(dist, 1e30)[:, None])


def transmittance_grid(med: Medium, o, d, dist, u, steps: int = 32) -> jax.Array:
    """Ratio-tracking-free quadrature transmittance for grid media:
    jittered Riemann sum of sigma_t along the segment (deterministic step
    count keeps shapes static; `u` jitters to stay unbiased in expectation)."""
    dt = dist / steps
    ts = (jnp.arange(steps)[None, :] + u[:, None]) * dt[:, None]
    pts = o[:, None, :] + d[:, None, :] * ts[..., None]
    dens = density_at(med, pts.reshape(-1, 3)).reshape(o.shape[0], steps)
    optical = (dens * dt[:, None]).sum(-1)
    return jnp.exp(-med.sigma_t[None, :] * optical[:, None])


# ---------------------------------------------------------------------------
# Grid-medium unbiased tracking (heterogeneous.cpp sampleDistance /
# evalTransmittance analog). Both walks use a FIXED unrolled collision
# budget instead of lax.while_loop: a static unroll compiles leaner and
# is reverse-differentiable. Lanes whose collision budget runs
# out are treated as reaching the surface carrying their accumulated
# weight — the truncation bias is ~P(#collisions > budget), negligible
# when the budget covers several majorant mean-free-paths.
# ---------------------------------------------------------------------------

TRACK_STEPS = 48


MAJORANT_BOOST = 1.5


def _majorant(med: Medium):
    """Scalar majorant extinction over the grid (sigma_t max-channel x
    max density x boost). The boost keeps the null-collision probability
    strictly positive even at max-density points — with a tight majorant
    the spectral history weights of the sub-maximal channels would be
    starved (their null continuations have probability 0), biasing Tr
    toward the max channel. Density outside the box is 0 (nulls there
    are free)."""
    return jnp.maximum(
        jnp.max(med.sigma_t) * jnp.max(med.density) * MAJORANT_BOOST, 1e-12)


def sample_distance_grid(med: Medium, u_fn, o, d, t_surface,
                         steps: int = TRACK_STEPS):
    """Weighted delta tracking (Woodcock with spectral history weights):
    returns (t, is_medium, w_med (N,3), w_surf (N,3)) matching
    sample_distance's contract.

    u_fn(j) -> (N,) fresh uniforms for collision j (two per step).
    At each tentative collision with local density rho:
      P_real = sigma_ref rho / maj        (sigma_ref = max-channel sigma_t)
      real:  W_c *= sigma_t_c rho / (sigma_ref rho)   -> w_med = W * albedo
      null:  W_c *= (maj - sigma_t_c rho) / (maj - sigma_ref rho)
    which leaves W_c = Tr_c(t) sigma_t_c / pdf(t) in expectation — the
    single-sample unbiased spectral estimator.
    """
    n = o.shape[0]
    maj = _majorant(med)
    # real/null split on the MEAN channel: with the max channel as the
    # reference, sub-maximal channels carry per-null weights far above 1
    # and the history-weight variance explodes multiplicatively
    sigma_ref = jnp.mean(med.sigma_t)

    def body(carry, j):
        t, W, done_med, done_surf = carry
        step = -jnp.log(jnp.maximum(1.0 - u_fn(2 * j), 1e-38)) / maj
        t_new = t + step
        walking = ~(done_med | done_surf)
        reach_surf = walking & (t_new >= t_surface)
        done_surf = done_surf | reach_surf
        at = jnp.minimum(t_new, t_surface)
        p = o + d * at[:, None]
        rho = density_at(med, p)
        p_real = jnp.clip(sigma_ref * rho / maj, 0.0, 1.0)
        real = walking & ~reach_surf & (u_fn(2 * j + 1) < p_real)
        # spectral history weights
        w_real = m.safe_div(med.sigma_t[None, :] * rho[:, None],
                            jnp.maximum(sigma_ref * rho, 1e-30)[:, None])
        denom = jnp.maximum(maj - sigma_ref * rho, 1e-30)
        w_null = (maj - med.sigma_t[None, :] * rho[:, None]) / denom[:, None]
        upd = jnp.where(real[:, None], w_real,
                        jnp.where((walking & ~reach_surf)[:, None],
                                  w_null, 1.0))
        W = W * upd
        done_med = done_med | real
        t = jnp.where(walking, at, t)
        return (t, W, done_med, done_surf), None

    init = (jnp.zeros((n,)), jnp.ones((n, 3)),
            jnp.zeros((n,), bool), jnp.zeros((n,), bool))
    (t, W, done_med, _), _ = jax.lax.scan(
        body, init, jnp.arange(steps, dtype=jnp.uint32))
    # exhausted lanes: count as surface (see budget note above)
    sigma_s = med.sigma_t * med.albedo
    w_med = W * jnp.where(med.sigma_t[None, :] > 0,
                          sigma_s[None, :] / jnp.maximum(
                              med.sigma_t[None, :], 1e-30), 0.0)
    return t, done_med, w_med, W


def transmittance_track(med: Medium, u_fn, o, d, dist,
                        steps: int = TRACK_STEPS):
    """Ratio tracking: unbiased spectral Tr estimate along a segment
    (heterogeneous.cpp evalTransmittance; Novak et al. residual-free form).
    u_fn(j) -> (N,) fresh uniforms."""
    n = o.shape[0]
    maj = _majorant(med)

    def body(carry, j):
        t, W, done = carry
        step = -jnp.log(jnp.maximum(1.0 - u_fn(j), 1e-38)) / maj
        t = t + jnp.where(done, 0.0, step)
        past = t >= dist
        done_new = done | past
        p = o + d * jnp.minimum(t, dist)[:, None]
        rho = density_at(med, p)
        w_null = jnp.clip(1.0 - med.sigma_t[None, :] * rho[:, None] / maj,
                          0.0, 1.0)
        W = W * jnp.where((~done_new)[:, None], w_null, 1.0)
        return (t, W, done_new), None

    init = (jnp.zeros((n,)), jnp.ones((n, 3)), jnp.zeros((n,), bool))
    (_, W, _), _ = jax.lax.scan(body, init,
                                jnp.arange(steps, dtype=jnp.uint32))
    # lanes still inside after the budget: conservative upper-bound factor
    return W


def sample_distance(med: Medium, u_chan: jax.Array, u_dist: jax.Array,
                    t_surface: jax.Array):
    """Spectral distance sampling with uniform channel selection
    (homogeneous.cpp sampleDistance): returns
    (t, is_medium, weight_medium (N,3), weight_surface (N,3)).

    weight_* are the throughput factors Tr * sigma_s / pdf for a medium
    event and Tr / pdf for reaching the surface, already MIS-averaged over
    channels (the reference picks a channel uniformly; we do the same and
    use the channel-average pdf -> unbiased with lower variance).
    """
    # DETACHED sampling (differentiability): the flight distance, the
    # medium/surface event split, and the pdf are computed from
    # stop-gradient sigma_t, while the numerator (Tr * sigma_s) stays
    # attached. With attached sampling the per-sample event switch
    # t < t_surface is DISCONTINUOUS in sigma_t and pathwise AD drops
    # its boundary term (measured ~3.5x-low sigma_t gradients); with a
    # detached pdf the estimator is sum_events int num(sigma)/p * p =
    # int num, so d/dsigma = int d(num) — unbiased, no boundary terms
    # (the standard detached strategy of differentiable volume
    # rendering). The pdf is a pure importance weight, so the primal is
    # unchanged.
    sg = jax.lax.stop_gradient
    sig_d = sg(med.sigma_t)
    c = jnp.minimum((u_chan * 3).astype(jnp.int32), 2)
    sig_c = sig_d[c]
    t = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-38)) / jnp.maximum(sig_c, 1e-20)
    is_medium = t < t_surface
    tr_t = jnp.exp(-med.sigma_t[None, :] * t[:, None])
    # miss lanes carry t_surface ~ 1e30; clamp the ATTACHED exponent so
    # its adjoint (-t * exp(-sigma t)) stays finite (weight is 0 anyway)
    tr_s = jnp.exp(-jnp.minimum(med.sigma_t[None, :]
                                * t_surface[:, None], 80.0))
    pdf_medium = jnp.mean(sig_d[None, :] * sg(tr_t), axis=-1)
    pdf_surface = jnp.mean(sg(tr_s), axis=-1)
    sigma_s = med.sigma_t * med.albedo
    w_med = tr_t * sigma_s[None, :] \
        * (1.0 / jnp.maximum(pdf_medium, 1e-30))[:, None]
    w_surf = tr_s * (1.0 / jnp.maximum(pdf_surface, 1e-30))[:, None]
    return t, is_medium, w_med, w_surf
