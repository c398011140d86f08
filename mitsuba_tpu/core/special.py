"""Special-function math tier: spherical harmonics, Catmull-Rom splines,
Brent's root finder, Gauss quadrature.

Analog of the reference's small-math headers the integrators
and data fits lean on:
  * include/mitsuba/core/sh.h + libcore/shvector.cpp — real SH basis
    (here: batched closed-form recurrence evaluation, jit/vmap friendly);
  * include/mitsuba/core/spline.h — Catmull-Rom 1D interpolation,
    integration and sample-by-inversion on uniform grids;
  * include/mitsuba/core/brent.h — Brent-style bracketed root refinement
    (here: a fixed-iteration bisection/secant hybrid under lax.while_loop
    so it compiles to static control flow);
  * include/mitsuba/core/quad.h — Gauss-Legendre / Gauss-Lobatto nodes
    and weights (host-side via numpy, used to build fixed quadratures
    that then run on device as dot products).

Everything is batched over leading axes and safe under jax.jit.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Real spherical harmonics (sh.h / shvector.cpp)
# ---------------------------------------------------------------------------


def sh_count(order: int) -> int:
    """Number of real SH basis functions for bands 0..order-1."""
    return order * order


def sh_eval(d: jax.Array, order: int) -> jax.Array:
    """Evaluate the real SH basis at unit directions d (..., 3).

    Returns (..., order**2) with the usual (l, m) flattening
    idx = l*(l+1)+m, matching SHVector::eval (shvector.cpp). Uses the
    standard associated-Legendre recurrence, fully unrolled at trace
    time (order is static), so XLA sees straight-line arithmetic.
    """
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    sin_t = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    # azimuthal cos(m phi) / sin(m phi) via Chebyshev recurrence on the
    # UNNORMALIZED sin_t*cos(phi) = x, sin_t*sin(phi) = y: we track
    # sin_t^m * cos(m phi) and sin_t^m * sin(m phi), which is exactly
    # the factor the P_l^m recurrence wants (no division by sin_t).
    out = []
    # P_m^m with the sin_t^m factor folded in; Kmm normalization applied
    # at the end per (l, m)
    for m_ in range(order):
        if m_ == 0:
            cm, sm = jnp.ones_like(x), jnp.zeros_like(x)
        else:
            cm, sm = cm * x - sm * y, sm * x + cm * y  # noqa: F821
        # pmm = (-1)^m (2m-1)!! sin^m  -> we fold sin^m into cm/sm, so
        # track pmm_hat = (-1)^m (2m-1)!! and multiply by cm/sm later
        dfact = 1.0
        for i_ in range(1, m_ + 1):
            dfact *= -(2 * i_ - 1)
        p_prev = jnp.full_like(z, dfact)         # P_m^m / sin^m
        p_curr = z * (2 * m_ + 1) * p_prev       # P_{m+1}^m / sin^m
        for l_ in range(m_, order):
            if l_ == m_:
                p_lm = p_prev
            elif l_ == m_ + 1:
                p_lm = p_curr
            else:
                p_next = ((2 * l_ - 1) * z * p_curr -
                          (l_ + m_ - 1) * p_prev) / (l_ - m_)
                p_prev, p_curr = p_curr, p_next
                p_lm = p_next
            # normalization K_l^m
            k = np.sqrt((2 * l_ + 1) / (4 * np.pi) *
                        _fact_ratio(l_ - m_, l_ + m_))
            if m_ == 0:
                out.append((l_ * (l_ + 1), k * p_lm))
            else:
                s2 = np.sqrt(2.0) * k
                out.append((l_ * (l_ + 1) + m_, s2 * p_lm * cm))
                out.append((l_ * (l_ + 1) - m_, s2 * p_lm * sm))
    res = [None] * (order * order)
    for idx, val in out:
        res[idx] = val
    return jnp.stack(res, axis=-1)


def _fact_ratio(a: int, b: int) -> float:
    """(a)! / (b)! for b >= a, computed stably."""
    r = 1.0
    for i in range(a + 1, b + 1):
        r /= i
    return r


def sh_project(fn, order: int, n_theta: int = 64, n_phi: int = 128):
    """Project fn(d)->(...,) onto SH coefficients by quadrature
    (SHVector::project, shvector.cpp). Gauss-Legendre in cos(theta),
    trapezoid in phi. Returns (order**2,) coefficients."""
    xg, wg = np.polynomial.legendre.leggauss(n_theta)
    cos_t = jnp.asarray(xg)                       # in (-1, 1)
    phi = jnp.arange(n_phi) * (2.0 * np.pi / n_phi)
    ct, ph = jnp.meshgrid(cos_t, phi, indexing="ij")
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    d = jnp.stack([st * jnp.cos(ph), st * jnp.sin(ph), ct], axis=-1)
    vals = fn(d.reshape(-1, 3)).reshape(n_theta, n_phi)
    basis = sh_eval(d.reshape(-1, 3), order).reshape(n_theta, n_phi, -1)
    w = jnp.asarray(wg) * (2.0 * np.pi / n_phi)   # per-theta weight
    return jnp.einsum("tp,tpk,t->k", vals, basis, w,
                      precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# Catmull-Rom cubic splines on uniform grids (spline.h)
# ---------------------------------------------------------------------------


def spline_eval(values: jax.Array, t: jax.Array) -> jax.Array:
    """Catmull-Rom interpolation of a uniform grid at t in [0, 1]
    (spline.h evalCubicInterp1D). values: (N,), t: (...,)."""
    n = values.shape[0]
    x = jnp.clip(t, 0.0, 1.0) * (n - 1)
    i = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    f = x - i
    v0 = values[jnp.maximum(i - 1, 0)]
    v1 = values[i]
    v2 = values[i + 1]
    v3 = values[jnp.minimum(i + 2, n - 1)]
    # one-sided derivative fallback at the boundary cells, like spline.h
    d1 = jnp.where(i > 0, 0.5 * (v2 - v0), v2 - v1)
    d2 = jnp.where(i < n - 2, 0.5 * (v3 - v1), v2 - v1)
    f2, f3 = f * f, f * f * f
    return ((2 * f3 - 3 * f2 + 1) * v1 + (-2 * f3 + 3 * f2) * v2 +
            (f3 - 2 * f2 + f) * d1 + (f3 - f2) * d2)


def spline_integrate(values: jax.Array) -> jax.Array:
    """Per-cell integrals of the Catmull-Rom interpolant over a uniform
    grid on [0, 1] (spline.h integrateCubicInterp1D). Returns the
    cumulative integral at the N grid points, cum[0] = 0."""
    n = values.shape[0]
    v0 = values[jnp.maximum(jnp.arange(n - 1) - 1, 0)]
    v1 = values[:-1]
    v2 = values[1:]
    v3 = values[jnp.minimum(jnp.arange(n - 1) + 2, n - 1)]
    i = jnp.arange(n - 1)
    d1 = jnp.where(i > 0, 0.5 * (v2 - v0), v2 - v1)
    d2 = jnp.where(i < n - 2, 0.5 * (v3 - v1), v2 - v1)
    # integral of the Hermite basis over one cell of width h = 1/(n-1)
    cell = (0.5 * (v1 + v2) + (d1 - d2) / 12.0) / (n - 1)
    return jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(cell)])


def spline_sample(values: jax.Array, u: jax.Array,
                  n_iter: int = 16):
    """Sample t ~ the normalized Catmull-Rom density over [0, 1] by CDF
    inversion (spline.h sampleCubicInterp1D). Returns (t, pdf(t))."""
    cum = spline_integrate(values)
    total = jnp.maximum(cum[-1], 1e-30)
    target = u * total

    def body(_, ab):
        lo, hi = ab
        mid = 0.5 * (lo + hi)
        cmid = _cum_at(values, cum, mid)
        lo = jnp.where(cmid < target, mid, lo)
        hi = jnp.where(cmid < target, hi, mid)
        return lo, hi

    lo0 = jnp.zeros_like(u)
    hi0 = jnp.ones_like(u)
    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo0, hi0))
    t = 0.5 * (lo + hi)
    return t, spline_eval(values, t) / total


def _cum_at(values: jax.Array, cum: jax.Array, t: jax.Array) -> jax.Array:
    """CDF of the interpolant at arbitrary t (exact per-cell cubic)."""
    n = values.shape[0]
    x = jnp.clip(t, 0.0, 1.0) * (n - 1)
    i = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    f = x - i
    v0 = values[jnp.maximum(i - 1, 0)]
    v1 = values[i]
    v2 = values[i + 1]
    v3 = values[jnp.minimum(i + 2, n - 1)]
    d1 = jnp.where(i > 0, 0.5 * (v2 - v0), v2 - v1)
    d2 = jnp.where(i < n - 2, 0.5 * (v3 - v1), v2 - v1)
    f2 = f * f
    f3, f4 = f2 * f, f2 * f2
    h = 1.0 / (n - 1)
    part = (v1 * (0.5 * f4 - f3 + f) + v2 * (-0.5 * f4 + f3) +
            d1 * (0.25 * f4 - (2.0 / 3.0) * f3 + 0.5 * f2) +
            d2 * (0.25 * f4 - f3 / 3.0)) * h
    return cum[i] + part


# ---------------------------------------------------------------------------
# Brent-style bracketed root refinement (brent.h)
# ---------------------------------------------------------------------------


def brent(fn, lo, hi, n_iter: int = 48):
    """Find fn(x) = 0 on [lo, hi] (fn(lo), fn(hi) of opposite sign).

    Batched bisection/secant hybrid: each step tries the secant point
    and falls back to bisection when it leaves the bracket — Brent's
    safeguard structure without the inverse-quadratic branch, under a
    fixed-trip fori_loop so the whole solve jits to static control flow
    (brent.h BrentSolver::solve).
    """
    flo = fn(lo)

    def body(_, st):
        a, b, fa, fb = st
        sec = b - fb * (b - a) / jnp.where(jnp.abs(fb - fa) > 1e-30,
                                           fb - fa, 1e-30)
        mid = 0.5 * (a + b)
        inside = (sec > jnp.minimum(a, b)) & (sec < jnp.maximum(a, b))
        x = jnp.where(inside, sec, mid)
        fx = fn(x)
        left = fa * fx <= 0.0
        a2 = jnp.where(left, a, x)
        fa2 = jnp.where(left, fa, fx)
        b2 = jnp.where(left, x, b)
        fb2 = jnp.where(left, fx, fb)
        return a2, b2, fa2, fb2

    a, b, fa, fb = jax.lax.fori_loop(
        0, n_iter, body, (lo, hi, flo, fn(hi)))
    return jnp.where(jnp.abs(fa) < jnp.abs(fb), a, b)


# ---------------------------------------------------------------------------
# Gauss quadrature (quad.h)
# ---------------------------------------------------------------------------


def gauss_legendre(n: int):
    """Nodes/weights on [-1, 1] (quad.h gaussLegendre). Host-side."""
    x, w = np.polynomial.legendre.leggauss(n)
    return jnp.asarray(x), jnp.asarray(w)


def gauss_lobatto(n: int):
    """Gauss-Lobatto nodes/weights on [-1, 1] (quad.h gaussLobatto):
    endpoints included, interior nodes = roots of P'_{n-1}."""
    if n < 2:
        raise ValueError("gauss_lobatto needs n >= 2")
    leg = np.polynomial.legendre.Legendre.basis(n - 1)
    xi = leg.deriv().roots()
    x = np.concatenate([[-1.0], np.sort(xi.real), [1.0]])
    pn = leg(x)
    w = 2.0 / (n * (n - 1) * pn * pn)
    return jnp.asarray(x), jnp.asarray(w)


def integrate(fn, a: float, b: float, n: int = 64,
              rule: str = "legendre") -> jax.Array:
    """Fixed-order quadrature of fn over [a, b] as one device dot."""
    x, w = gauss_legendre(n) if rule == "legendre" else gauss_lobatto(n)
    xm = 0.5 * (a + b) + 0.5 * (b - a) * x
    return 0.5 * (b - a) * jnp.sum(w * fn(xm))
