"""Chi-square goodness-of-fit harness for sample()/pdf() consistency.

Analog of the reference's ChiSquare test harness
(include/mitsuba/core/chisquare.h:40-110, used by
src/tests/test_chisquare.cpp): a warp's `sample` maps uniforms to
directions; its `pdf` must integrate to the observed histogram. Directions
are binned on a (cos_theta, phi) grid (equal solid-angle rows), expected
counts come from numerically integrating the pdf over each cell with a
sub-grid, and a chi-square statistic with pooled low-count cells is tested
at a given significance (reference uses 0.25% with Sidak correction,
test_chisquare.cpp:15).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def _chi2_sf(x: float, k: int) -> float:
    """Survival function of the chi-square distribution via the
    Wilson-Hilferty normal approximation (good for k >= 3; we pool cells so
    dof is always large)."""
    if k <= 0:
        return 1.0
    z = ((x / k) ** (1.0 / 3.0) - (1.0 - 2.0 / (9.0 * k))) / math.sqrt(2.0 / (9.0 * k))
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def spherical_chi2(
    sample_fn,
    pdf_fn,
    n_samples: int = 1 << 20,
    theta_bins: int = 24,
    phi_bins: int = 48,
    sub: int = 8,
    significance: float = 0.0025,
    seed: int = 0,
    sample_weights=None,
    rel_tol: float = 0.02,
    polar_axis: str = "z",
):
    """Run a chi-square GOF test of `sample_fn` against `pdf_fn`.

    sample_fn(u2) -> (N,3) unit directions from (N,2) uniforms.
    pdf_fn(v) -> (M,) solid-angle density at unit directions v (M,3).
    sample_weights: optional (N,) weights (for techniques that can reject:
    weight 0 = rejected sample; the pdf must then integrate the accepted
    measure only).

    Returns (passed: bool, p_value: float, stats: dict).
    """
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (n_samples, 2))
    v = np.asarray(sample_fn(u))
    w = np.ones(n_samples) if sample_weights is None else np.asarray(sample_weights)

    # `polar_axis` aligns the integration grid's pole with the pdf's
    # natural axis (e.g. "y" for lat-long envmaps): the sin(theta) measure
    # factor only regularizes 1/sin singularities around the GRID's pole.
    if polar_axis == "y":
        perm = [0, 2, 1]   # swap y<->z (orthonormal, self-inverse)
    elif polar_axis == "x":
        perm = [2, 1, 0]
    else:
        perm = [0, 1, 2]
    v = v[:, perm]
    user_pdf_fn = pdf_fn
    if perm != [0, 1, 2]:
        def pdf_fn(dirs, _f=user_pdf_fn, _p=perm):  # noqa: F811
            return _f(dirs[:, _p])

    # Bin observed counts on a theta-uniform grid (the reference's layout,
    # chisquare.h res x 2*res over theta/phi). Theta-uniform — not
    # cos-uniform — so the sin(theta) measure factor below regularizes
    # pole-singular pdfs (e.g. lat-long envmaps ~ 1/sin(theta)).
    ct = np.clip(v[:, 2], -1.0, 1.0)
    theta = np.arccos(ct)
    phi = np.arctan2(v[:, 1], v[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    ti = np.minimum((theta / np.pi * theta_bins).astype(np.int64), theta_bins - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * phi_bins).astype(np.int64), phi_bins - 1)
    obs = np.zeros((theta_bins, phi_bins))
    np.add.at(obs, (ti, pi_), w)

    # Expected counts: per-cell adaptive composite-Simpson integration of
    # the pdf (the analog of the reference's adaptive quadrature,
    # chisquare.h:81 / quad.h:132). Cells are refined until successive
    # resolutions agree to 0.1% — microfacet lobes concentrate orders of
    # magnitude of density in the pole cells, where fixed-resolution
    # quadrature silently over/under-shoots.
    # jit the pdf with power-of-two padding: the refinement loop calls it
    # on many shapes, and eager evaluation of big batches is the bottleneck
    pdf_jit = jax.jit(pdf_fn)

    def eval_pdf_np(dirs_flat: np.ndarray) -> np.ndarray:
        n = dirs_flat.shape[0]
        cap = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
        pad = cap - n
        if pad:
            dirs_flat = np.concatenate(
                [dirs_flat, np.tile(dirs_flat[-1:], (pad, 1))], 0
            )
        out = np.asarray(pdf_jit(jnp.asarray(dirs_flat, jnp.float32)))
        return out[:n]

    def cells_integral(rows, cols, s):
        """Simpson integral of pdf(omega) sin(theta) dtheta dphi over the
        given (row, col) cells with s intervals per axis."""
        npts = s + 1
        w1d = np.ones(npts)
        w1d[1:-1:2] = 4.0
        w1d[2:-1:2] = 2.0
        # endpoints are inset by a sliver so pdfs with discontinuities ON a
        # cell boundary evaluate on the correct side (O(1e-4/s) bias)
        frac = np.clip(np.arange(npts) / s, 1e-4 / s, 1.0 - 1e-4 / s)
        th = np.pi * (rows[:, None] + frac[None, :]) / theta_bins   # (C,P)
        # keep theta away from the exact poles: below ~5e-4, float32
        # directions round cos(theta) to 1.0 and pdfs that reconstruct
        # sin(theta) from the direction (lat-long envmaps) blow up
        th = np.clip(th, 5e-4, np.pi - 5e-4)
        ph = 2 * np.pi * (cols[:, None] + frac[None, :]) / phi_bins
        TH = th[:, :, None]
        PH = ph[:, None, :]
        ST = np.sin(TH)
        CT = np.cos(TH)
        dirs = np.stack(
            np.broadcast_arrays(ST * np.cos(PH), ST * np.sin(PH),
                                np.broadcast_to(CT, (len(rows), npts, npts))),
            axis=-1,
        )
        vals = eval_pdf_np(
            dirs.reshape(-1, 3).astype(np.float32)
        ).reshape(len(rows), npts, npts).astype(np.float64)
        vals = vals * ST  # solid-angle measure; kills 1/sin pole spikes
        h_th = (np.pi / theta_bins) / s
        h_ph = (2 * np.pi / phi_bins) / s
        return np.einsum("cab,a,b->c", vals, w1d, w1d) * (h_th / 3.0) * (h_ph / 3.0)

    rows, cols = np.meshgrid(np.arange(theta_bins), np.arange(phi_bins), indexing="ij")
    rows = rows.ravel()
    cols = cols.ravel()
    coarse = cells_integral(rows, cols, max(sub, 4) // 2 * 2)
    exp = np.zeros(theta_bins * phi_bins)
    exp[:] = coarse
    active = np.arange(len(rows))
    prev = coarse
    s = max(sub, 4) // 2 * 2
    while s <= 512 and len(active):
        s *= 2
        refined = cells_integral(rows[active], cols[active], s)
        exp[active] = refined
        diff = np.abs(refined - prev[active])
        keep = diff > np.maximum(1e-3 * np.abs(refined), 1e-9)
        prev = exp
        active = active[keep]
    exp = exp.reshape(theta_bins, phi_bins)
    fine = exp  # for the pdf_mass stat below
    # Scale by the TOTAL sample count: for techniques with rejection the
    # pdf already integrates to the acceptance fraction, so expected counts
    # are N_total * integral (scaling by sum(w) would double-count the
    # acceptance and bias every cell by that factor).
    exp = exp * float(n_samples)

    # Pool cells with expected count below 5 (standard chi-square practice;
    # reference pools too, chisquare.cpp).
    obs_f = obs.ravel()
    exp_f = exp.ravel()
    order = np.argsort(exp_f)
    obs_f, exp_f = obs_f[order], exp_f[order]
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for o, e in zip(obs_f, exp_f):
        acc_o += o
        acc_e += e
        if acc_e >= 5.0:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0 and pooled_exp:
        pooled_obs[-1] += acc_o
        pooled_exp[-1] += acc_e
    pooled_obs = np.asarray(pooled_obs)
    pooled_exp = np.asarray(pooled_exp)

    # Variance = Poisson count variance + systematic integration-error
    # budget (rel_tol * expected)^2: sharp pdfs (e.g. GGX lobes) can't be
    # midpoint-integrated to better than ~1% in high-gradient cells, and
    # with 1e5+ counts per cell that bias would otherwise dominate the
    # statistic (the reference handles this with adaptive quadrature,
    # chisquare.h:81; a tolerance term is the cheap equivalent).
    var = np.maximum(pooled_exp, 1e-9) + (rel_tol * pooled_exp) ** 2
    chi2 = float(np.sum((pooled_obs - pooled_exp) ** 2 / var))
    dof = max(len(pooled_exp) - 1, 1)
    p = _chi2_sf(chi2, dof)
    # Also sanity-check total mass: integral of pdf should equal the
    # accepted-sample fraction.
    mass = float(exp.sum() / max(np.sum(w), 1e-9) * (np.sum(w) / n_samples))
    return p >= significance, p, {
        "chi2": chi2,
        "dof": dof,
        "pdf_mass": float(fine.sum()),
        "accept_frac": float(np.sum(w) / n_samples),
    }
