"""Specular manifold walk — the batched SpecularManifold.

Reference: include/mitsuba/bidir/manifold.h:35 (SpecularManifold),
src/libbidir/manifold.cpp (1000 LoC: init/move/update + the generalized
geometric term G/multiG used by the manifold perturbation,
mut_manifold.cpp).

Redesign, not a port. The reference walks ONE path at a time, assembling
per-vertex 2x2 derivative blocks of the half-vector constraints by hand
and solving the block-tridiagonal system with a bespoke LU
(manifold.cpp:~420-620). Here:

  * N chains advance in lockstep (one batched Newton iteration per
    `lax.while_loop` step — divergent per-path iteration counts become
    masked lanes, the batch-friendly shape);
  * the chain transfer Jacobian comes from `jax.jvp` through a
    *fixed-triangle* differentiable re-trace of the whole specular chain
    (deterministic reflect/refract + ray/plane intersection), so the
    2x2 Newton system is exact to machine precision with no hand-derived
    curvature terms — the interpolated shading normal's dependence on the
    hit point supplies what the reference encodes via dndu/dndv;
  * re-projection onto the true geometry is a real (scene-intersection)
    re-trace, exactly like SpecularManifold::update()'s ray casts.

Parametrisation: the walk's free variable is the FIRST specular vertex
x1, moved in the tangent plane of its current triangle; everything
downstream (x2..xm and the movable endpoint) is a deterministic function
of x1 given the per-vertex interaction modes (reflect / refract). The
Newton target is the endpoint error expressed in the target's tangent
basis (manifold.cpp move(): project onto the plane, step, re-trace).

Conventions:
  * chains are padded to a static max length M; `m_len` (N,) gives the
    true specular-vertex count, 1 <= m_len <= M (use
    `generalized_G` directly for m_len = 0);
  * `modes` (N,M) int32: 0 = mirror reflection, 1 = refraction (relative
    IOR gathered from the vertex material's eta, fresnel convention of
    core/math.fresnel_dielectric);
  * positions are float32 world space; convergence threshold is relative
    to the chain extent (MTS_MANIFOLD_EPSILON analog).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as m

MAX_ITERATIONS = 20          # MTS_MANIFOLD_MAX_ITERATIONS (manifold.h:27)
EPSILON = 1e-4               # MTS_MANIFOLD_EPSILON (relative)
_DET_EPS = 1e-12


# ---------------------------------------------------------------------------
# Local geometry helpers (differentiable; `prim` is data, never traced
# through — the fixed-triangle retrace relies on that)
# ---------------------------------------------------------------------------

def _tri(scene, prim):
    """Vertices + geometric normal of triangle `prim` ((N,3) gathers)."""
    pr = jnp.maximum(prim, 0)
    vi = scene.indices[pr]
    v0 = scene.vertices[vi[:, 0]]
    v1 = scene.vertices[vi[:, 1]]
    v2 = scene.vertices[vi[:, 2]]
    ngv = jnp.cross(v1 - v0, v2 - v0)
    ng = ngv * jax.lax.rsqrt(jnp.maximum(m.dot(ngv, ngv), 1e-24))[:, None]
    return v0, v1, v2, ng


def _interp_ns(scene, prim, p):
    """Interpolated shading normal at point p on triangle `prim`.

    Differentiable in p: barycentrics come from the 2x2 Gram system of the
    triangle edges, so d(ns)/d(p) carries the normal-curvature information
    the reference stores as dndu/dndv (manifold.cpp vertex setup)."""
    pr = jnp.maximum(prim, 0)
    vi = scene.indices[pr]
    v0 = scene.vertices[vi[:, 0]]
    e1 = scene.vertices[vi[:, 1]] - v0
    e2 = scene.vertices[vi[:, 2]] - v0
    n0 = scene.normals[vi[:, 0]]
    n1 = scene.normals[vi[:, 1]]
    n2 = scene.normals[vi[:, 2]]
    dp = p - v0
    a11 = m.dot(e1, e1)
    a12 = m.dot(e1, e2)
    a22 = m.dot(e2, e2)
    r1 = m.dot(dp, e1)
    r2 = m.dot(dp, e2)
    det = jnp.maximum(a11 * a22 - a12 * a12, 1e-20)
    b1 = (a22 * r1 - a12 * r2) / det
    b2 = (a11 * r2 - a12 * r1) / det
    ns = n0 + b1[:, None] * (n1 - n0) + b2[:, None] * (n2 - n0)
    return m.normalize(ns)


def _tri_eta(scene, prim):
    """Relative IOR (int/ext) of the material on triangle `prim`."""
    mat = scene.tri_material[jnp.maximum(prim, 0)]
    return scene.materials.eta[mat, 0]


def scatter_dir(d_in, ns, mode, eta):
    """Deterministic specular scatter of travel direction d_in at normal ns.

    mode 0 = mirror, 1 = refract (eta = int/ext relative IOR, entering/
    exiting resolved from the sign of cos like fresnelDielectricExt).
    Returns (d_out, ok) — ok=False on total internal reflection of a
    refract lane (the move fails there, like the reference's update())."""
    wi = -d_in
    ci = m.dot(wi, ns)
    wo_r = 2.0 * ci[:, None] * ns - wi
    fr, cos_t, _, eta_ti = m.fresnel_dielectric(ci, eta)
    wo_t = eta_ti[:, None] * (ci[:, None] * ns - wi) + cos_t[:, None] * ns
    tir = fr >= 1.0 - 1e-6
    refr = mode == 1
    wo = jnp.where(refr[:, None], wo_t, wo_r)
    ok = ~(refr & tir)
    return m.normalize(wo), ok


def _plane_hit(scene, p, d, prim):
    """Ray/plane intersection with triangle `prim`'s supporting plane
    (differentiable; the fixed-triangle stand-in for a scene trace)."""
    v0, _, _, ng = _tri(scene, prim)
    denom = m.dot(d, ng)
    safe = jnp.abs(denom) > 1e-9
    t = m.dot(v0 - p, ng) / jnp.where(safe, denom, 1.0)
    ok = safe & (t > 1e-5)
    return p + t[:, None] * d, ok


def _fixed_chain(scene, p0, d0, chain_prim, modes, m_len, end_prim):
    """Differentiable retrace of the whole chain against FIXED triangles.

    From p0 along d0: plane-hit chain_prim[i], specular-scatter, repeat
    for i < m_len, then plane-hit end_prim. Returns (end_pos, ok)."""
    M = chain_prim.shape[1]
    p, d = p0, d0
    ok = jnp.ones(p0.shape[0], bool)
    for i in range(M):
        active = i < m_len
        p_hit, h_ok = _plane_hit(scene, p, d, chain_prim[:, i])
        ns = _interp_ns(scene, chain_prim[:, i], p_hit)
        eta = _tri_eta(scene, chain_prim[:, i])
        d_new, s_ok = scatter_dir(d, ns, modes[:, i], eta)
        ok = ok & (~active | (h_ok & s_ok))
        p = jnp.where(active[:, None], p_hit, p)
        d = jnp.where(active[:, None], d_new, d)
    end, e_ok = _plane_hit(scene, p, d, end_prim)
    return end, ok & e_ok


def _real_retrace(scene, x0, x1_target, modes, m_len, expect_mat=None):
    """Scene-intersection retrace (SpecularManifold::update()'s ray casts).

    Traces from x0 toward x1_target, scattering specularly m_len times.
    Chain vertices must land on triangles of the expected material
    (expect_mat (N,M), None = no check) — the walk must not wander off
    the specular object.
    Returns (chain_pos, chain_prim, end_pos, end_prim, ok)."""
    from . import trace

    N, M = modes.shape
    d = m.normalize(x1_target - x0)
    p = x0
    chain_pos = jnp.zeros((N, M, 3))
    chain_prim = jnp.full((N, M), -1, jnp.int32)
    end_pos = jnp.zeros((N, 3))
    end_prim = jnp.full((N,), -1, jnp.int32)
    ok = jnp.ones((N,), bool)
    for i in range(M + 1):
        active = i <= m_len
        its = trace.closest_hit(scene, p, d)
        prim_i = jnp.where(its.valid, its.prim.astype(jnp.int32), -1)
        pos_i = p + its.t[:, None] * d
        is_chain = (i < m_len) & active
        is_end = (i == m_len) & active
        if i < M:
            if expect_mat is None:
                mat_ok = jnp.ones((N,), bool)
            else:
                mat_ok = scene.tri_material[jnp.maximum(prim_i, 0)] \
                    == expect_mat[:, i]
            sel = is_chain[:, None]
            chain_pos = chain_pos.at[:, i].set(
                jnp.where(sel, pos_i, chain_pos[:, i]))
            chain_prim = chain_prim.at[:, i].set(
                jnp.where(is_chain, prim_i, chain_prim[:, i]))
            ns = _interp_ns(scene, prim_i, pos_i)
            eta = _tri_eta(scene, prim_i)
            d_new, s_ok = scatter_dir(
                d, ns, modes[:, min(i, M - 1)], eta)
            ok = ok & (~is_chain | (its.valid & mat_ok & s_ok))
            d = jnp.where(is_chain[:, None], d_new, d)
        end_pos = jnp.where(is_end[:, None], pos_i, end_pos)
        end_prim = jnp.where(is_end, prim_i, end_prim)
        ok = ok & (~is_end | its.valid)
        p = jnp.where(active[:, None], pos_i, p)
    return chain_pos, chain_prim, end_pos, end_prim, ok


def _onb(n):
    """Orthonormal basis (b1, b2) perpendicular to n (batched)."""
    s = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    b1 = jnp.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b,
                    -s * n[:, 0]], -1)
    b2 = jnp.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return b1, b2


class WalkResult(NamedTuple):
    chain_pos: jax.Array    # (N,M,3) updated specular vertices
    chain_prim: jax.Array   # (N,M)
    end_pos: jax.Array      # (N,3)  final movable endpoint (~= target)
    end_prim: jax.Array     # (N,)
    ok: jax.Array           # (N,) bool — converged & every retrace valid
    iterations: jax.Array   # (N,) int32


def walk(scene, x0, x1, modes, m_len, target,
         max_iterations: int = MAX_ITERATIONS) -> WalkResult:
    """Move the endpoint of N specular chains to `target`.

    SpecularManifold::move (manifold.cpp) as one batched Newton loop:
    x0 fixed endpoint, x1 initial first specular vertex (ON the scene
    surface), modes/m_len the chain spec, target the desired new position
    of the non-specular endpoint after the chain."""
    N, M = modes.shape

    # establish the initial chain (unchecked), then snapshot its material
    # ids as the expectation every later retrace must satisfy
    cp, cpr, ep, epr, ok0 = _real_retrace(scene, x0, x1, modes, m_len)
    snap_mat = scene.tri_material[jnp.maximum(cpr, 0)]

    # target tangent frame for the 2D error (move() projects onto the
    # destination plane, manifold.cpp)
    scale = 1.0 + m.length(target - x0)
    tol = EPSILON * scale

    def err_of(end_pos, tb1, tb2):
        dv = end_pos - target
        return jnp.stack([m.dot(dv, tb1), m.dot(dv, tb2)], -1)

    # tangent frame at the endpoint's current prim normal (re-derived per
    # iteration inside E via the fixed end_prim plane)
    def body(st):
        (x1c, cpc, cprc, epc, eprc, step, it, done, okc) = st
        _, _, _, ng_end = _tri(scene, eprc)
        tb1, tb2 = _onb(ng_end)
        e_cur = err_of(epc, tb1, tb2)

        # basis in the first chain triangle's plane
        _, _, _, ng1 = _tri(scene, cprc[:, 0])
        b1, b2 = _onb(ng1)

        def e_fn(u):
            x1u = x1c + u[:, 0:1] * b1 + u[:, 1:2] * b2
            du = m.normalize(x1u - x0)
            end, _ = _fixed_chain(scene, x0, du, cprc, modes, m_len, eprc)
            return err_of(end, tb1, tb2)

        u0 = jnp.zeros((N, 2))
        _, j1 = jax.jvp(e_fn, (u0,), (jnp.broadcast_to(
            jnp.asarray([1.0, 0.0]), (N, 2)),))
        _, j2 = jax.jvp(e_fn, (u0,), (jnp.broadcast_to(
            jnp.asarray([0.0, 1.0]), (N, 2)),))
        det = j1[:, 0] * j2[:, 1] - j1[:, 1] * j2[:, 0]
        inv_ok = jnp.abs(det) > _DET_EPS
        inv_det = jnp.where(inv_ok, 1.0 / jnp.where(inv_ok, det, 1.0), 0.0)
        # solve J du = -e  (columns j1, j2)
        du0 = (-e_cur[:, 0] * j2[:, 1] + e_cur[:, 1] * j2[:, 0]) * inv_det
        du1 = (-e_cur[:, 1] * j1[:, 0] + e_cur[:, 0] * j1[:, 1]) * inv_det

        x1_try = x1c + step[:, None] * (du0[:, None] * b1
                                        + du1[:, None] * b2)
        cp_t, cpr_t, ep_t, epr_t, rt_ok = _real_retrace(
            scene, x0, x1_try, modes, m_len, snap_mat)
        _, _, _, ng_t = _tri(scene, epr_t)
        tb1_t, tb2_t = _onb(ng_t)
        e_new = err_of(ep_t, tb1_t, tb2_t)
        improve = rt_ok & inv_ok & (
            m.length(e_new) < m.length(e_cur))

        upd = improve & ~done
        sel3 = upd[:, None]
        x1n = jnp.where(sel3, cp_t[:, 0], x1c)
        cpn = jnp.where(upd[:, None, None], cp_t, cpc)
        cprn = jnp.where(upd[:, None], cpr_t, cprc)
        epn = jnp.where(sel3, ep_t, epc)
        eprn = jnp.where(upd, epr_t, eprc)
        # step-size control (manifold.cpp move(): halve on failure,
        # restore toward 1 on success)
        stepn = jnp.where(done, step,
                          jnp.where(improve, jnp.minimum(step * 2.0, 1.0),
                                    step * 0.5))
        e_eff = jnp.where(upd[:, None], e_new, e_cur)
        done_n = done | (m.length(e_eff) < tol)
        return (x1n, cpn, cprn, epn, eprn, stepn, it + 1, done_n, okc)

    def cond(st):
        (_, _, _, _, _, step, it, done, okc) = st
        return (it < max_iterations) & jnp.any(~done & okc & (step > 1e-5))

    init = (cp[:, 0], cp, cpr, ep, epr,
            jnp.ones((N,)), jnp.zeros((), jnp.int32),
            jnp.zeros((N,), bool), ok0)
    (_x1f, cpf, cprf, epf, eprf, _, it_f, done_f, ok_f) = \
        jax.lax.while_loop(cond, body, init)
    return WalkResult(chain_pos=cpf, chain_prim=cprf, end_pos=epf,
                      end_prim=eprf, ok=ok_f & done_f,
                      iterations=jnp.broadcast_to(it_f, (N,)))


def generalized_G(scene, x0, x1_dir, chain_prim, modes, m_len, end_prim,
                  ns0=None):
    """Generalized geometric term through a specular chain.

    SpecularManifold::G / multiG (manifold.cpp): |cos theta_0| / |dA_b/dw|,
    where dA_b/dw is the area of the movable endpoint swept per unit solid
    angle at x0 — computed as the 2x2 Jacobian determinant of the fixed-
    triangle chain retrace via jax.jvp. With m_len = 0 this reduces to the
    classical cos_a cos_b / d^2 (validated in tests/test_manifold.py).

    x1_dir: unit direction of the first chain segment at x0. ns0: shading
    normal at x0 (None = omit the |cos theta_0| factor — x0 is a camera
    or medium vertex with no surface cosine)."""
    N = x0.shape[0]
    a, b = _onb(x1_dir)

    def end_fn(v):
        d = m.normalize(x1_dir + v[:, 0:1] * a + v[:, 1:2] * b)
        end, ok = _fixed_chain(scene, x0, d, chain_prim, modes, m_len,
                               end_prim)
        return end, ok

    v0 = jnp.zeros((N, 2))
    (_, ok), t1 = jax.jvp(end_fn, (v0,),
                          (jnp.broadcast_to(jnp.asarray([1.0, 0.0]),
                                            (N, 2)),))
    (_, _), t2 = jax.jvp(end_fn, (v0,),
                         (jnp.broadcast_to(jnp.asarray([0.0, 1.0]),
                                           (N, 2)),))
    dp1, dp2 = t1[0], t2[0]
    # dA/dw = area swept at the endpoint per unit solid angle at x0
    dA_dw = m.length(jnp.cross(dp1, dp2))
    cos0 = 1.0 if ns0 is None else jnp.abs(m.dot(x1_dir, ns0))
    return jnp.where(ok & (dA_dw > 1e-20),
                     cos0 / jnp.maximum(dA_dw, 1e-20), 0.0)
