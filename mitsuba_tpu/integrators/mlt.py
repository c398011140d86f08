"""Path-space Metropolis light transport (Veach MLT).

Analog of src/integrators/mlt/mlt.cpp (337 LoC) over the
libbidir mutator tier (mut_bidir.h:38 bidirectional mutation,
mut_lens.h:36 lens perturbation). Where the reference runs a few long
chains over pooled PathVertex objects, this runs tens of thousands of
SHORT chains in lockstep; the path state is an explicit dense SoA array
(positions + primitive ids + length), every mutation is one batched
proposal, and film updates are scatter-adds — the same chain-parallel
layout as pssmlt.py, but in PATH space, which is what distinguishes MLT
from PSSMLT (mutations act on vertices, not on primary-sample numbers).

Mutation kernels (cycled per scan step — a systematic-scan composition of
detailed-balance kernels preserves the target):

  A `tail regen / connect` — the bidirectional mutation restricted to
    eye-side deletion (mut_bidir.h:38 with l..m on the eye side): delete
    the suffix after a uniformly chosen cut vertex, re-trace intermediate
    vertices by BSDF sampling, finish by connecting to a fresh area-light
    point. Cut at 0 = independence sampler (ergodicity / large step).
  B `tail regen / hit` — same deletion, but the regenerated suffix ends
    by *hitting* an emitter (pure BSDF transport); this is the move that
    carries near-specular caustic chains A cannot make.
  C `lens perturbation` — mut_lens.h:36: exponentially distributed raster
    offset, re-trace the primary ray, reconnect to the remainder.
  D `caustic perturbation` — mut_caustic.h:36 / mut_caustic.cpp:103-110:
    perturb the direction out of v2 TOWARD the camera-visible vertex with
    an exponentially distributed polar angle (Veach p.354 heuristic
    theta range from the per-pixel solid angle), re-trace one edge to a
    new v1, keep the deterministic eye connection. This moves the
    camera-visible vertex by wiggling the INCOMING light direction —
    the complementary move to C, and the one that keeps chains mixing on
    near-specular caustic paths where C's acceptance collapses.
  E `multi-chain perturbation` — mut_mchain.h:36: a lens perturbation
    chained with a same-size angular perturbation of the following edge:
    raster-offset v1, re-trace, then rotate the old v1->v2 direction by
    an exponential polar angle, re-trace v2, reconnect v2->v3. Moves two
    vertices at once (the E S D S D... regime of Veach fig. 11.8).

Acceptance uses the exact per-kernel transition densities (products of
area-measure BSDF/camera/light pdfs); f(path) is re-evaluated from the
vertex arrays each proposal, visibility included (verification.cpp's
recompute-vs-cache idea collapses to always-recompute, which a batched
evaluator gets for free).

  F `manifold perturbation` — mut_manifold.cpp: perturb the direction out
    of a non-specular vertex a by the same exponential angular kernel,
    propagate deterministically through the a..b delta chain (real
    specular retrace), then re-solve the b..c chain with the specular
    manifold walk (ops/manifold.py) so c stays fixed; a reverse walk
    enforces reversibility (mut_manifold.cpp:510-520). Scenes containing
    pure-delta BSDFs (conductor/dielectric/thindielectric) extend the
    TARGET to the quotient manifold: non-spec vertices carry area
    measure, delta vertices contribute their Fresnel coefficients, and
    each maximal chain multiplies ONE generalized geometric term
    (SpecularManifold::multiG) replacing the per-edge cos/d^2 factors;
    the A/B regeneration densities are chain-aware to match. All of this
    is statically gated on the scene's BSDF family set — delta-free
    scenes compile the original code.

Scope notes (documented limitations vs the reference MLT):
* paths terminate on AREA emitters (env/delta-lit scenes: use pssmlt);
* rough vertices are never probabilistically treated as specular (the
  reference's nonspecularProb heuristic); only true delta lobes form
  chains. Delta lobes INSIDE composite BSDFs (plastic/coating/blend)
  stay outside the target; C/D/E proposals that break a chain are
  rejected by the consistency indicator (zero target), F/A/B mutate
  delta paths;
* F uses the symmetric exponential angular kernel (D's) rather than the
  reference's locally-adapted vMF, so only generalized-G Jacobians enter
  its acceptance ratio;
* no medium vertices inside perturbed spans (surface MLT only).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..ops import trace
from ..ops.intersect import Intersection
from .common import RenderConfig

LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)
INV_PI = 1.0 / jnp.pi


# ---------------------------------------------------------------------------
# Path-state helpers. State: pos (N,K+1,3), prim (N,K+1) i32, k (N,) i32.
# Vertex 0 is the camera (pos fixed = eye, prim unused); vertex k lies on an
# area emitter. k = number of edges, 1 <= k <= K.
# ---------------------------------------------------------------------------


def _take_v(arr, idx):
    """Gather per-chain vertex idx from (N, K+1, ...)."""
    if arr.ndim == 3:
        return jnp.take_along_axis(arr, idx[:, None, None], axis=1)[:, 0]
    return jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]


def _set_v(arr, idx, val, mask):
    """Masked scatter of per-chain vertex idx into (N, K+1, ...)."""
    K1 = arr.shape[1]
    onehot = jnp.arange(K1)[None, :] == idx[:, None]
    sel = onehot & mask[:, None]
    if arr.ndim == 3:
        return jnp.where(sel[:, :, None], val[:, None, :], arr)
    return jnp.where(sel, val[:, None], arr)


def _si_at(scene, v_prev, v, prim):
    """Surface data at vertex v approached from v_prev."""
    dvec = v - v_prev
    dist = jnp.maximum(m.length(dvec), 1e-9)
    d = dvec / dist[:, None]
    its = Intersection(valid=prim >= 0, t=dist,
                       prim=jnp.maximum(prim, 0),
                       b1=jnp.zeros_like(dist), b2=jnp.zeros_like(dist))
    si = trace.surface_interaction(scene, v_prev, d, its)
    return si, d, dist


def _light_area_pdf(scene, prim):
    em = scene.emitters
    _, e1a, e2a = scene.tri_vertices()
    area_all = 0.5 * m.length(jnp.cross(e1a, e2a))
    pg_area, _, _ = emitterlib._group_probs(scene)
    pr = jnp.maximum(prim, 0)
    return m.safe_div(em.select_pdf_full[pr] * pg_area, area_all[pr])


def _cam_we(cam, d):
    """(w*h)/(A_film cos^3): the per-PIXEL-uniform importance in solid
    angle — makes eval_path's f integrate to per-pixel radiance."""
    fwd = cam.to_world[:3, 2]
    cos_c = jnp.maximum(m.dot(d, fwd[None, :]), 1e-6)
    tan_half = jnp.tan(0.5 * jnp.deg2rad(cam.fov_x))
    aspect = jnp.float32(cam.height) / jnp.float32(cam.width)
    film_area = 4.0 * tan_half * tan_half * aspect
    npix = jnp.float32(cam.width * cam.height)
    return npix / (film_area * cos_c ** 3), cos_c


# ---------------------------------------------------------------------------
# Specular (delta) chain support — the manifold tier (mut_manifold.cpp,
# manifold.cpp). Paths may contain interior vertices on pure-delta BSDFs
# (conductor / dielectric / thindielectric). The target density lives on
# the quotient manifold: non-specular vertices carry area measure, the
# specular vertices are determined, each maximal chain contributes its
# specular weights and ONE generalized geometric term (ops/manifold.py)
# in place of the per-edge cos/d^2 factors. Everything below is gated on
# `_scene_has_spec` so delta-free scenes compile the original code.
# ---------------------------------------------------------------------------

def _spec_fams():
    from ..scene import ir
    return (ir.BSDF_CONDUCTOR, ir.BSDF_DIELECTRIC, ir.BSDF_THIN_DIELECTRIC)


def _scene_has_spec(scene) -> bool:
    fams = set(_spec_fams())
    return any(f in fams for f in scene.bsdf_families)


def _spec_flags(scene, prim, k, K):
    """(N,K+1) bool: interior on-path vertices with a pure-delta BSDF."""
    from ..scene import ir
    mat = scene.tri_material[jnp.maximum(prim, 0)]
    fam = scene.materials.type[mat]
    is_spec = ((fam == ir.BSDF_CONDUCTOR) | (fam == ir.BSDF_DIELECTRIC)
               | (fam == ir.BSDF_THIN_DIELECTRIC)) & (prim >= 0)
    idx = jnp.arange(K + 1)[None, :]
    interior = (idx >= 1) & (idx <= k[:, None] - 1)
    return is_spec & interior


def _chain_modes(scene, pos, prim, K):
    """(N,K+1) int32 per-vertex interaction mode: 0 reflect, 1 refract
    (from the path geometry: crossing the surface = refraction)."""
    N = pos.shape[0]
    modes = jnp.zeros((N, K + 1), jnp.int32)
    for i in range(1, K):
        pr = jnp.maximum(prim[:, i], 0)
        vi = scene.indices[pr]
        v0 = scene.vertices[vi[:, 0]]
        ngv = jnp.cross(scene.vertices[vi[:, 1]] - v0,
                        scene.vertices[vi[:, 2]] - v0)
        d_in = pos[:, i] - pos[:, i - 1]
        d_out = pos[:, i + 1] - pos[:, i]
        crossed = m.dot(d_in, ngv) * m.dot(d_out, ngv) > 0
        modes = modes.at[:, i].set(crossed.astype(jnp.int32))
    return modes


_SPEC_DOT_TOL = 5e-4   # direction consistency: angle < ~0.03 rad


def _spec_eval(sp, wi_l, wo_l):
    """Delta-BSDF evaluation at a chain vertex with both directions known.

    Returns (w (N,3), prob (N,), consistent (N,)): w is the measure-free
    delta coefficient (Fresnel x tint x radiance-compression — i.e. the
    sample()-weight times its lobe probability), prob the lobe-selection
    probability (the transition-density factor of a BSDF-sampled delta
    bounce), consistent whether wo matches the deterministic scatter of wi
    (off-manifold states have zero target)."""
    from ..scene import ir
    flip = bsdflib._apply_twosided(sp, wi_l)
    wi_l = wi_l * flip
    wo_l = wo_l * flip
    N = wi_l.shape[0]
    w = jnp.zeros((N, 3))
    prob = jnp.zeros((N,))
    cons = jnp.zeros((N,), bool)
    fam = sp.type

    def close(a, b):
        return m.dot(a, b) > 1.0 - _SPEC_DOT_TOL

    # conductor: mirror lobe, prob 1 (conductor.cpp)
    sel = fam == ir.BSDF_CONDUCTOR
    ci = m.cos_theta(wi_l)
    ok_c = close(wo_l, m.reflect_local(wi_l)) & (ci > 0)
    f_c = m.fresnel_conductor(ci, sp.eta, sp.k) * sp.specular
    w = jnp.where((sel & ok_c)[:, None], f_c, w)
    prob = jnp.where(sel & ok_c, 1.0, prob)
    cons = jnp.where(sel, ok_c, cons)

    # smooth dielectric: two lobes selected with prob F / 1-F
    # (dielectric.cpp:241 radiance compression on the transmit lobe)
    sel = fam == ir.BSDF_DIELECTRIC
    eta = sp.eta[..., 0]
    fr, cos_t, _, eta_ti = m.fresnel_dielectric(ci, eta)
    is_refl = close(wo_l, m.reflect_local(wi_l))
    is_refr = close(wo_l, m.refract_local(wi_l, eta, cos_t)) & (fr < 1.0)
    w_d = jnp.where(is_refl[:, None], fr[:, None] * sp.specular,
                    ((1.0 - fr) * eta_ti * eta_ti)[:, None]
                    * sp.reflectance)
    p_d = jnp.where(is_refl, fr, 1.0 - fr)
    ok_d = is_refl | is_refr
    w = jnp.where((sel & ok_d)[:, None], w_d, w)
    prob = jnp.where(sel & ok_d, p_d, prob)
    cons = jnp.where(sel, ok_d, cons)

    # thin dielectric: R' = 2R/(1+R), transmit = pass-through
    sel = fam == ir.BSDF_THIN_DIELECTRIC
    fr_t, _, _, _ = m.fresnel_dielectric(jnp.abs(ci), eta)
    fr2 = m.safe_div(2.0 * fr_t, 1.0 + fr_t)
    is_refl_t = close(wo_l, m.reflect_local(wi_l))
    is_pass = close(wo_l, -wi_l)
    w_t = jnp.where(is_refl_t[:, None], fr2[:, None] * sp.specular,
                    (1.0 - fr2)[:, None] * sp.reflectance)
    p_t = jnp.where(is_refl_t, fr2, 1.0 - fr2)
    ok_t = is_refl_t | is_pass
    w = jnp.where((sel & ok_t)[:, None], w_t, w)
    prob = jnp.where(sel & ok_t, p_t, prob)
    cons = jnp.where(sel, ok_t, cons)
    return w, prob, cons


def _gather_chain(prim, spec, modes_all, a, K):
    """Chain description starting at vertex a+1 (static a): padded prim /
    mode arrays (N, K-1), true length, and the end (non-spec) vertex."""
    M = max(K - 1, 1)
    idxs = jnp.clip(a + 1 + jnp.arange(M), 0, K)
    in_range = (a + 1 + jnp.arange(M)) <= K
    ch_spec = spec[:, idxs] & in_range[None, :]
    run = jnp.cumprod(ch_spec.astype(jnp.int32), axis=1).astype(bool)
    m_len = run.sum(axis=1).astype(jnp.int32)
    chain_prim = jnp.where(run, prim[:, idxs], 0)
    ch_modes = jnp.where(run, modes_all[:, idxs], 0)
    end_idx = jnp.clip(a + 1 + m_len, 0, K)
    end_prim = jnp.take_along_axis(prim, end_idx[:, None], 1)[:, 0]
    return chain_prim, ch_modes, m_len, end_idx, end_prim


def _gather_chain_dyn(prim, spec, modes_all, a, K):
    """_gather_chain with a per-lane (dynamic) start vertex a (N,)."""
    M = max(K - 1, 1)
    offs = jnp.arange(M)[None, :]
    raw = a[:, None] + 1 + offs
    idxs = jnp.clip(raw, 0, K)
    in_range = raw <= K
    ch_spec = jnp.take_along_axis(spec, idxs, 1) & in_range
    run = jnp.cumprod(ch_spec.astype(jnp.int32), axis=1).astype(bool)
    m_len = run.sum(axis=1).astype(jnp.int32)
    chain_prim = jnp.where(run, jnp.take_along_axis(prim, idxs, 1), 0)
    ch_modes = jnp.where(run, jnp.take_along_axis(modes_all, idxs, 1), 0)
    end_idx = jnp.clip(a + 1 + m_len, 0, K)
    end_prim = jnp.take_along_axis(prim, end_idx[:, None], 1)[:, 0]
    return chain_prim, ch_modes, m_len, end_idx, end_prim


def _chain_G_product(scene, pos, prim, k, K, spec, modes_all, gen_from=None):
    """Product over maximal specular chains of the generalized geometric
    term (dw at the chain start per dA at the first non-spec vertex after
    it). gen_from: optional (N,) cut — only chains whose start vertex
    a >= gen_from contribute (transition-density use)."""
    from ..ops import manifold
    N = pos.shape[0]
    g_prod = jnp.ones((N,))
    for a in range(0, K):
        start = (~spec[:, a]) & (a <= k - 1)
        nxt = min(a + 1, K)
        start = start & spec[:, nxt]
        if gen_from is not None:
            start = start & (a >= gen_from)
        chain_prim, ch_modes, m_len, _, end_prim = _gather_chain(
            prim, spec, modes_all, a, K)
        x0 = pos[:, a]
        d0 = m.normalize(pos[:, nxt] - x0)
        g = manifold.generalized_G(scene, x0, d0, chain_prim, ch_modes,
                                   jnp.maximum(m_len, 1), end_prim)
        g_prod = g_prod * jnp.where(start, g, 1.0)
    return g_prod


def eval_path(scene, cam, pos, prim, k, K):
    """f(path) with visibility, + (color, lum, pixel index, ok).

    With pure-delta materials in the scene, paths may carry specular
    chains: chain edges drop their cos/d^2 factors, chain vertices
    contribute the delta coefficient (_spec_eval), and each maximal chain
    multiplies one generalized geometric term (quotient-manifold measure,
    manifold.cpp multiG)."""
    n = pos.shape[0]
    eye = cam.to_world[:3, 3]
    families = scene.bsdf_families

    v1 = pos[:, 1]
    d1 = m.normalize(v1 - eye[None, :])
    we, _ = _cam_we(cam, d1)
    px, py, rvalid, _ = sensorlib.world_to_raster(cam, v1)
    xi = jnp.clip(px.astype(jnp.int32), 0, cam.width - 1)
    yi = jnp.clip(py.astype(jnp.int32), 0, cam.height - 1)
    pixel = yi * cam.width + xi

    has_spec = _scene_has_spec(scene)
    if has_spec:
        spec = _spec_flags(scene, prim, k, K)
        modes_all = _chain_modes(scene, pos, prim, K)

    f = jnp.ones((n, 3)) * we[:, None]
    ok = rvalid & (k >= 1)
    prev = jnp.broadcast_to(eye, (n, 3))
    for i in range(1, K + 1):
        on_path = i <= k
        si, d_in, dist = _si_at(scene, prev, pos[:, i], prim[:, i])
        cos_in = jnp.abs(m.dot(d_in, si["ng"]))
        geom = cos_in / jnp.maximum(dist * dist, 1e-12)
        if has_spec:
            # chain edges (touching a spec vertex) carry no cos/d^2 —
            # the chain's generalized G replaces them
            chain_edge = spec[:, i - 1] | spec[:, i]
            geom = jnp.where(chain_edge, 1.0, geom)
        f = jnp.where(on_path[:, None], f * geom[:, None], f)
        blocked = trace.shadow_blocked(scene, prev, d_in, dist, False)
        ok = ok & (~blocked | ~on_path)

        is_end = i == k
        # interior vertex: BSDF toward the next vertex
        if i < K:
            nxt = pos[:, i + 1] if i + 1 <= K else pos[:, i]
            sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
            wi_l = m.to_local(si["ns"], -d_in)
            wo_w = m.normalize(nxt - pos[:, i])
            wo_l = m.to_local(si["ns"], wo_w)
            fs, _ = bsdflib.eval_pdf(sp, wi_l, wo_l, families)
            if has_spec:
                w_sp, _, cons = _spec_eval(sp, wi_l, wo_l)
                fs = jnp.where(spec[:, i, None],
                               jnp.where(cons[:, None], w_sp, 0.0), fs)
            f = jnp.where((on_path & ~is_end)[:, None], f * fs, f)
        # terminal vertex: area-emitter radiance toward v_{k-1}
        em_id = si["emitter"]
        cos_e = m.dot(-d_in, si["ng"])
        le = scene.emitters.radiance[jnp.maximum(em_id, 0)]
        hit_ok = (em_id >= 0) & (cos_e > 0.0)
        f = jnp.where((on_path & is_end)[:, None],
                      jnp.where(hit_ok[:, None], f * le, 0.0), f)
        prev = jnp.where(on_path[:, None], pos[:, i], prev)

    if has_spec:
        g = _chain_G_product(scene, pos, prim, k, K, spec, modes_all)
        f = f * g[:, None]

    f = jnp.where(ok[:, None], f, 0.0)
    f = jnp.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
    return f, jnp.matmul(f, LUM, precision=jax.lax.Precision.HIGHEST), pixel


def _bsdf_area_pdf(scene, v_prev, v, prim, v_next, prim_next,
                   spec_here=None, spec_next=None):
    """Area-measure pdf of generating v_next by BSDF-sampling at v.

    Specular-chain variants (manifold tier): at a delta vertex the factor
    is the lobe-selection probability alone; sampling INTO a chain keeps
    the solid-angle pdf unconverted (the chain's generalized G supplies
    the conversion at the chain end)."""
    si, d_in, _ = _si_at(scene, v_prev, v, prim)
    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
    wi_l = m.to_local(si["ns"], -d_in)
    dvec = v_next - v
    d2 = jnp.maximum(m.dot(dvec, dvec), 1e-12)
    wdir = dvec * jax.lax.rsqrt(d2)[:, None]
    wo_l = m.to_local(si["ns"], wdir)
    _, pdf_sa = bsdflib.eval_pdf(sp, wi_l, wo_l, scene.bsdf_families)
    si_n, d_n, _ = _si_at(scene, v, v_next, prim_next)
    cos_n = jnp.abs(m.dot(d_n, si_n["ng"]))
    p_area = pdf_sa * cos_n / d2
    if spec_here is None:
        return p_area
    _, prob_sp, cons = _spec_eval(sp, wi_l, wo_l)
    p = jnp.where(spec_next, pdf_sa, p_area)       # into-chain: SA only
    p = jnp.where(spec_here, jnp.where(cons, prob_sp, 0.0), p)
    return p


def _geom_jac(scene, v_from, v_to, prim_to):
    """Solid-angle -> area Jacobian |cos| / d^2 at v_to seen from v_from
    (the only asymmetric factor of the D/E angular proposal kernels)."""
    si, d_in, dist = _si_at(scene, v_from, v_to, prim_to)
    return jnp.abs(m.dot(d_in, si["ng"])) / jnp.maximum(dist * dist, 1e-12)


def _cam_area_pdf(scene, cam, v1, prim1):
    """Area pdf of v1 under uniform-raster camera sampling (per pixel)."""
    eye = cam.to_world[:3, 3]
    dvec = v1 - eye[None, :]
    d2 = jnp.maximum(m.dot(dvec, dvec), 1e-12)
    d = dvec * jax.lax.rsqrt(d2)[:, None]
    we, cos_c = _cam_we(cam, d)
    # pdf_sa for uniform-over-one-pixel = we/(w*h)*... : uniform raster
    # over the FULL film has pdf_sa = 1/(A_film cos^3) = we/npix
    npix = jnp.float32(cam.width * cam.height)
    pdf_sa = we / npix
    si, d_in, _ = _si_at(scene, jnp.broadcast_to(eye, v1.shape), v1, prim1)
    cos_1 = jnp.abs(m.dot(d_in, si["ng"]))
    return pdf_sa * cos_1 / d2


def regen_pdf(scene, cam, pos, prim, k, c, K, mode_hit):
    """Transition density of regenerating THIS path's suffix after cut c
    (used for both forward and reverse acceptance factors).

    connect mode: Pi_{i=c..k-2} p_bsdf_area(v_{i+1}) * p_light_area(v_k)
    hit mode:     Pi_{i=c..k-1} p_bsdf_area(v_{i+1})
    (at c=0 the first factor is the camera area pdf of v1).
    """
    n = pos.shape[0]
    eye = jnp.broadcast_to(cam.to_world[:3, 3], (n, 3))
    has_spec = _scene_has_spec(scene)
    if has_spec:
        spec = _spec_flags(scene, prim, k, K)
        modes_all = _chain_modes(scene, pos, prim, K)
    p = jnp.ones((n,))
    # camera factor: v1 is camera-sampled iff c=0 AND v1 is a traced vertex
    # (connect mode with k=1 sets v1 from the LIGHT sampler instead)
    p_cam = _cam_area_pdf(scene, cam, pos[:, 1], prim[:, 1])
    if has_spec:
        # spec v1: solid-angle raster pdf only (chain G converts at end)
        d1 = m.normalize(pos[:, 1] - eye)
        we1, _ = _cam_we(cam, d1)
        npix = jnp.float32(cam.width * cam.height)
        p_cam = jnp.where(spec[:, 1], we1 / npix, p_cam)
    use_cam = (c == 0) & (mode_hit | (k >= 2))
    p = jnp.where(use_cam, p * p_cam, p)
    for i in range(1, K):
        # bsdf factor generating v_{i+1} by scattering at vertex i; traced
        # targets are v_{c+1}..v_{k-1} (connect) or ..v_k (hit)
        lim = jnp.where(mode_hit, k - 1, k - 2)
        gen = (i >= jnp.maximum(c, 1)) & (i <= lim)
        v_prev = pos[:, i - 1] if i >= 1 else eye
        nxt = min(i + 1, K)
        if has_spec:
            pb = _bsdf_area_pdf(scene, v_prev, pos[:, i], prim[:, i],
                                pos[:, nxt], prim[:, nxt],
                                spec_here=spec[:, i],
                                spec_next=spec[:, nxt])
        else:
            pb = _bsdf_area_pdf(scene, v_prev, pos[:, i], prim[:, i],
                                pos[:, nxt], prim[:, nxt])
        p = jnp.where(gen, p * pb, p)
        # hit mode stops at the FIRST emitter: a path with an emissive
        # intermediate vertex is unreachable (its reverse density is 0)
        inter_emissive = (scene.tri_emitter[jnp.maximum(prim[:, i], 0)]
                          >= 0) & (i >= c + 1) & (i <= k - 1)
        p = jnp.where(mode_hit & inter_emissive, 0.0, p)
    end_prim = _take_v(prim, jnp.clip(k, 0, K))
    p_l = _light_area_pdf(scene, end_prim)
    p = jnp.where(mode_hit, p, p * p_l)
    if has_spec:
        # chains generated within the suffix: SA->area conversion via the
        # generalized geometric term (same factor structure as eval_path)
        g = _chain_G_product(scene, pos, prim, k, K, spec, modes_all,
                             gen_from=c)
        p = p * g
    return jnp.maximum(p, 0.0)


def _sample_light_point(scene, u3):
    """Fresh area-light vertex (pos, prim) ~ the emitter area CDF."""
    from ..core import warp

    em = scene.emitters
    idx = jnp.clip(jnp.searchsorted(em.tri_cdf, u3[:, 0], side="left"),
                   0, em.tri_cdf.shape[0] - 1).astype(jnp.int32)
    tri = em.tri_index[idx]
    p0, e1, e2 = scene.tri_vertices()
    b = warp.square_to_uniform_triangle(u3[:, 1:3])
    pos = p0[tri] + e1[tri] * b[:, 0:1] + e2[tri] * b[:, 1:2]
    return pos, tri


def _regen(scene, cam, key, pos, prim, k, c, k_new, K, mode_hit):
    """Regenerate the suffix after cut c in-place -> proposal state.

    connect mode: trace (k_new-c-1) vertices, then a fresh light vertex.
    hit mode: trace until an emitter is hit (k determined by the trace).
    Returns (pos', prim', k', gen_ok).
    """
    n = pos.shape[0]
    eye = jnp.broadcast_to(cam.to_world[:3, 3], (n, 3))
    families = scene.bsdf_families
    keys = jax.random.split(key, K + 2)

    # current vertex of the walk = the cut vertex
    v_cur = jnp.where((c == 0)[:, None], eye, _take_v(pos, c))
    cm1 = jnp.maximum(c - 1, 0)
    v_prev = jnp.where((c <= 1)[:, None], eye, _take_v(pos, cm1))
    prim_cur = _take_v(prim, c)

    pos_n, prim_n = pos, prim
    alive = jnp.ones((n,), bool)
    done_hit = jnp.zeros((n,), bool)
    k_hit = jnp.full((n,), K + 1, jnp.int32)

    for j in range(K):
        tgt = c + 1 + j                     # vertex index being generated
        u = jax.random.uniform(keys[j], (n, 4))
        # direction: camera sampling when generating v1 from the eye,
        # BSDF sampling otherwise
        px = u[:, 0] * cam.width
        py = u[:, 1] * cam.height
        o_c, d_c, _ = sensorlib.sample_rays(cam, px, py, u[:, 2:4])
        si, d_in, _ = _si_at(scene, v_prev, v_cur, prim_cur)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
        wi_l = m.to_local(si["ns"], -d_in)
        wo_l, _, pdf_s, _ = bsdflib.sample(sp, wi_l, u[:, 0],
                                           u[:, 1:3], families)
        d_b = m.to_world(si["ns"], wo_l)
        from_eye = (tgt == 1)
        d_new = jnp.where(from_eye[:, None], d_c, d_b)
        o_new = jnp.where(from_eye[:, None], o_c, v_cur)
        pdf_ok = jnp.where(from_eye, True, pdf_s > 0)

        # stop tracing once this lane generated its last traced vertex
        n_trace = jnp.where(mode_hit, K - c, k_new - c - 1)
        gen = alive & (j < n_trace) & ~done_hit
        its = trace.closest_hit(scene, o_new, d_new)
        v_next = o_new + its.t[:, None] * d_new
        lane_ok = gen & its.valid & pdf_ok
        pos_n = _set_v(pos_n, tgt, v_next, lane_ok)
        prim_n = _set_v(prim_n, tgt, its.prim, lane_ok)
        alive = jnp.where(gen, lane_ok, alive)

        # hit-mode termination: emitter reached
        em_hit = scene.tri_emitter[jnp.maximum(its.prim, 0)] >= 0
        newly = lane_ok & mode_hit & em_hit
        k_hit = jnp.where(newly & ~done_hit, tgt, k_hit)
        done_hit = done_hit | newly

        v_prev = jnp.where(lane_ok[:, None], v_cur, v_prev)
        v_cur = jnp.where(lane_ok[:, None], v_next, v_cur)
        prim_cur = jnp.where(lane_ok, its.prim, prim_cur)

    # connect mode: fresh light vertex at index k_new
    u_l = jax.random.uniform(keys[K], (n, 3))
    lpos, lprim = _sample_light_point(scene, u_l)
    pos_n = _set_v(pos_n, k_new, lpos, ~mode_hit & alive)
    prim_n = _set_v(prim_n, k_new, lprim, ~mode_hit & alive)

    k_out = jnp.where(mode_hit, k_hit, k_new).astype(jnp.int32)
    ok = alive & jnp.where(mode_hit, done_hit, True) & (k_out <= K)
    return pos_n, prim_n, k_out, ok


# ---------------------------------------------------------------------------
# Render driver
# ---------------------------------------------------------------------------


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 14,
           n_mutations: int = 384, n_bootstrap: int = 1 << 16,
           return_stats: bool = False):
    """MLT render -> (H, W, 3) [, stats dict with acceptance rates]."""
    w, h = cam.width, cam.height
    K = cfg.max_depth
    key = jax.random.PRNGKey(cfg.seed)
    kb, kr, km = jax.random.split(key, 3)

    # ---- bootstrap: independence proposals (mode A, c=0) ----------------
    zero = jnp.zeros((n_bootstrap,), jnp.int32)
    kb1, kb2, kb3 = jax.random.split(kb, 3)
    k_new0 = jax.random.randint(kb1, (n_bootstrap,), 1, K + 1)
    # vertex slot 0 is the camera position (regen_pdf reads pos[:, 0] as
    # the predecessor of v1)
    pos0 = jnp.zeros((n_bootstrap, K + 1, 3)
                     ).at[:, 0].set(cam.to_world[:3, 3])
    prim0 = jnp.full((n_bootstrap, K + 1), -1, jnp.int32)
    posb, primb, kb_, okb = _regen(
        scene, cam, kb2, pos0, prim0, jnp.ones((n_bootstrap,), jnp.int32),
        zero, k_new0, K, jnp.zeros((n_bootstrap,), bool))
    fb, lb, _ = eval_path(scene, cam, posb, primb, kb_, K)
    lb = jnp.where(okb, lb, 0.0)
    t0 = regen_pdf(scene, cam, posb, primb, kb_, zero, K,
                   jnp.zeros((n_bootstrap,), bool))
    t0 = t0 / jnp.float32(K)            # the uniform k_new choice
    wgt = jnp.where((t0 > 0) & (lb > 0), lb / jnp.maximum(t0, 1e-30), 0.0)
    b = jnp.mean(wgt)

    cdf = jnp.cumsum(wgt)
    total = jnp.maximum(cdf[-1], 1e-30)
    picks = jax.random.uniform(kr, (n_chains,)) * total
    sidx = jnp.clip(jnp.searchsorted(cdf, picks), 0, n_bootstrap - 1)
    pos_c, prim_c, k_c = posb[sidx], primb[sidx], kb_[sidx]
    f_c, l_c, px_c = eval_path(scene, cam, pos_c, prim_c, k_c, K)

    has_spec = _scene_has_spec(scene)

    # ---- chains ---------------------------------------------------------
    def step(carry, inp):
        pos_x, prim_x, k_x, f_x, l_x, px_x, img, acc = carry
        kk, mode_i = inp
        k1, k2, k3, k4, k5 = jax.random.split(kk, 5)
        n = n_chains
        is_B = mode_i == 1
        is_C = mode_i == 2
        is_D = mode_i == 3
        is_E = mode_i == 4
        is_F = mode_i == 5
        mode_hit = jnp.broadcast_to(is_B, (n,))

        # ---- propose ----
        u = jax.random.uniform(k1, (n, 4))
        if has_spec:
            # cuts and perturbation anchors live on NON-SPEC vertices only
            # (delta vertices are derived state on the quotient manifold)
            spec_x = _spec_flags(scene, prim_x, k_x, K)
            modes_x = _chain_modes(scene, pos_x, prim_x, K)
            idxv = jnp.arange(K + 1)[None, :]
            elig_x = (~spec_x) & (idxv <= (k_x - 1)[:, None])
            cnt_x = elig_x.sum(1).astype(jnp.int32)

            def pick_nonspec(uu):
                pk = jnp.clip((uu * cnt_x).astype(jnp.int32), 0,
                              jnp.maximum(cnt_x - 1, 0))
                ranks = jnp.cumsum(elig_x.astype(jnp.int32), axis=1) - 1
                oh = elig_x & (ranks == pk[:, None])
                return (oh * jnp.arange(K + 1)[None, :]).sum(1).astype(
                    jnp.int32)

            c = pick_nonspec(u[:, 0])
        else:
            c = (u[:, 0] * k_x.astype(jnp.float32)).astype(jnp.int32)
            c = jnp.clip(c, 0, jnp.maximum(k_x - 1, 0))
        # A: k' uniform in [c+1, K]; B: determined by the trace
        span = (K - c).astype(jnp.float32)
        k_new = c + 1 + (u[:, 1] * span).astype(jnp.int32)
        k_new = jnp.clip(k_new, c + 1, K)

        pos_ab, prim_ab, k_ab, ok_ab = _regen(
            scene, cam, k2, pos_x, prim_x, k_x, c, k_new, K, mode_hit)

        # C: lens perturbation — exponential raster offset, retrace v1
        eye = cam.to_world[:3, 3]
        px0, py0, _, _ = sensorlib.world_to_raster(cam, pos_x[:, 1])
        r1, r2 = 0.25, 0.05 * jnp.float32(max(w, h))
        r = r2 * jnp.exp(-jnp.log(r2 / r1) * u[:, 1])
        phi = 2.0 * jnp.pi * u[:, 2]
        pxn = px0 + r * jnp.cos(phi)
        pyn = py0 + r * jnp.sin(phi)
        o_c, d_c, _ = sensorlib.sample_rays(
            cam, pxn, pyn, jnp.zeros((n, 2)))
        its1 = trace.closest_hit(scene, o_c, d_c)
        v1n = o_c + its1.t[:, None] * d_c
        pos_cc = pos_x.at[:, 1].set(jnp.where(its1.valid[:, None],
                                              v1n, pos_x[:, 1]))
        prim_cc = prim_x.at[:, 1].set(jnp.where(its1.valid, its1.prim,
                                                prim_x[:, 1]))
        ok_cc = its1.valid & (pxn >= 0) & (pxn < w) & (pyn >= 0) & (pyn < h)

        # D: caustic perturbation — exponential polar offset of the
        # v2->v1 direction (Veach p.354: theta range scaled from the
        # per-pixel angle), one-edge retrace, deterministic eye link
        u2 = jax.random.uniform(k3, (n, 4))
        rpp = jnp.deg2rad(cam.fov_x) / jnp.float32(w)   # rad per pixel
        th1 = 0.25 * rpp
        th2 = rpp * jnp.sqrt(0.05 * w * h / jnp.pi)
        theta = th2 * jnp.exp(-jnp.log(th2 / th1) * u2[:, 2])
        sphi = 2.0 * jnp.pi * u2[:, 3]
        offs = jnp.stack([jnp.sin(theta) * jnp.cos(sphi),
                          jnp.sin(theta) * jnp.sin(sphi),
                          jnp.cos(theta)], axis=-1)
        wo_old = m.normalize(pos_x[:, 1] - pos_x[:, 2])
        wo_new = m.to_world(wo_old, offs)
        its_d = trace.closest_hit(scene, pos_x[:, 2], wo_new)
        v1d = pos_x[:, 2] + its_d.t[:, None] * wo_new
        pos_dd = pos_x.at[:, 1].set(
            jnp.where(its_d.valid[:, None], v1d, pos_x[:, 1]))
        prim_dd = prim_x.at[:, 1].set(
            jnp.where(its_d.valid, its_d.prim, prim_x[:, 1]))
        ok_dd = its_d.valid & (k_x >= 2)

        # E: multi-chain — lens offset of v1 chained with a same-kernel
        # angular offset of the old v1->v2 direction, retrace both,
        # reconnect v2->v3 (mut_mchain.h:36)
        r_e = r2 * jnp.exp(-jnp.log(r2 / r1) * u2[:, 0])
        phi_e = 2.0 * jnp.pi * u2[:, 1]
        pxe = px0 + r_e * jnp.cos(phi_e)
        pye = py0 + r_e * jnp.sin(phi_e)
        o_e, d_e, _ = sensorlib.sample_rays(cam, pxe, pye,
                                            jnp.zeros((n, 2)))
        its_e1 = trace.closest_hit(scene, o_e, d_e)
        v1e = o_e + its_e1.t[:, None] * d_e
        wo12_old = m.normalize(pos_x[:, 2] - pos_x[:, 1])
        wo12_new = m.to_world(wo12_old, offs)
        its_e2 = trace.closest_hit(scene, v1e, wo12_new)
        v2e = v1e + its_e2.t[:, None] * wo12_new
        ok_ee = (its_e1.valid & its_e2.valid & (k_x >= 3)
                 & (pxe >= 0) & (pxe < w) & (pye >= 0) & (pye < h))
        okm = ok_ee[:, None]
        pos_ee = pos_x.at[:, 1].set(jnp.where(okm, v1e, pos_x[:, 1])
                                    ).at[:, 2].set(
                                        jnp.where(okm, v2e, pos_x[:, 2]))
        prim_ee = prim_x.at[:, 1].set(
            jnp.where(ok_ee, its_e1.prim, prim_x[:, 1])).at[:, 2].set(
                jnp.where(ok_ee, its_e2.prim, prim_x[:, 2]))

        # F: manifold perturbation (mut_manifold.cpp) — perturb the
        # direction out of a non-spec vertex a, propagate deterministically
        # through the a..b specular chain (real retrace), then re-solve the
        # b..c chain with the manifold walk so c stays fixed; a reverse
        # walk enforces reversibility (mut_manifold.cpp:510-520).
        # Gated behind lax.cond: the walks (dozens of traced Newton
        # iterations) must not execute on A..E scan steps.
        if has_spec:
            from ..ops import manifold as manif
            MC = max(K - 1, 1)
            def propose_manifold(_):
                uf = jax.random.uniform(k5, (n, 1))
                a_f = pick_nonspec(uf[:, 0])
                ch_prim_a, ch_modes_a, mlen_a, b_idx, bprim_x = \
                    _gather_chain_dyn(prim_x, spec_x, modes_x, a_f, K)
                pos_a = _take_v(pos_x, a_f)
                pos_a1 = _take_v(pos_x, jnp.clip(a_f + 1, 0, K))
                pos_b_old = _take_v(pos_x, b_idx)
                wo_old_f = m.normalize(pos_a1 - pos_a)
                wo_new_f = m.to_world(wo_old_f, offs)  # D's angular kernel
                exp_mat = scene.tri_material[jnp.maximum(ch_prim_a, 0)]
                cp_ab, cpr_ab, b_new, bprim_new, ok_ab_f = \
                    manif._real_retrace(scene, pos_a, pos_a + wo_new_f,
                                        ch_modes_a, mlen_a, exp_mat)
                # moved endpoint must stay non-spec (isConnectable())
                from ..scene import ir as _irm
                fam_b = scene.materials.type[
                    scene.tri_material[jnp.maximum(bprim_new, 0)]]
                b_nonspec = ~((fam_b == _irm.BSDF_CONDUCTOR)
                              | (fam_b == _irm.BSDF_DIELECTRIC)
                              | (fam_b == _irm.BSDF_THIN_DIELECTRIC))
                # b..c chain (seen from the fixed anchor c)
                _, _, mlen_bc, c_idx, _ = _gather_chain_dyn(
                    prim_x, spec_x, modes_x, b_idx, K)
                need_walk = (mlen_bc >= 1) & (b_idx < k_x)
                pos_c = _take_v(pos_x, c_idx)
                # reversed chain arrays: first spec vertex from c is c-1
                offs_r = jnp.arange(MC)[None, :]
                raw_r = c_idx[:, None] - 1 - offs_r
                idxs_r = jnp.clip(raw_r, 0, K)
                run_r = raw_r >= (b_idx + 1)[:, None]
                rev_modes = jnp.where(
                    run_r, jnp.take_along_axis(modes_x, idxs_r, 1), 0)
                x1_w = _take_v(pos_x, jnp.clip(c_idx - 1, 0, K))
                mlen_w = jnp.maximum(mlen_bc, 1)
                resw = manif.walk(scene, pos_c, x1_w, rev_modes, mlen_w,
                                  b_new)
                # reversibility: walking back to the old b must recover
                # the old chain head (mut_manifold.cpp statsNonReversible)
                resr = manif.walk(scene, pos_c, resw.chain_pos[:, 0],
                                  rev_modes, mlen_w, pos_b_old)
                scale_f = 1.0 + m.length(pos_b_old - pos_c)
                rev_ok = resr.ok & (m.length(resr.chain_pos[:, 0] - x1_w)
                                    < 1e-3 * scale_f)
                walk_ok = jnp.where(need_walk, resw.ok & rev_ok, True)

                ok_f = ok_ab_f & b_nonspec & walk_ok & (k_x >= 1)
                pos_f, prim_f = pos_x, prim_x
                for j in range(MC):
                    slot = jnp.clip(a_f + 1 + j, 0, K)
                    mj = (j < mlen_a) & ok_f
                    pos_f = _set_v(pos_f, slot, cp_ab[:, j], mj)
                    prim_f = _set_v(prim_f, slot, cpr_ab[:, j], mj)
                    slot2 = jnp.clip(c_idx - 1 - j, 0, K)
                    mj2 = (j < mlen_bc) & need_walk & ok_f
                    pos_f = _set_v(pos_f, slot2, resw.chain_pos[:, j], mj2)
                    prim_f = _set_v(prim_f, slot2, resw.chain_prim[:, j],
                                    mj2)
                pos_f = _set_v(pos_f, b_idx, b_new, ok_f)
                prim_f = _set_v(prim_f, b_idx, bprim_new, ok_f)
                # proposal Jacobians: the angular kernel is symmetric;
                # only the dw_a -> dA_b conversions (generalized G) remain
                gx = manif.generalized_G(scene, pos_a, wo_old_f, ch_prim_a,
                                         ch_modes_a, mlen_a, bprim_x)
                y_a1 = jnp.where((mlen_a >= 1)[:, None], cp_ab[:, 0],
                                 b_new)
                gy = manif.generalized_G(
                    scene, pos_a, m.normalize(y_a1 - pos_a), cpr_ab,
                    ch_modes_a, mlen_a, bprim_new)
                ok_f = ok_f & (gx > 0) & (gy > 0)
                return pos_f, prim_f, ok_f, gx, gy

            def skip_manifold(_):
                return (pos_x, prim_x, jnp.zeros((n,), bool),
                        jnp.ones((n,)), jnp.ones((n,)))

            pos_ff, prim_ff, ok_ff, g_f_x, g_f_y = jax.lax.cond(
                is_F, propose_manifold, skip_manifold, operand=None)

        pos_y = jnp.where(is_C, pos_cc,
                          jnp.where(is_D, pos_dd,
                                    jnp.where(is_E, pos_ee, pos_ab)))
        prim_y = jnp.where(is_C, prim_cc,
                           jnp.where(is_D, prim_dd,
                                     jnp.where(is_E, prim_ee, prim_ab)))
        k_y = jnp.where(is_C | is_D | is_E, k_x, k_ab)
        ok_y = jnp.where(is_C, ok_cc,
                         jnp.where(is_D, ok_dd,
                                   jnp.where(is_E, ok_ee, ok_ab)))
        if has_spec:
            pos_y = jnp.where(is_F, pos_ff, pos_y)
            prim_y = jnp.where(is_F, prim_ff, prim_y)
            k_y = jnp.where(is_F, k_x, k_y)
            ok_y = jnp.where(is_F, ok_ff, ok_y)

        # ---- evaluate + accept ----
        f_y, l_y, px_y = eval_path(scene, cam, pos_y, prim_y, k_y, K)
        l_y = jnp.where(ok_y, l_y, 0.0)

        # transition densities (A/B); C's extra factors: the raster offset
        # pdf is symmetric, only the raster->area Jacobians remain
        t_xy_ab = regen_pdf(scene, cam, pos_y, prim_y, k_y, c, K, mode_hit)
        t_yx_ab = regen_pdf(scene, cam, pos_x, prim_x, k_x, c, K, mode_hit)
        n_len = jnp.maximum(span, 1.0)
        if has_spec:
            # cut choice was uniform over NON-SPEC vertices
            spec_y = _spec_flags(scene, prim_y, k_y, K)
            idxy = jnp.arange(K + 1)[None, :]
            cnt_y = ((~spec_y) & (idxy <= (k_y - 1)[:, None])).sum(1)
            den_x = jnp.maximum(cnt_x.astype(jnp.float32), 1.0)
            den_y = jnp.maximum(cnt_y.astype(jnp.float32), 1.0)
        else:
            den_x = jnp.maximum(k_x.astype(jnp.float32), 1.0)
            den_y = jnp.maximum(k_y.astype(jnp.float32), 1.0)
        t_xy_ab = jnp.where(mode_hit, t_xy_ab, t_xy_ab / n_len) / den_x
        t_yx_ab = jnp.where(mode_hit, t_yx_ab, t_yx_ab / n_len) / den_y
        jac_y = _cam_area_pdf(scene, cam, pos_y[:, 1], prim_y[:, 1])
        jac_x = _cam_area_pdf(scene, cam, pos_x[:, 1], prim_x[:, 1])
        # D: the exponential angular kernel is symmetric (same polar
        # angle either way), only the angle->area Jacobian at v1 remains
        g1_y = _geom_jac(scene, pos_y[:, 2], pos_y[:, 1], prim_y[:, 1])
        g1_x = _geom_jac(scene, pos_x[:, 2], pos_x[:, 1], prim_x[:, 1])
        # E: raster Jacobian at v1 times angle->area Jacobian at v2
        g2_y = _geom_jac(scene, pos_y[:, 1], pos_y[:, 2], prim_y[:, 2])
        g2_x = _geom_jac(scene, pos_x[:, 1], pos_x[:, 2], prim_x[:, 2])
        t_xy = jnp.where(is_C, jac_y,
                         jnp.where(is_D, g1_y,
                                   jnp.where(is_E, jac_y * g2_y, t_xy_ab)))
        t_yx = jnp.where(is_C, jac_x,
                         jnp.where(is_D, g1_x,
                                   jnp.where(is_E, jac_x * g2_x, t_yx_ab)))
        if has_spec:
            # F: symmetric angular kernel; dw->dA conversion through the
            # respective paths' a..b chains
            t_xy = jnp.where(is_F, g_f_y, t_xy)
            t_yx = jnp.where(is_F, g_f_x, t_yx)

        num = l_y * t_yx
        den = l_x * t_xy
        a = jnp.clip(m.safe_div(num, jnp.maximum(den, 1e-30)), 0.0, 1.0)
        a = jnp.where((l_x <= 0) | (den <= 0),
                      jnp.where(l_y > 0, 1.0, 0.0), a)
        a = jnp.where(ok_y, a, 0.0)

        # ---- expected-value splats (both states) ----
        w_x = jnp.where(l_x > 0, (1.0 - a) * b / jnp.maximum(l_x, 1e-12),
                        0.0)
        w_y = jnp.where(l_y > 0, a * b / jnp.maximum(l_y, 1e-12), 0.0)
        img = img.at[px_x].add(f_x * w_x[:, None])
        img = img.at[px_y].add(f_y * w_y[:, None])

        take = jax.random.uniform(k4, (n,)) < a
        pos_x = jnp.where(take[:, None, None], pos_y, pos_x)
        prim_x = jnp.where(take[:, None], prim_y, prim_x)
        k_x = jnp.where(take, k_y, k_x)
        f_x = jnp.where(take[:, None], f_y, f_x)
        l_x = jnp.where(take, l_y, l_x)
        px_x = jnp.where(take, px_y, px_x)
        acc = acc.at[mode_i].add(jnp.mean(a))
        return (pos_x, prim_x, k_x, f_x, l_x, px_x, img, acc), None

    n_modes = 6 if has_spec else 5      # F only exists with delta chains
    img0 = jnp.zeros((w * h, 3))
    acc0 = jnp.zeros((n_modes,))
    keys = jax.random.split(km, n_mutations)
    modes = jnp.arange(n_mutations, dtype=jnp.int32) % n_modes
    (_, _, _, _, _, _, img, acc), _ = jax.lax.scan(
        step, (pos_c, prim_c, k_c, f_c, l_c, px_c, img0, acc0),
        (keys, modes))

    # f carries the per-pixel-uniform camera importance (npix/A_film...),
    # so the b-normalized splat sum/(chains*mutations) IS the per-pixel
    # radiance estimate — no extra w*h factor.
    img = img / jnp.float32(n_chains * n_mutations)
    img = img.reshape(h, w, 3)
    if return_stats:
        per_mode = acc / jnp.maximum(
            jnp.float32(n_mutations) / n_modes, 1.0)
        return img, {"acceptance": per_mode, "b": b}
    return img


def render_jit(scene, cam, cfg: RenderConfig, **kw):
    return jax.jit(partial(render, cfg=cfg, **kw))(scene, cam)
