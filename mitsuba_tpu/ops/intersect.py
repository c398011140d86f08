"""Ray-triangle intersection over ray batches.

Batched replacement for the reference's kd-tree + Wald TriAccel hot loop
(src/librender/skdtree.cpp:135 Havran traversal, triaccel.h:37-59, SSE
packets skdtree.cpp:241): instead of a per-ray recursive traversal, rays are
processed as wide batches of elementwise array work.

Layout note: everything in the hot loop is computed **component-wise** as
(N, C) arrays — rays broadcast down columns, triangle-chunk data across
columns. No (N, C, 3) intermediates and no reductions over a size-3 axis,
so XLA fuses each chunk's test into one elementwise loop with a row
reduction. Barycentrics of the winning triangle are recomputed once after
the loop from the (ray, best-triangle) pair, so the scan carries only
(t, prim). Every product is an explicit float32 multiply-add: no matrix
unit (and so no reduced-precision matmul mode) is involved.

Two paths (ops/trace.py picks one per platform and triangle count):
  * `intersect_brute` — all rays x all triangles: no divergence, no
    pointer chasing; the route for small scenes.
  * BVH traversal for large meshes — ops/bvh_traverse.py + scene/bvh.py.

Watertightness/precision follow the reference's single-precision build
(config-linux-gcc.py:7 -DSINGLE_PRECISION).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as m

SHADOW_EPS = 1e-3
# Barycentric slack: accept hits marginally outside the triangle so rays
# through shared edges/corners can't slip between both triangles (cheap
# watertightness; double hits at seams resolve via closest-t).
BARY_EPS = 1e-6

# triangles tested per scan step (the packed key's lane field, LANE_BITS)
CHUNK = 128

# Miss sentinel = 2^127 (0x7F000000): its low mantissa bits are zero, so the
# lane-id bit-packing in intersect_brute leaves it intact and `t < MISS`
# stays an exact miss test.
MISS = 2.0 ** 127    # plain float: no device allocation at import


class Intersection(NamedTuple):
    """Batched surface interaction record (analog of mitsuba's
    `Intersection`, include/mitsuba/render/shape.h:58)."""

    valid: jax.Array   # (N,) bool
    t: jax.Array       # (N,)
    prim: jax.Array    # (N,) int32 triangle id (0 if invalid)
    b1: jax.Array      # (N,) barycentric
    b2: jax.Array      # (N,)


def _tri_soa(scene, chunk: int):
    """Triangle data as 9 padded (T',) component arrays + n_chunks."""
    p0, e1, e2 = scene.tri_vertices()
    t = p0.shape[0]
    pad = (-t) % chunk
    if pad:
        farv = jnp.full((pad,), 3.0e37, p0.dtype)
        zero = jnp.zeros((pad,), p0.dtype)
        comps = [
            jnp.concatenate([p0[:, k], farv]) for k in range(3)
        ] + [
            jnp.concatenate([e1[:, k], zero]) for k in range(3)
        ] + [
            jnp.concatenate([e2[:, k], zero]) for k in range(3)
        ]
    else:
        comps = [p0[:, k] for k in range(3)] + [e1[:, k] for k in range(3)] \
            + [e2[:, k] for k in range(3)]
    return comps, (t + pad) // chunk


def _chunk_hits(o, d, tri_comps, base, chunk: int, tmax, best_t):
    """Hit tests of every ray against one triangle chunk.

    o, d: ray components as 6 (N, 1) arrays; tri_comps: 9 (T',) arrays.
    Returns (t (N,C) with INF misses, within-chunk argmin j (N,), t_j (N,)).
    """
    ox, oy, oz, dx, dy, dz = o + d  # list concat: 6 arrays
    sl = lambda a: jax.lax.dynamic_slice(a, (base,), (chunk,))[None, :]
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (sl(a) for a in tri_comps)

    # pvec = d x e2  (outer: (N,1) x (1,C) -> (N,C))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    bad = jnp.abs(det) < 1e-12
    inv_det = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, det))
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (
        (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
        & (t > SHADOW_EPS) & (t < best_t[:, None]) & (t < tmax[:, None])
        & ~bad
    )
    return jnp.where(hit, t, MISS)


def _ray_comps(o, d):
    return ([o[:, 0:1], o[:, 1:2], o[:, 2:3]],
            [d[:, 0:1], d[:, 1:2], d[:, 2:3]])


# The hot loop is wrapped in stop_gradient; surface_interaction recomputes
# t/barycentrics differentiably for the winning triangle, so gradients
# w.r.t. vertices flow without differentiating the search.


def intersect_brute(
    scene,
    o: jax.Array,
    d: jax.Array,
    tmax=None,
    chunk: int = CHUNK,
) -> Intersection:
    """Closest-hit Moller-Trumbore over every triangle, scanning triangle
    chunks to bound the (rays x chunk) working set.

    o, d: (N,3). Returns Intersection with t=INF where no hit.
    """
    n = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n,), m.INF)
    tri_comps, nchunks = _tri_soa(scene, chunk)
    oc, dc = _ray_comps(o, d)

    def chunk_t(base):
        return _chunk_hits(oc, dc, tri_comps, base, chunk, tmax,
                           jnp.full((n,), MISS))

    # int-packed (t, tri) keys: positive floats order like their int32 bit
    # patterns, so one integer min-reduce finds BOTH the closest t and a
    # winning triangle id (low bits) — no argmin, no take_along_axis.
    # The key is (t_bits & ~lane_mask) | lane: stealing the low 7 mantissa
    # bits costs ~1e-5 relative t resolution (well below SHADOW_EPS
    # effects); ties break toward the lower lane id.
    lane_bits = 7
    lane_mask = (1 << lane_bits) - 1
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)

    def body(carry, base):
        best_key, best_base = carry
        t = chunk_t(base)
        key = (
            jax.lax.bitcast_convert_type(t, jnp.int32)
            & jnp.int32(~lane_mask)
        ) | lanes
        ckey = jnp.min(key, axis=1)
        better = ckey < best_key
        best_key = jnp.where(better, ckey, best_key)
        best_base = jnp.where(better, base, best_base)
        return (best_key, best_base), None

    inf_key = (jax.lax.bitcast_convert_type(MISS, jnp.int32)
               | jnp.int32(lane_mask))
    init = (jnp.full((n,), inf_key, jnp.int32), jnp.zeros((n,), jnp.int32))
    if nchunks == 1:
        (best_key, best_base), _ = body(init, jnp.int32(0))
    else:
        bases = (jnp.arange(nchunks) * chunk).astype(jnp.int32)
        (best_key, best_base), _ = jax.lax.scan(body, init, bases)
    return _finish_closest(scene, best_key, best_base, n)


LANE_BITS = 7
LANE_MASK = (1 << LANE_BITS) - 1


def _finish_closest(scene, best_key, best_base, n) -> Intersection:
    """Unpack (key, chunk-base) into an Intersection. The search itself is
    not differentiated (see the note above intersect_brute)."""
    best_key = jax.lax.stop_gradient(best_key)
    best_t = jax.lax.bitcast_convert_type(
        best_key & jnp.int32(~LANE_MASK), jnp.float32
    )
    valid = best_t < MISS
    prim_raw = best_base + (best_key & LANE_MASK)
    prim = jnp.where(valid & (prim_raw < scene.num_triangles), prim_raw, 0)
    # b1/b2 are computed lazily by surface_interaction (which gathers the
    # triangle vertices anyway); zeros here.
    z = jnp.zeros((n,), best_t.dtype)
    return Intersection(
        valid=valid,
        t=jnp.where(valid, best_t, m.INF),
        prim=prim,
        b1=z,
        b2=z,
    )


def occluded_brute(
    scene,
    o: jax.Array,
    d: jax.Array,
    tmax: jax.Array,
    chunk: int = CHUNK,
) -> jax.Array:
    """Any-hit shadow query (Scene::rayIntersect shadow variant,
    scene.h:219-242). Returns (N,) bool: True if something blocks
    (SHADOW_EPS, tmax*(1-SHADOW_EPS))."""
    n = o.shape[0]
    limit = tmax * (1.0 - SHADOW_EPS)
    # null-interface triangles (medium boundaries) must not block shadow
    # rays
    has_null = scene is not None and scene.has_null
    tri_comps, nchunks = _tri_soa(scene, chunk)
    oc, dc = _ray_comps(o, d)

    def chunk_t(base):
        return _chunk_hits(oc, dc, tri_comps, base, chunk, limit, limit)

    if has_null:
        t_tris = scene.num_triangles
        pad = (-t_tris) % chunk
        opaque_pad = jnp.concatenate(
            [scene.tri_opaque, jnp.ones((pad,), bool)]) if pad \
            else scene.tri_opaque

    def body(blocked, base):
        t = chunk_t(base)
        hits = t < MISS
        if has_null:
            op = jax.lax.dynamic_slice(opaque_pad, (base,), (chunk,))
            hits = hits & op[None, :]
        return blocked | jnp.any(hits, axis=1), None

    init = jnp.zeros((n,), bool)
    if nchunks == 1:
        blocked, _ = body(init, jnp.int32(0))
    else:
        bases = (jnp.arange(nchunks) * chunk).astype(jnp.int32)
        blocked, _ = jax.lax.scan(body, init, bases)
    return blocked


def _perturb_normal(scene, mat, uv, t0, t1, t2, e1, e2, ns, ng):
    """Normal/bump mapping: perturb the interpolated shading normal.

    A fold of the normalmap/bumpmap BSDF adapters
    (src/bsdfs/{normalmap,bumpmap}.cpp): instead of wrapping the nested
    BSDF in a frame-rotating plugin, the perturbation is applied once here
    and every integrator picks it up through si["ns"]. Compiled only when
    the scene carries a perturb map (`scene.has_perturb` static gate).

    normalmap (kind 1): tangent-space RGB in [0,1], n = 2c-1 in the
    (dpdu, dpdv, ns) frame. bumpmap (kind 2): scalar height field h(u,v);
    the displaced partials dp/du + dh/du * ns, dp/dv + dh/dv * ns define
    the new normal (bumpmap.cpp's getFrame displacement derivative).
    """
    from ..models import texture as tex

    mats = scene.materials
    tid = mats.tex_perturb[mat]
    kind = mats.perturb_kind[mat]
    tsafe = jnp.maximum(tid, 0)

    # uv-space tangent solve on the winning triangle: dp/du, dp/dv
    duv1 = t1 - t0
    duv2 = t2 - t0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    bad = jnp.abs(det) < 1e-12
    inv = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, det))[:, None]
    dpdu = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv
    dpdv = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv
    # degenerate uvs: any orthonormal tangent frame will do
    fu, fv = m.coordinate_system(ns)
    dpdu = jnp.where(bad[:, None], fu, dpdu)
    dpdv = jnp.where(bad[:, None], fv, dpdv)

    # -- normalmap: rotate the tangent-space normal into world space
    c = tex.sample_bilinear(scene, tsafe, uv)
    ntex = 2.0 * c - 1.0
    t_hat = m.normalize(dpdu - ns * m.dot(ns, dpdu, keepdims=True))
    b_hat = m.cross(ns, t_hat)
    # respect the uv handedness so maps baked either way shade correctly
    b_hat = b_hat * jnp.where(m.dot(b_hat, dpdv, keepdims=True) < 0.0, -1.0, 1.0)
    n_nm = m.normalize(t_hat * ntex[:, 0:1] + b_hat * ntex[:, 1:2]
                       + ns * jnp.maximum(ntex[:, 2:3], 1e-3))

    # -- bumpmap: central-difference the height field one texel out
    hw = scene.tex_size[tsafe].astype(jnp.float32)      # (N,2) = (h, w)
    du = 1.0 / jnp.maximum(hw[:, 1], 1.0)
    dv = 1.0 / jnp.maximum(hw[:, 0], 1.0)

    def hgt(uv_):
        return jnp.mean(tex.sample_bilinear(scene, tsafe, uv_), axis=-1)

    eu = jnp.stack([du, jnp.zeros_like(du)], axis=-1)
    ev = jnp.stack([jnp.zeros_like(dv), dv], axis=-1)
    dhdu = (hgt(uv + eu) - hgt(uv - eu)) / (2.0 * du)
    dhdv = (hgt(uv + ev) - hgt(uv - ev)) / (2.0 * dv)
    n_bm = m.cross(dpdu + dhdu[:, None] * ns, dpdv + dhdv[:, None] * ns)
    n_bm = m.normalize(n_bm)
    n_bm = n_bm * jnp.where(m.dot(n_bm, ns, keepdims=True) < 0.0, -1.0, 1.0)

    new = jnp.where((kind == 1)[:, None], n_nm,
                    jnp.where((kind == 2)[:, None], n_bm, ns))
    new = jnp.where(((kind > 0) & (tid >= 0))[:, None], new, ns)
    # keep the geometric-side agreement of the unperturbed path
    return jnp.where(m.dot(new, ng, keepdims=True) < 0.0, -new, new)


def surface_interaction(scene, o, d, its: Intersection,
                        dd_dx=None, dd_dy=None):
    """Expand a hit record into shading data (position, frames, uv, material).

    Analog of Intersection::computePartials + Shape::fillIntersectionRecord.
    Returns dict of batched fields; invalid lanes contain harmless defaults.

    dd_dx/dd_dy: optional (N,3) ray-direction differentials of a 1-pixel
    raster step (sensor.ray_differentials). When given, the uv-space
    footprint gradients `duvdx`/`duvdy` are computed (computePartials,
    intersection.h) — the EWA anisotropic filter driver.

    Barycentrics are (re)computed here from the gathered winning-triangle
    vertices when the intersector returned them as zeros (the brute-force
    path defers them so its hot loop carries only a packed (t, prim) key).
    """
    from .gather import fetch_packed
    # one packed per-face row fetch (ops/gather.py)
    vi = scene.indices
    face_tabs = [
        scene.vertices[vi[:, 0]],
        scene.vertices[vi[:, 1]],
        scene.vertices[vi[:, 2]],
        scene.normals[vi[:, 0]],
        scene.normals[vi[:, 1]],
        scene.normals[vi[:, 2]],
        scene.uvs[vi[:, 0]],
        scene.uvs[vi[:, 1]],
        scene.uvs[vi[:, 2]],
        scene.tri_material[:, None].astype(jnp.float32),
        scene.tri_emitter[:, None].astype(jnp.float32),
    ]
    (v0, v1, v2, n0, n1, n2, t0, t1, t2, matf, emf) = fetch_packed(
        face_tabs, its.prim
    )
    e1 = v1 - v0
    e2 = v2 - v0
    ngv = jnp.cross(e1, e2)
    ng = ngv / m.length(ngv, keepdims=True)

    # barycentrics via Moller-Trumbore on the (single) winning triangle
    pv = jnp.cross(d, e2)
    det = jnp.sum(e1 * pv, axis=-1)
    bad = jnp.abs(det) < 1e-12
    inv_det = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, det))
    tv = o - v0
    b1 = jnp.clip(jnp.sum(tv * pv, axis=-1) * inv_det, 0.0, 1.0)
    qv = jnp.cross(tv, e1)
    b2 = jnp.clip(jnp.sum(d * qv, axis=-1) * inv_det, 0.0, 1.0)

    # Differentiable hit distance: the intersector's t comes out of a
    # stop-gradient'd (and possibly bit-quantised) search key, so vertex-
    # position gradients through the hit POINT would otherwise be dropped.
    # Recompute t from the winning triangle's plane (Moller-Trumbore) and
    # attach only its DERIVATIVE to its.t (zero-primal trick: primal images
    # stay bit-identical to the search result, d(t)/d(vertices) flows).
    t_mt = jnp.sum(e2 * qv, axis=-1) * inv_det
    t_ok = its.valid & ~bad
    t_attach = jnp.where(t_ok, t_mt, its.t)
    t_diff = its.t + (t_attach - jax.lax.stop_gradient(t_attach))
    # invalid lanes carry t = INF; cap the position used for shading so
    # masked-out downstream math (NEE dist^2, MIS pdf ratios) stays
    # finite — an inf/nan primal in a masked lane would otherwise leak
    # NaN into reverse-mode via 0 * nan cotangents (scene scale << 1e6)
    t_pos = jnp.where(its.valid, t_diff, 1.0e6)
    p = o + t_pos[:, None] * d
    # trust intersector-provided barycentrics when present (BVH path)
    has_bary = (its.b1 + its.b2) != 0.0
    b1 = jnp.where(has_bary, its.b1, b1)
    b2 = jnp.where(has_bary, its.b2, b2)

    w0 = (1.0 - b1 - b2)[:, None]
    ns = m.normalize(n0 * w0 + n1 * b1[:, None] + n2 * b2[:, None])
    # Flip shading normal to the geometric side agreement (strict normals
    # handling, reference integrator.h:444 strictNormals is optional).
    ns = jnp.where(m.dot(ns, ng, keepdims=True) < 0.0, -ns, ns)
    uv = t0 * w0 + t1 * b1[:, None] + t2 * b2[:, None]
    # ids ride in the packed float rows exactly (small integers)
    mat = jnp.round(matf[:, 0]).astype(jnp.int32)
    if scene.has_perturb:
        ns = _perturb_normal(scene, mat, uv, t0, t1, t2, e1, e2, ns, ng)
    emitter = jnp.round(emf[:, 0]).astype(jnp.int32)
    out = {
        "p": p,
        "ng": ng,
        "ns": ns,
        "uv": uv,
        "mat": mat,
        "emitter": emitter,
        "wi_world": -d,
    }
    if scene.tex_mips is not None and scene.tri_uv_density is not None:
        # texel footprint for trilinear mip selection: pixel width at
        # distance t (camera factor baked into tri_uv_density at load)
        dens = fetch_packed([scene.tri_uv_density[:, None]], its.prim)[0]
        out["footprint"] = its.t * dens[:, 0]
    if dd_dx is not None and scene.tex_mips is not None:
        # pixel footprint on the hit plane: p(s) = o + t(s) d(s) with the
        # plane constraint gives dp = t (dd - d (dd.ng)/(d.ng))
        dng = m.dot(d, ng)
        safe = jnp.abs(dng) > 1e-7
        inv_dng = jnp.where(safe, 1.0 / jnp.where(safe, dng, 1.0), 0.0)

        def duv_of(dd):
            dp = its.t[:, None] * (
                dd - d * (m.dot(dd, ng) * inv_dng)[:, None])
            # barycentric derivatives via the edge Gram system, then map
            # through the uv edges (computePartials' dpdu/dpdv inverted)
            a11 = m.dot(e1, e1)
            a12 = m.dot(e1, e2)
            a22 = m.dot(e2, e2)
            det_g = jnp.maximum(a11 * a22 - a12 * a12, 1e-20)
            r1 = m.dot(dp, e1)
            r2 = m.dot(dp, e2)
            db1 = (a22 * r1 - a12 * r2) / det_g
            db2 = (a11 * r2 - a12 * r1) / det_g
            return db1[:, None] * (t1 - t0) + db2[:, None] * (t2 - t0)

        out["duvdx"] = duv_of(dd_dx)
        out["duvdy"] = duv_of(dd_dy)
    # procedural per-interaction colors (compiled only when present):
    if scene.has_vtx_colors:
        # vertexcolors.cpp / curvature.cpp (colors baked at load time)
        (c0, c1, c2) = fetch_packed(
            [scene.vertex_colors[vi[:, 0]],
             scene.vertex_colors[vi[:, 1]],
             scene.vertex_colors[vi[:, 2]]], its.prim)
        out["vcolor"] = c0 * w0 + c1 * b1[:, None] + c2 * b2[:, None]
    if scene.has_wireframe:
        # wireframe.cpp: edge distance approximated in barycentric space
        wp = scene.wire_params
        edge = jnp.minimum(jnp.minimum(b1, b2), 1.0 - b1 - b2)
        t_edge = jnp.clip(edge / jnp.maximum(wp[6], 1e-6), 0.0, 1.0)
        out["wirecolor"] = wp[3:6][None, :] + (wp[0:3] - wp[3:6])[None, :] \
            * t_edge[:, None]
    return out
