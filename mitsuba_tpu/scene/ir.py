"""Flattened scene IR: triangle soup + SoA material/emitter tables.

This replaces the reference's object graph — Scene owning Shape/BSDF/Emitter
plugin instances (include/mitsuba/render/scene.h:49, shape.h:178,
bsdf.h:215, emitter.h:443) — with dense arrays + integer type codes, which
is the batched representation: every per-ray query becomes a gather from
these tables, and the whole scene is a differentiable pytree (gradients flow
to vertices, albedos, roughness, emitted radiance automatically).

Conventions:
  * float32 everywhere, trailing dim 3 for colors/vectors (RGB mode,
    SPECTRUM_SAMPLES=3 like the reference build config-linux-gcc.py:7).
  * `tri_material[t]` indexes the material table; `tri_emitter[t]` is -1 or
    an index into the area-emitter table.
  * Static (non-traced) metadata lives in fields marked pytree_node=False.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import math as m

# ---------------------------------------------------------------------------
# BSDF type codes (analog of the reference's plugin names; one family per
# code, evaluated SIMD-style with masks — see models/bsdf.py)
# ---------------------------------------------------------------------------
BSDF_NULL = 0
BSDF_DIFFUSE = 1
BSDF_CONDUCTOR = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_DIELECTRIC = 4
BSDF_ROUGH_DIELECTRIC = 5
BSDF_PLASTIC = 6
BSDF_ROUGH_PLASTIC = 7
BSDF_PHONG = 8
BSDF_THIN_DIELECTRIC = 9
BSDF_ROUGH_DIFFUSE = 10
BSDF_WARD = 11
BSDF_MASK = 12
BSDF_TWO_SIDED = 13
BSDF_BLEND = 14
BSDF_DIFFUSE_TRANSMITTER = 15
BSDF_COATING = 16
BSDF_HK = 17
BSDF_IRAWAN = 18

# Microfacet distribution sub-codes (microfacet.h EBeckmann/EGGX/EPhong)
MICROFACET_BECKMANN = 0
MICROFACET_GGX = 1

# Texture slot meaning: texture id < 0 means "constant color from table",
# except the procedural per-interaction ids below.
TEX_NONE = -1
TEX_VERTEXCOLOR = -2   # barycentric per-vertex colors (vertexcolors.cpp;
                       # also curvature.cpp via load-time color baking)
TEX_WIREFRAME = -3     # edge highlight from barycentrics (wireframe.cpp)


@struct.dataclass
class Materials:
    """SoA BSDF table (replaces per-shape BSDF plugin instances).

    Layout:
      type:        (M,)  int32 BSDF_* code
      reflectance: (M,3) diffuse albedo / specular reflectance tint
      specular:    (M,3) secondary color (e.g. plastic specular, blend B)
      eta:         (M,3) IOR (conductor: spectral; dielectric: [:,0])
      k:           (M,3) conductor absorption
      alpha:       (M,2) roughness (alpha_u, alpha_v)
      extra:       (M,4) family-specific scalars (phong exponent, blend
                   weight, opacity, microfacet distribution code, ...)
      tex_reflectance: (M,) int32 texture id for reflectance or TEX_NONE
      nested:      (M,2) int32 child material ids (twosided/blend/mask)
      tex_perturb: (M,) int32 normal/bump map texture id or TEX_NONE
      perturb_kind:(M,) int32 0=none, 1=normalmap (tangent-space RGB),
                   2=bumpmap (height; src/bsdfs/{normalmap,bumpmap}.cpp)
    """

    type: jax.Array
    reflectance: jax.Array
    specular: jax.Array
    eta: jax.Array
    k: jax.Array
    alpha: jax.Array
    extra: jax.Array
    tex_reflectance: jax.Array
    nested: jax.Array
    tex_perturb: jax.Array
    perturb_kind: jax.Array

    @staticmethod
    def stack(records: list[dict]) -> "Materials":
        n = max(len(records), 1)

        def col(key, width, default):
            out = np.tile(np.asarray(default, np.float32), (n, 1))
            for i, r in enumerate(records):
                if key in r:
                    out[i] = np.broadcast_to(np.asarray(r[key], np.float32), (width,))
            return jnp.asarray(out)

        types = np.full((n,), BSDF_DIFFUSE, np.int32)
        texr = np.full((n,), TEX_NONE, np.int32)
        nested = np.full((n, 2), -1, np.int32)
        texp = np.full((n,), TEX_NONE, np.int32)
        pkind = np.zeros((n,), np.int32)
        for i, r in enumerate(records):
            types[i] = r.get("type", BSDF_DIFFUSE)
            texr[i] = r.get("tex_reflectance", TEX_NONE)
            nested[i] = r.get("nested", (-1, -1))
            texp[i] = r.get("tex_perturb", TEX_NONE)
            pkind[i] = r.get("perturb_kind", 0)
        return Materials(
            type=jnp.asarray(types),
            reflectance=col("reflectance", 3, [0.5, 0.5, 0.5]),
            specular=col("specular", 3, [1.0, 1.0, 1.0]),
            eta=col("eta", 3, [1.5, 1.5, 1.5]),
            k=col("k", 3, [0.0, 0.0, 0.0]),
            alpha=col("alpha", 2, [0.1, 0.1]),
            extra=col("extra", 4, [0.0, 0.0, 0.0, 0.0]),
            tex_reflectance=jnp.asarray(texr),
            nested=jnp.asarray(nested),
            tex_perturb=jnp.asarray(texp),
            perturb_kind=jnp.asarray(pkind),
        )


@struct.dataclass
class AreaEmitters:
    """Area emitter table + triangle sampling distribution.

    Replaces AreaLuminaire + Scene's emitter discrete distribution
    (scene.cpp:131-150, scene.h:482 sampleEmitterDirect). Triangles are
    importance-sampled by area x luminance via a CDF table.

    radiance:   (E,3)   emitted radiance per emitter
    tri_index:  (ET,)   triangle id of each emissive triangle
    tri_emitter:(ET,)   emitter id of each emissive triangle
    tri_cdf:    (ET,)   inclusive CDF over emissive triangles
    tri_pdf:    (ET,)   probability of selecting each emissive triangle
    """

    radiance: jax.Array
    tri_index: jax.Array
    tri_emitter: jax.Array
    tri_cdf: jax.Array
    tri_pdf: jax.Array
    select_pdf_full: jax.Array  # (T,) selection prob per scene triangle (0 if dark)


@struct.dataclass
class DeltaEmitters:
    """Delta (position/direction) emitter table: point, spot, directional
    (src/emitters/{point,spot,directional}.cpp). Only reachable through
    NEE — BSDF samples can never hit a delta light, so their MIS weight is
    always 1 (the EDeltaPosition/EDeltaDirection semantics, emitter.h).

    kind:      (K,) int32  0=point, 1=spot, 2=directional
    position:  (K,3)  light position (unused for directional)
    direction: (K,3)  emission direction (spot/directional)
    intensity: (K,3)  point/spot: radiant intensity I [W/sr];
                      directional: irradiance E on a perp. surface
    cutoff:    (K,2)  spot: (cos(cutoffAngle), cos(beamWidth))
    """

    kind: jax.Array
    position: jax.Array
    direction: jax.Array
    intensity: jax.Array
    cutoff: jax.Array


DELTA_POINT = 0
DELTA_SPOT = 1
DELTA_DIRECTIONAL = 2
DELTA_COLLIMATED = 3   # zero-divergence beam (src/emitters/collimated.cpp);
                       # reachable only through light-path sampling


def build_delta_emitters(records: list) -> DeltaEmitters:
    """records: dicts with kind/position/direction/intensity/cutoff_deg."""
    k = len(records)
    kind = np.zeros((k,), np.int32)
    pos = np.zeros((k, 3), np.float32)
    dirn = np.tile(np.asarray([0, 0, 1], np.float32), (k, 1))
    inten = np.ones((k, 3), np.float32)
    cut = np.tile(np.asarray([np.cos(np.deg2rad(20.0)),
                              np.cos(np.deg2rad(15.0))], np.float32), (k, 1))
    for i, r in enumerate(records):
        kind[i] = r.get("kind", DELTA_POINT)
        pos[i] = np.asarray(r.get("position", (0, 0, 0)), np.float32)
        d = np.asarray(r.get("direction", (0, 0, 1)), np.float32)
        dirn[i] = d / max(np.linalg.norm(d), 1e-12)
        inten[i] = np.broadcast_to(np.asarray(r.get("intensity", 1.0), np.float32), (3,))
        if "cutoff_deg" in r or "beam_deg" in r:
            co = float(r.get("cutoff_deg", 20.0))
            bw = float(r.get("beam_deg", co * 0.75))
            cut[i] = (np.cos(np.deg2rad(co)), np.cos(np.deg2rad(bw)))
    return DeltaEmitters(
        kind=jnp.asarray(kind), position=jnp.asarray(pos),
        direction=jnp.asarray(dirn), intensity=jnp.asarray(inten),
        cutoff=jnp.asarray(cut),
    )


@struct.dataclass
class Scene:
    """The whole flattened scene. A pure pytree: differentiable leaves are
    vertices, material params, and emitter radiance."""

    # Geometry
    vertices: jax.Array        # (V,3)
    indices: jax.Array         # (T,3) int32
    normals: jax.Array         # (V,3) shading normals
    uvs: jax.Array             # (V,2)
    tri_material: jax.Array    # (T,) int32
    tri_emitter: jax.Array     # (T,) int32, -1 if not emissive

    materials: Materials
    emitters: AreaEmitters

    # Environment: constant radiance for now (envmap comes via textures)
    env_radiance: jax.Array    # (3,)

    # Texture stack: all bitmap textures padded to one (K, TH, TW, 3) array
    # (replaces the bitmap/checkerboard/... texture plugins, src/textures/).
    # Differentiable: gradients w.r.t. texels flow through bilinear lookup.
    textures: jax.Array        # (K, TH, TW, 3)
    tex_size: jax.Array        # (K, 2) int32 actual (h, w) of each texture
    tex_transform: jax.Array   # (K, 4) uv scale_u, scale_v, offset_u, offset_v
    tex_nearest: jax.Array     # (K,) int32 1 = nearest (procedural grids)
    # Mip strip (mipmap.h trilinear analog): levels 1..L box-downsampled
    # and packed side by side into one (K, TH//2, TW, 3) canvas — level l
    # at x offset TW*(1 - 2^(1-l)) occupying (TH>>l, TW>>l). None = none.
    tex_mips: Any = None
    # (T,) per-triangle texel density sqrt(uv_area / world_area) — the
    # LOD driver (footprint * density * resolution = texels per pixel)
    tri_uv_density: Any = None

    # Acceleration structure (None = brute force; scene/bvh.py)
    bvh: Any = None

    # Environment map emitter (None = constant env_radiance; scene/envmap.py)
    envmap: Any = None

    # Scene-global participating medium (None = vacuum; models/medium.py)
    medium: Any = None

    # Irawan woven-cloth tables (None unless BSDF_IRAWAN materials exist;
    # models/cloth.py ClothTables)
    cloth: Any = None

    # Delta emitters (None = none; point/spot/directional)
    delta_emitters: Any = None

    # Occupancy-map approximate visibility (None = exact; ops/occupancy.py)
    occupancy: Any = None

    # (T,) bool: False for index-matched null-BSDF interface triangles
    # (medium boundaries) which must not block shadow rays
    # (scene.cpp attenuated shadow rays / mask.cpp transparency analog)
    tri_opaque: Any = None

    # (V,3) per-vertex colors for TEX_VERTEXCOLOR materials (None = absent)
    vertex_colors: Any = None

    # (T,3) int32 face adjacency: neighbor face across edge slot k =
    # (i_k, i_{k+1}), -1 for open (boundary) edges. Consumed by the
    # warped-area reparameterization's silhouette-edge boundary test
    # (integrators/reparam.py); cheap to build, so always present.
    face_adj: Any = None
    # (E,5) int32 unique-edge table [v0, v1, face, nbr_face|-1, opp_vert]:
    # one row per undirected mesh edge (shared edges deduped to the
    # lower-id face). opp_vert = the owning face's third vertex, used to
    # orient the silhouette normal. Consumed by the edge-sampling
    # boundary-gradient estimator (integrators/boundary.py).
    edge_table: Any = None
    # (7,) wireframe params [interior rgb, edge rgb, bary line width]
    wire_params: Any = None

    # Static metadata
    # Power-weighted (area, env, delta) emitter-group selection probs
    # (models/emitter.compute_group_probs; empty = uniform over present
    # groups). Static so pdf math stays trace-free.
    group_probs: tuple = struct.field(pytree_node=False, default=())
    num_triangles: int = struct.field(pytree_node=False, default=0)
    bsdf_families: tuple = struct.field(pytree_node=False, default=())
    has_env: bool = struct.field(pytree_node=False, default=False)
    has_area: bool = struct.field(pytree_node=False, default=True)
    # any material carries a normal/bump map (gates the perturbation code
    # in ops/intersect.surface_interaction so plain scenes compile none of it)
    has_perturb: bool = struct.field(pytree_node=False, default=False)
    # any null-BSDF triangles present (gates the shadow-transparency
    # masking so ordinary scenes compile none of it)
    has_null: bool = struct.field(pytree_node=False, default=False)
    # procedural per-interaction textures present (gate their compile)
    has_vtx_colors: bool = struct.field(pytree_node=False, default=False)
    has_wireframe: bool = struct.field(pytree_node=False, default=False)
    aux: Any = struct.field(pytree_node=False, default=None)

    # ------------------------------------------------------------------
    # Derived geometry (computed in-trace so vertex grads flow)
    # ------------------------------------------------------------------
    def tri_vertices(self):
        """Returns (p0, e1, e2): (T,3) base vertex and edge vectors."""
        v = self.vertices
        i = self.indices
        p0 = v[i[:, 0]]
        e1 = v[i[:, 1]] - p0
        e2 = v[i[:, 2]] - p0
        return p0, e1, e2

    def tri_normal_area(self):
        """Geometric normals (T,3) and areas (T,) (trimesh.cpp analog)."""
        _, e1, e2 = self.tri_vertices()
        ng = jnp.cross(e1, e2)
        two_a = m.length(ng)
        return ng / two_a[:, None], 0.5 * two_a

    def shading_normal(self, prim, b1, b2):
        """Interpolated shading normal at barycentric (b1,b2) of tri `prim`."""
        i = self.indices[prim]
        n0 = self.normals[i[..., 0]]
        n1 = self.normals[i[..., 1]]
        n2 = self.normals[i[..., 2]]
        w = (1.0 - b1 - b2)[..., None]
        return m.normalize(n0 * w + n1 * b1[..., None] + n2 * b2[..., None])

    def uv_at(self, prim, b1, b2):
        i = self.indices[prim]
        t0 = self.uvs[i[..., 0]]
        t1 = self.uvs[i[..., 1]]
        t2 = self.uvs[i[..., 2]]
        w = (1.0 - b1 - b2)[..., None]
        return t0 * w + t1 * b1[..., None] + t2 * b2[..., None]


def build_scene(
    vertices: np.ndarray,
    indices: np.ndarray,
    tri_material: np.ndarray,
    materials: list[dict],
    tri_radiance: Optional[dict] = None,
    normals: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
    env_radiance=None,
    textures: Optional[list] = None,
    vertex_colors: Optional[np.ndarray] = None,
    wire_params=None,
    lod_scale: Optional[float] = None,
) -> Scene:
    """Host-side scene assembly (the analog of SceneHandler + Scene::initialize,
    scenehandler.cpp:712, scene.cpp:340 — minus the kd-tree, built separately).

    tri_radiance: {triangle_id: (3,) radiance} marking area emitters.
    """
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    T = indices.shape[0]
    tri_material = np.asarray(tri_material, np.int32)

    if normals is None:
        # Area-weighted vertex normals; faceted meshes just repeat vertices.
        p0 = vertices[indices[:, 0]]
        fn = np.cross(vertices[indices[:, 1]] - p0, vertices[indices[:, 2]] - p0)
        normals = np.zeros_like(vertices)
        for k in range(3):
            np.add.at(normals, indices[:, k], fn)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(lens, 1e-20)
    if uvs is None:
        uvs = np.zeros((vertices.shape[0], 2), np.float32)

    tri_emitter = np.full((T,), -1, np.int32)
    em_radiance, em_tris, em_emitter = [], [], []
    if tri_radiance:
        # Group contiguous identical radiances into one emitter each.
        rad_key = {}
        for t, rad in sorted(tri_radiance.items()):
            key = tuple(np.asarray(rad, np.float32).reshape(3))
            if key not in rad_key:
                rad_key[key] = len(em_radiance)
                em_radiance.append(np.asarray(key, np.float32))
            e = rad_key[key]
            tri_emitter[t] = e
            em_tris.append(t)
            em_emitter.append(e)

    if em_tris:
        em_tris_np = np.asarray(em_tris, np.int32)
        em_emitter_np = np.asarray(em_emitter, np.int32)
        em_rad_np = np.stack(em_radiance)
        p0 = vertices[indices[em_tris_np, 0]]
        e1 = vertices[indices[em_tris_np, 1]] - p0
        e2 = vertices[indices[em_tris_np, 2]] - p0
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        # Weight by area x luminance (scene.cpp's emitter importance analog).
        lum = em_rad_np[em_emitter_np] @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        w = areas * np.maximum(lum, 1e-12)
        pdf = w / w.sum()
        cdf = np.cumsum(pdf).astype(np.float32)
        cdf[-1] = 1.0
        select_full = np.zeros((T,), np.float32)
        select_full[em_tris_np] = pdf
        emitters = AreaEmitters(
            radiance=jnp.asarray(em_rad_np),
            tri_index=jnp.asarray(em_tris_np),
            tri_emitter=jnp.asarray(em_emitter_np),
            tri_cdf=jnp.asarray(cdf),
            tri_pdf=jnp.asarray(pdf.astype(np.float32)),
            select_pdf_full=jnp.asarray(select_full),
        )
    else:
        emitters = AreaEmitters(
            radiance=jnp.zeros((1, 3), jnp.float32),
            tri_index=jnp.zeros((1,), jnp.int32),
            tri_emitter=jnp.zeros((1,), jnp.int32),
            tri_cdf=jnp.ones((1,), jnp.float32),
            tri_pdf=jnp.ones((1,), jnp.float32),
            select_pdf_full=jnp.zeros((T,), jnp.float32),
        )

    mats = Materials.stack(materials)
    families = tuple(sorted({int(r.get("type", BSDF_DIFFUSE)) for r in materials}))
    has_env = env_radiance is not None
    env = jnp.asarray(
        env_radiance if has_env else [0.0, 0.0, 0.0], jnp.float32
    )

    # Texture stack (padded to common size).
    if textures:
        th = max(int(t["data"].shape[0]) for t in textures)
        tw = max(int(t["data"].shape[1]) for t in textures)
        k = len(textures)
        stack = np.zeros((k, th, tw, 3), np.float32)
        sizes = np.zeros((k, 2), np.int32)
        xforms = np.zeros((k, 4), np.float32)
        nearest = np.zeros((k,), np.int32)
        for i, t in enumerate(textures):
            d = np.asarray(t["data"], np.float32)
            if d.ndim == 2:
                d = np.repeat(d[..., None], 3, axis=-1)
            stack[i, : d.shape[0], : d.shape[1]] = d[..., :3]
            sizes[i] = (d.shape[0], d.shape[1])
            xforms[i] = np.asarray(t.get("transform", (1.0, 1.0, 0.0, 0.0)), np.float32)
            nearest[i] = 1 if t.get("nearest", False) else 0
        tex_stack = jnp.asarray(stack)
        tex_size = jnp.asarray(sizes)
        tex_transform = jnp.asarray(xforms)
        tex_nearest = jnp.asarray(nearest)
        if lod_scale is not None and min(th, tw) >= 4:
            # mip strip: per-texture box-downsampled chains packed into a
            # (K, th//2, tw) canvas (level l >= 1 at x = tw*(1-2^(1-l)))
            strip = np.zeros((k, th // 2, tw, 3), np.float32)
            for i, t in enumerate(textures):
                d = np.asarray(t["data"], np.float32)
                if d.ndim == 2:
                    d = np.repeat(d[..., None], 3, axis=-1)
                d = d[..., :3]
                lvl = d
                x_off = 0
                while min(lvl.shape[0], lvl.shape[1]) >= 2:
                    hh, ww = lvl.shape[0] // 2, lvl.shape[1] // 2
                    lvl = lvl[: hh * 2, : ww * 2].reshape(
                        hh, 2, ww, 2, 3).mean((1, 3))
                    if x_off + ww > tw or hh > th // 2:
                        break
                    strip[i, :hh, x_off:x_off + ww] = lvl
                    x_off += ww
            tex_mips = jnp.asarray(strip)
        else:
            tex_mips = None
    else:
        tex_stack = jnp.zeros((1, 1, 1, 3), jnp.float32)
        tex_size = jnp.ones((1, 2), jnp.int32)
        tex_transform = jnp.asarray([[1.0, 1.0, 0.0, 0.0]], jnp.float32)
        tex_nearest = jnp.zeros((1,), jnp.int32)
        tex_mips = None

    uv_density = None
    if lod_scale is not None:
        uvs_np = np.asarray(uvs, np.float32)
        p0w = vertices[indices[:, 0]]
        e1w = vertices[indices[:, 1]] - p0w
        e2w = vertices[indices[:, 2]] - p0w
        area_w = 0.5 * np.linalg.norm(np.cross(e1w, e2w), axis=1)
        t0u = uvs_np[indices[:, 0]]
        e1u = uvs_np[indices[:, 1]] - t0u
        e2u = uvs_np[indices[:, 2]] - t0u
        area_u = 0.5 * np.abs(e1u[:, 0] * e2u[:, 1] - e1u[:, 1] * e2u[:, 0])
        uv_density = (np.sqrt(area_u / np.maximum(area_w, 1e-20))
                      * np.float32(lod_scale)).astype(np.float32)

    mat_types = np.asarray(
        [int(r.get("type", BSDF_DIFFUSE)) for r in materials] or [BSDF_DIFFUSE],
        np.int32)
    tri_opaque_np = mat_types[np.clip(tri_material, 0, len(mat_types) - 1)] \
        != BSDF_NULL

    # face adjacency across shared (undirected) edges, -1 = open edge:
    # edge slot k of face f spans (indices[f,k], indices[f,(k+1)%3])
    edge_v = np.stack([indices[:, [0, 1]], indices[:, [1, 2]],
                       indices[:, [2, 0]]], axis=1).reshape(-1, 2)
    ekey = np.sort(edge_v, axis=1)
    order = np.lexsort((ekey[:, 1], ekey[:, 0]))
    sk = ekey[order]
    same = np.all(sk[1:] == sk[:-1], axis=1)
    face_adj_flat = np.full((3 * T,), -1, np.int32)
    a = order[:-1][same]
    b = order[1:][same]
    face_adj_flat[a] = b // 3
    face_adj_flat[b] = a // 3

    # unique-edge table for the boundary-gradient estimator: keep a
    # slot-edge iff it is open or its face id is the lower of the pair
    slot_face = np.repeat(np.arange(T, dtype=np.int32), 3)
    keep = (face_adj_flat < 0) | (slot_face < face_adj_flat)
    slot_in_face = np.tile(np.arange(3, dtype=np.int32), T)
    opp_slot = (slot_in_face + 2) % 3    # vertex not on edge (k, k+1)
    opp_vert = indices[slot_face, opp_slot]
    edge_table = np.stack(
        [edge_v[keep, 0], edge_v[keep, 1], slot_face[keep],
         face_adj_flat[keep], opp_vert[keep]], axis=1).astype(np.int32)

    return Scene(
        vertices=jnp.asarray(vertices),
        indices=jnp.asarray(indices),
        face_adj=jnp.asarray(face_adj_flat.reshape(T, 3)),
        edge_table=jnp.asarray(edge_table),
        normals=jnp.asarray(normals.astype(np.float32)),
        uvs=jnp.asarray(uvs.astype(np.float32)),
        tri_material=jnp.asarray(tri_material),
        tri_emitter=jnp.asarray(tri_emitter),
        tri_opaque=jnp.asarray(tri_opaque_np),
        tri_uv_density=(None if uv_density is None
                        else jnp.asarray(uv_density)),
        has_null=bool((~tri_opaque_np).any()),
        vertex_colors=(None if vertex_colors is None
                       else jnp.asarray(vertex_colors, jnp.float32)),
        wire_params=(None if wire_params is None
                     else jnp.asarray(wire_params, jnp.float32)),
        has_vtx_colors=vertex_colors is not None,
        has_wireframe=wire_params is not None,
        materials=mats,
        emitters=emitters,
        env_radiance=env,
        textures=tex_stack,
        tex_mips=tex_mips,
        tex_size=tex_size,
        tex_transform=tex_transform,
        tex_nearest=tex_nearest,
        num_triangles=int(T),
        bsdf_families=families,
        has_env=bool(has_env),
        has_area=bool(em_tris),
        has_perturb=any(int(r.get("perturb_kind", 0)) != 0 for r in materials),
    )
