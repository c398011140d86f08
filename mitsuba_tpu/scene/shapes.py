"""Analytic shape tessellation: rectangle, cube, sphere, disk, cylinder.

The reference keeps spheres/cylinders analytic (src/shapes/sphere.cpp,
cylinder.cpp); a wavefront wants one homogeneous primitive stream, so
analytic shapes become triangle meshes at load time (resolution-controlled,
with exact vertex normals so shading quality matches the analytic surface).
src/shapes/{rectangle,cube,disk}.cpp are already flat polygons.
"""
from __future__ import annotations

import numpy as np


def rectangle():
    """Unit rectangle on z=0 spanning [-1,1]^2, normal +z (rectangle.cpp)."""
    v = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return v, f, n, uv


def cube():
    """[-1,1]^3 cube, outward normals (cube.cpp)."""
    verts, faces, normals, uvs = [], [], [], []
    axes = [
        ([0, 0, 1], [1, 0, 0], [0, 1, 0]),
        ([0, 0, -1], [0, 1, 0], [1, 0, 0]),
        ([1, 0, 0], [0, 1, 0], [0, 0, 1]),
        ([-1, 0, 0], [0, 0, 1], [0, 1, 0]),
        ([0, 1, 0], [0, 0, 1], [1, 0, 0]),
        ([0, -1, 0], [1, 0, 0], [0, 0, 1]),
    ]
    for nrm, u, v_ in axes:
        nrm, u, v_ = map(np.asarray, (nrm, u, v_))
        base = len(verts)
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            verts.append(nrm + su * u + sv * v_)
            normals.append(nrm)
            uvs.append([(su + 1) / 2, (sv + 1) / 2])
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(normals, np.float32), np.asarray(uvs, np.float32))


def sphere(center=(0, 0, 0), radius=1.0, rings=32, segments=64):
    """UV sphere with exact normals (sphere.cpp analytic -> tessellated)."""
    center = np.asarray(center, np.float32)
    th = np.linspace(0, np.pi, rings + 1)
    ph = np.linspace(0, 2 * np.pi, segments + 1)
    T, Ph = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(T) * np.cos(Ph)
    y = np.sin(T) * np.sin(Ph)
    z = np.cos(T)
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * pts
    normals = pts
    uu = (Ph / (2 * np.pi)).reshape(-1)
    vv = (1.0 - T / np.pi).reshape(-1)
    uvs = np.stack([uu, vv], -1).astype(np.float32)
    faces = []
    W = segments + 1
    for i in range(rings):
        for j in range(segments):
            a = i * W + j
            b = a + W
            if i > 0:
                faces.append([a, b, a + 1])
            if i < rings - 1:
                faces.append([a + 1, b, b + 1])
    return verts, np.asarray(faces, np.int32), normals, uvs


def disk(rings=1, segments=64):
    """Unit disk at z=0, normal +z (disk.cpp)."""
    verts = [[0.0, 0.0, 0.0]]
    uvs = [[0.5, 0.5]]
    for j in range(segments):
        a = 2 * np.pi * j / segments
        verts.append([np.cos(a), np.sin(a), 0.0])
        uvs.append([0.5 + 0.5 * np.cos(a), 0.5 + 0.5 * np.sin(a)])
    faces = [[0, 1 + j, 1 + (j + 1) % segments] for j in range(segments)]
    v = np.asarray(verts, np.float32)
    n = np.tile(np.asarray([[0, 0, 1]], np.float32), (len(verts), 1))
    return v, np.asarray(faces, np.int32), n, np.asarray(uvs, np.float32)


def cylinder(p0=(0, 0, 0), p1=(0, 0, 1), radius=1.0, segments=64):
    """Open cylinder between p0 and p1 (cylinder.cpp — open-ended there too)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    w = axis / max(length, 1e-9)
    # build frame
    a = np.asarray([1.0, 0, 0]) if abs(w[0]) < 0.9 else np.asarray([0, 1.0, 0])
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    v_ = np.cross(w, u)
    verts, normals, uvs, faces = [], [], [], []
    for i in (0, 1):
        for j in range(segments + 1):
            ang = 2 * np.pi * j / segments
            nrm = np.cos(ang) * u + np.sin(ang) * v_
            verts.append((p0 if i == 0 else p1) + radius * nrm)
            normals.append(nrm)
            uvs.append([j / segments, float(i)])
    W = segments + 1
    for j in range(segments):
        a0, a1 = j, j + 1
        b0, b1 = W + j, W + j + 1
        faces += [[a0, b0, a1], [a1, b0, b1]]
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(normals, np.float32), np.asarray(uvs, np.float32))


def heightfield(height: np.ndarray, hscale: float = 1.0):
    """Grid mesh over [-1,1]^2 displaced by `height` (src/shapes/
    heightfield.cpp). height: (H, W) array; z = height * hscale."""
    hh, ww = height.shape
    xs = np.linspace(-1, 1, ww, dtype=np.float32)
    ys = np.linspace(-1, 1, hh, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys)
    verts = np.stack([X, Y, height.astype(np.float32) * hscale], -1).reshape(-1, 3)
    uvs = np.stack([(X + 1) / 2, (Y + 1) / 2], -1).reshape(-1, 2).astype(np.float32)
    faces = []
    for i in range(hh - 1):
        for j in range(ww - 1):
            a = i * ww + j
            b = a + 1
            c = a + ww
            d = c + 1
            faces += [[a, c, b], [b, c, d]]
    faces = np.asarray(faces, np.int32)
    # smooth normals via central differences of the height grid
    gz = np.gradient(height.astype(np.float32) * hscale)
    dzdx = gz[1] / (xs[1] - xs[0])
    dzdy = gz[0] / (ys[1] - ys[0])
    n = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], -1).reshape(-1, 3)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return verts, faces, n.astype(np.float32), uvs


def apply_transform(mat4: np.ndarray, verts, normals=None):
    """Apply a 4x4 to-world transform; normals use the inverse transpose."""
    mat4 = np.asarray(mat4, np.float32)
    v = verts @ mat4[:3, :3].T + mat4[:3, 3]
    n = None
    if normals is not None:
        nmat = np.linalg.inv(mat4[:3, :3]).T
        n = normals @ nmat.T
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    # a reflection flips winding; fix so geometric normals stay consistent
    return v.astype(np.float32), (None if n is None else n.astype(np.float32))


def hair_tubes(strands, radius: float, sides: int = 4):
    """Tessellate hair polylines into triangle tubes — the batched
    replacement for the reference's analytic cylinder kd-tree
    (src/shapes/hair.cpp:109 HairKDTree): curves compile to the same
    triangle soup every other shape uses, so the wavefront intersectors
    need no dedicated primitive. `sides`-gon cross sections with
    parallel-transported frames (no twist); per-vertex normals give
    smooth shading across the tube.

    Returns (verts, faces, normals, uvs) like the other shape builders.
    """
    verts, normals, uvs, faces = [], [], [], []
    base = 0
    for s in strands:
        s = np.asarray(s, np.float32)
        if len(s) < 2:
            continue
        # parallel-transported frames along the strand
        t0 = s[1] - s[0]
        t0 = t0 / max(np.linalg.norm(t0), 1e-9)
        a = np.asarray([1.0, 0, 0]) if abs(t0[0]) < 0.9 \
            else np.asarray([0, 1.0, 0])
        u = np.cross(a, t0)
        u /= max(np.linalg.norm(u), 1e-9)
        rings = []
        prev_t = t0
        for i, p in enumerate(s):
            if 0 < i < len(s) - 1:
                t = s[i + 1] - s[i - 1]
            elif i == 0:
                t = s[1] - s[0]
            else:
                t = s[-1] - s[-2]
            t = t / max(np.linalg.norm(t), 1e-9)
            # rotate u to stay perpendicular (projection transport)
            u = u - t * np.dot(u, t)
            nrm_u = np.linalg.norm(u)
            if nrm_u < 1e-6:
                a = np.asarray([1.0, 0, 0]) if abs(t[0]) < 0.9 \
                    else np.asarray([0, 1.0, 0])
                u = np.cross(a, t)
                nrm_u = np.linalg.norm(u)
            u = u / nrm_u
            v_ = np.cross(t, u)
            ring = []
            for j in range(sides):
                ang = 2 * np.pi * j / sides
                n = np.cos(ang) * u + np.sin(ang) * v_
                verts.append(p + radius * n)
                normals.append(n)
                uvs.append([j / sides, i / max(len(s) - 1, 1)])
                ring.append(base + i * sides + j)
            rings.append(ring)
            prev_t = t
        for i in range(len(s) - 1):
            for j in range(sides):
                a0 = rings[i][j]
                a1 = rings[i][(j + 1) % sides]
                b0 = rings[i + 1][j]
                b1 = rings[i + 1][(j + 1) % sides]
                faces += [[a0, b0, a1], [a1, b0, b1]]
        base += len(s) * sides
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(normals, np.float32), np.asarray(uvs, np.float32))
