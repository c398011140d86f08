"""Triangle mesh loaders: OBJ, PLY (ascii + binary_little_endian).

The framework's analog of the reference shape plugins
src/shapes/obj.cpp (wavefront OBJ with per-face v/vt/vn indexing and
polygon fan triangulation) and src/shapes/ply.cpp. Loads into flat numpy
arrays ready for scene/ir.build_scene — uniquifying (v, vt, vn) index
triples exactly like obj.cpp's vertex cache.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


class MeshData:
    def __init__(self, vertices, indices, normals=None, uvs=None, face_groups=None,
                 colors=None):
        self.vertices = np.asarray(vertices, np.float32)   # (V,3)
        self.indices = np.asarray(indices, np.int32)       # (T,3)
        self.normals = None if normals is None else np.asarray(normals, np.float32)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float32)
        # face_groups[t] = material/group name per triangle (usemtl tracking)
        self.face_groups = face_groups
        # per-vertex RGB colors (PLY red/green/blue; vertexcolors.cpp)
        self.colors = None if colors is None else np.asarray(colors, np.float32)


def load_obj(path) -> MeshData:
    """Wavefront OBJ (obj.cpp parity: v/vt/vn, negative indices, polygon
    fans, usemtl per-face group names).

    Tries the native C++ parser first (native/mesh_loader.cpp; it does not
    track usemtl groups, so files needing per-face materials parse here)."""
    try:
        from .. import native

        nat = native.parse_obj(str(path))
    except Exception:
        nat = None
    if nat is not None and nat["indices"].size:
        return MeshData(
            nat["vertices"], nat["indices"],
            normals=nat["normals"], uvs=nat["uvs"],
        )
    positions: list = []
    texcoords: list = []
    normals: list = []
    tri_corners: list = []     # list of (vi, ti, ni) triples
    tri_groups: list = []
    current_mtl = ""

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "usemtl":
                current_mtl = parts[1] if len(parts) > 1 else ""
            elif tag == "f":
                corners = []
                for spec in parts[1:]:
                    toks = spec.split("/")
                    vi = int(toks[0])
                    ti = int(toks[1]) if len(toks) > 1 and toks[1] else 0
                    ni = int(toks[2]) if len(toks) > 2 and toks[2] else 0
                    # negative indices are relative (obj.cpp fetch_*)
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti else -1)
                    ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri_corners.append((corners[0], corners[k], corners[k + 1]))
                    tri_groups.append(current_mtl)

    positions = np.asarray(positions, np.float32)
    texcoords = np.asarray(texcoords, np.float32) if texcoords else None
    normals_np = np.asarray(normals, np.float32) if normals else None

    # uniquify corner triples -> vertex buffer (obj.cpp vertex cache)
    cache: dict = {}
    verts, uvs_out, nrm_out, tris = [], [], [], []
    for tri in tri_corners:
        idx3 = []
        for corner in tri:
            if corner not in cache:
                cache[corner] = len(verts)
                vi, ti, ni = corner
                verts.append(positions[vi])
                uvs_out.append(texcoords[ti] if (texcoords is not None and ti >= 0)
                               else np.zeros(2, np.float32))
                nrm_out.append(normals_np[ni] if (normals_np is not None and ni >= 0)
                               else np.zeros(3, np.float32))
            idx3.append(cache[corner])
        tris.append(idx3)

    nrm_arr = np.asarray(nrm_out, np.float32)
    has_normals = normals_np is not None and np.abs(nrm_arr).sum() > 0
    return MeshData(
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        normals=nrm_arr if has_normals else None,
        uvs=np.asarray(uvs_out, np.float32) if texcoords is not None else None,
        face_groups=tri_groups,
    )


def load_ply(path) -> MeshData:
    """PLY loader: ascii / binary_little_endian, vertex x/y/z[/nx/ny/nz]
    [/u/v | s/t], face vertex_indices (ply.cpp parity for common files)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(type, name)...])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    _NP = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
           "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
           "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
           "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4"}

    verts = norms = uvs = colors = None
    faces: list = []
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                pnames = [p[1] for p in props]
                arr = np.asarray(
                    tokens[pos:pos + count * len(props)], np.float64
                ).reshape(count, len(props))
                pos += count * len(props)
                verts, norms, uvs, colors = _extract_vertex_props(arr, pnames)
            elif name == "face":
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    idx = [int(tokens[pos + j]) for j in range(k)]
                    pos += k
                    for j in range(1, k - 1):
                        faces.append([idx[0], idx[j], idx[j + 1]])
            else:
                # skip unknown ascii element conservatively
                per = len(props)
                pos += count * per
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[1], "<" + _NP[p[0]]) for p in props])
                arr_s = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                pnames = [p[1] for p in props]
                arr = np.stack([arr_s[pn].astype(np.float64) for pn in pnames], -1)
                verts, norms, uvs, colors = _extract_vertex_props(arr, pnames)
            elif name == "face":
                # assume a single list property (vertex_indices)
                lp = props[0]
                cnt_dt = np.dtype("<" + _NP[lp[1]])
                idx_dt = np.dtype("<" + _NP[lp[2]])
                for _ in range(count):
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(body, idx_dt, k, off).astype(np.int64)
                    off += idx_dt.itemsize * k
                    for j in range(1, k - 1):
                        faces.append([idx[0], idx[j], idx[j + 1]])
            else:
                fixed = np.dtype([(p[1], "<" + _NP[p[0]]) for p in props if p[0] != "list"])
                off += fixed.itemsize * count
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    return MeshData(verts, np.asarray(faces, np.int32), normals=norms, uvs=uvs,
                    colors=colors)


def _extract_vertex_props(arr, pnames):
    def cols(names):
        if all(n in pnames for n in names):
            return arr[:, [pnames.index(n) for n in names]].astype(np.float32)
        return None

    verts = cols(["x", "y", "z"])
    norms = cols(["nx", "ny", "nz"])
    uvs = cols(["u", "v"]) if cols(["u", "v"]) is not None else cols(["s", "t"])
    colors = cols(["red", "green", "blue"])
    if colors is None:
        colors = cols(["r", "g", "b"])
    if colors is not None and colors.max() > 1.0:
        colors = colors / 255.0  # uchar-encoded (ply.cpp sRGB bytes)
    return verts, norms, uvs, colors


def save_obj(path, vertices, indices):
    """Minimal OBJ writer (for tests / interchange)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(indices):
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
