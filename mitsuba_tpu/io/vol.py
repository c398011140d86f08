"""Mitsuba .vol gridvolume binary format (read/write).

Format per src/volume/gridvolume.cpp (fileToVolume header parse):
  bytes 0-2  'VOL'
  byte  3    version (3)
  int32      encoding: 1 = float32 (the only one supported here; the
             reference also has float16=2, uint8=3, quantized dirs=4)
  int32 x 3  resolution (xres, yres, zres)
  int32      channels (1 or 3)
  float32x6  bounding box (xmin ymin zmin xmax ymax zmax)
  data       xres*yres*zres*channels float32, x fastest ("zyx" C-order
             with shape (zres, yres, xres, channels))
"""
from __future__ import annotations

import struct

import numpy as np


def read_vol(path):
    """Returns (data (Z,Y,X) or (Z,Y,X,3) float32, box_min (3,), box_max (3,))."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] != b"VOL":
        raise ValueError(f"{path}: not a Mitsuba VOL file")
    version = raw[3]
    if version != 3:
        raise ValueError(f"{path}: unsupported VOL version {version}")
    enc, xres, yres, zres, ch = struct.unpack_from("<5i", raw, 4)
    if enc != 1:
        raise ValueError(f"{path}: only float32 encoding supported, got {enc}")
    if ch not in (1, 3):
        raise ValueError(f"{path}: unsupported channel count {ch}")
    box = struct.unpack_from("<6f", raw, 24)
    n = xres * yres * zres * ch
    data = np.frombuffer(raw, np.float32, count=n, offset=48)
    data = data.reshape(zres, yres, xres, ch)
    if ch == 1:
        data = data[..., 0]
    return (np.ascontiguousarray(data),
            np.asarray(box[:3], np.float32), np.asarray(box[3:], np.float32))


def write_vol(path, data, box_min=(0, 0, 0), box_max=(1, 1, 1)):
    """data: (Z,Y,X) or (Z,Y,X,3) float32."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        ch = 1
        zres, yres, xres = data.shape
    elif data.ndim == 4 and data.shape[-1] == 3:
        ch = 3
        zres, yres, xres = data.shape[:3]
    else:
        raise ValueError(f"bad gridvolume shape {data.shape}")
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", 1, xres, yres, zres, ch))
        f.write(struct.pack("<6f", *np.asarray(box_min, np.float32),
                            *np.asarray(box_max, np.float32)))
        f.write(data.tobytes())


def read_hgrid(dict_path, prefix, postfix=".vol"):
    """Hierarchical grid dictionary (src/volume/hgridvolume.cpp
    loadDictionary): little-endian [6f world aabb][3i cell res] then
    (3i block coords)* until EOF; block (x,y,z) lives in
    '{prefix}{x:03d}_{y:03d}_{z:03d}{postfix}' as a regular gridvolume.

    Returns (block_table (BZ,BY,BX) int32, -1 = empty cell,
    block_data (NB, bz, by, bx) float32, box_min, box_max). All blocks
    must share one resolution (the device layout stacks them into a single
    gatherable array; mixed-resolution dictionaries are rejected)."""
    import os

    with open(dict_path, "rb") as f:
        raw = f.read()
    box = struct.unpack_from("<6f", raw, 0)
    bx, by, bz = struct.unpack_from("<3i", raw, 24)
    table = np.full((bz, by, bx), -1, np.int32)
    blocks = []
    base = os.path.dirname(str(dict_path))
    off = 36
    shape = None
    while off + 12 <= len(raw):
        cx, cy, cz = struct.unpack_from("<3i", raw, off)
        off += 12
        name = f"{prefix}{cx:03d}_{cy:03d}_{cz:03d}{postfix}"
        data, _, _ = read_vol(os.path.join(base, name)
                              if not os.path.isabs(name) else name)
        if data.ndim == 4:
            data = data.mean(-1)
        if shape is None:
            shape = data.shape
        elif data.shape != shape:
            raise ValueError(
                f"hgrid block {name}: resolution {data.shape} != {shape}")
        table[cz, cy, cx] = len(blocks)
        blocks.append(data.astype(np.float32))
    if not blocks:
        raise ValueError(f"{dict_path}: empty hierarchical grid")
    return (table, np.stack(blocks),
            np.asarray(box[:3], np.float32), np.asarray(box[3:], np.float32))


def write_hgrid(dict_path, prefix, block_table, block_data,
                box_min=(0, 0, 0), box_max=(1, 1, 1), postfix=".vol"):
    """Inverse of read_hgrid (testing / dataset conversion)."""
    import os

    block_table = np.asarray(block_table)
    bz, by, bx = block_table.shape
    base = os.path.dirname(str(dict_path))
    ext = (np.asarray(box_max, np.float32)
           - np.asarray(box_min, np.float32))
    with open(dict_path, "wb") as f:
        f.write(struct.pack("<6f", *np.asarray(box_min, np.float32),
                            *np.asarray(box_max, np.float32)))
        f.write(struct.pack("<3i", bx, by, bz))
        for cz in range(bz):
            for cy in range(by):
                for cx in range(bx):
                    bid = block_table[cz, cy, cx]
                    if bid < 0:
                        continue
                    f.write(struct.pack("<3i", cx, cy, cz))
                    cell_min = (np.asarray(box_min, np.float32)
                                + ext * np.asarray([cx / bx, cy / by,
                                                    cz / bz], np.float32))
                    cell_max = (np.asarray(box_min, np.float32)
                                + ext * np.asarray([(cx + 1) / bx,
                                                    (cy + 1) / by,
                                                    (cz + 1) / bz],
                                                   np.float32))
                    write_vol(os.path.join(
                        base, f"{prefix}{cx:03d}_{cy:03d}_{cz:03d}{postfix}"),
                        block_data[bid], cell_min, cell_max)
