"""Image I/O: EXR / PFM / PNG / NPY read+write.

The framework's analog of the reference Bitmap I/O layer
(include/mitsuba/core/bitmap.h:170-261 — PNG/EXR/RGBE/PFM/PPM/...; the
fork's numpy .npy output in src/films/mfilm.cpp:25,347 via embedded cnpy).
No OpenEXR bindings in this environment, so EXR is implemented directly:
uncompressed scanline float32/half — enough for lossless interchange with
the reference's hdrfilm output.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# EXR (minimal: single-part scanline, ZIP or NONE compression, RGB float)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def write_exr(path, img: np.ndarray, half: bool = False,
              metadata: dict | None = None) -> None:
    """Write (H,W,3) float array as scanline EXR (no compression).

    `metadata` maps attribute names to str or float values, embedded as
    EXR header attributes — the reference stamps `renderTime` (and other
    Properties) into the film header the same way
    (src/librender/film.cpp setDestinationFile metadata path, read back
    by data/scripts/rendertime.py:14)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    ptype = _PIXELTYPE_HALF if half else _PIXELTYPE_FLOAT
    psize = 2 if half else 4

    chans = b""
    for c in (b"B", b"G", b"R"):  # alphabetical order required
        chans += c + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chans += b"\x00"

    header = b""
    header += _exr_attr(b"channels", b"chlist", chans)
    for k, v in (metadata or {}).items():
        if isinstance(v, (int, float)):
            header += _exr_attr(k.encode(), b"float",
                                struct.pack("<f", float(v)))
        else:
            header += _exr_attr(k.encode(), b"string", str(v).encode())
    header += _exr_attr(b"compression", b"compression", b"\x00")  # NONE
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    table_off = len(preamble) + 8 * h
    line_bytes = 8 + w * psize * 3
    offsets = struct.pack("<" + "Q" * h, *[table_off + i * line_bytes for i in range(h)])

    dt = np.float16 if half else np.float32
    body = bytearray()
    for y in range(h):
        row = img[y]
        data = np.concatenate(
            [row[:, 2].astype(dt), row[:, 1].astype(dt), row[:, 0].astype(dt)]
        ).tobytes()
        body += struct.pack("<ii", y, len(data)) + data

    Path(path).write_bytes(preamble + offsets + bytes(body))


def read_exr(path) -> np.ndarray:
    """Read single-part scanline EXR (NONE or ZIP compression, R/G/B[/A])."""
    buf = Path(path).read_bytes()
    magic, version = struct.unpack_from("<ii", buf, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\x00", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3, 4):
        raise NotImplementedError(
            f"EXR compression {comp} (PXR24/B44/DWA) not supported; "
            "re-save with PIZ, ZIP or NONE"
        )
    # parse channel list
    chan_raw = attrs["channels"][1]
    cpos = 0
    channels = []
    while chan_raw[cpos] != 0:
        e = chan_raw.index(b"\x00", cpos)
        cname = chan_raw[cpos:e].decode()
        cpos = e + 1
        ptype = struct.unpack_from("<i", chan_raw, cpos)[0]
        cpos += 16
        channels.append((cname, ptype))
    channels.sort()  # file stores alphabetically
    nch = len(channels)
    dts = [np.float16 if p == _PIXELTYPE_HALF else np.float32 for _, p in channels]

    lines_per_block = {0: 1, 2: 1, 3: 16, 4: 32}.get(comp, 1)
    nblocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from("<" + "Q" * nblocks, buf, pos)
    out = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        rows = min(lines_per_block, h - (y - y0))
        raw_size = sum(w * rows * (2 if p == _PIXELTYPE_HALF else 4) for _, p in channels)
        if comp == 4:  # PIZ
            from . import exr_piz

            planes = exr_piz.piz_uncompress(data, channels, w, rows)
            for cname, _ in channels:
                out[cname][y - y0:y - y0 + rows] = planes[cname]
            continue
        if comp in (2, 3):  # ZIPS/ZIP
            data = zlib.decompress(data)
            # EXR zip predictor: delta-decode then de-interleave
            arr = np.frombuffer(data, np.uint8).astype(np.int16)
            arr = np.cumsum(np.concatenate([arr[:1], (arr[1:] - 128)]) , dtype=np.int64).astype(np.uint8) if False else _exr_unpredict(np.frombuffer(data, np.uint8))
            data = arr.tobytes()
        assert len(data) == raw_size, "unsupported EXR layout"
        dpos = 0
        for ri in range(rows):
            for (cname, ptype), dt in zip(channels, dts):
                nbytes = w * (2 if ptype == _PIXELTYPE_HALF else 4)
                row = np.frombuffer(data[dpos : dpos + nbytes], dt)
                out[cname][y - y0 + ri] = row.astype(np.float32)
                dpos += nbytes
    if all(c in out for c in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    first = next(iter(out))
    return out[first]


def _exr_unpredict(data: np.ndarray) -> np.ndarray:
    """Invert OpenEXR's zip predictor + interleave split."""
    # delta decode: out[i] = out[i-1] + in[i] - 128 (mod 256), vectorized via
    # cumulative sum of the (in - 128) deltas.
    deltas = data.astype(np.int64)
    deltas = np.concatenate([deltas[:1], deltas[1:] - 128])
    out = (np.cumsum(deltas) & 0xFF).astype(np.uint8)
    # de-interleave: first half = even bytes, second half = odd bytes
    n = len(out)
    half = (n + 1) // 2
    result = np.zeros(n, np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:half + n // 2]
    return result


# ---------------------------------------------------------------------------
# PFM (bitmap.h EPFM)
# ---------------------------------------------------------------------------

def write_pfm(path, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    color = img.ndim == 3 and img.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.flipud(img).tobytes())


def read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    ch = 3 if kind == b"PF" else 1
    img = data.reshape(h, w, ch) if ch == 3 else data.reshape(h, w)
    return np.flipud(img).copy()


# ---------------------------------------------------------------------------
# PNG (tonemapped LDR, like ldrfilm.cpp) and NPY (mfilm.cpp)
# ---------------------------------------------------------------------------

def tonemap_srgb(img: np.ndarray) -> np.ndarray:
    """Linear -> sRGB (the reference ldrfilm gamma path)."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * np.power(img, 1 / 2.4) - 0.055
    )


def write_png(path, img: np.ndarray, tonemap: bool = True) -> None:
    arr = tonemap_srgb(img) if tonemap else np.clip(img, 0, 1)
    data = (arr * 255.0 + 0.5).astype(np.uint8)
    if data.ndim == 2:
        data = np.repeat(data[..., None], 3, -1)
    h, w = data.shape[:2]
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = tag + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def write_npy(path, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, np.float32))


def read_png(path) -> np.ndarray:
    """Read 8/16-bit RGB(A)/gray PNG -> float32 linear (sRGB decoded)."""
    buf = Path(path).read_bytes()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    meta = {}
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4 : pos + 8]
        payload = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            meta.update(w=w, h=h, depth=depth, color=color, interlace=interlace)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    assert meta["interlace"] == 0, "interlaced PNG unsupported"
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[meta["color"]]
    assert meta["depth"] in (8, 16)
    bpp = nch * meta["depth"] // 8
    w, h = meta["w"], meta["h"]
    raw = zlib.decompress(idat)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos : pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ft == 0:
            rec = line
        elif ft == 1:
            rec = line.copy()
            for i in range(bpp, stride):
                rec[i] = (rec[i] + rec[i - bpp]) & 0xFF
        elif ft == 2:
            rec = (line + prev) & 0xFF
        elif ft == 3:
            rec = line.copy()
            for i in range(stride):
                left = rec[i - bpp] if i >= bpp else 0
                rec[i] = (rec[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            rec = line.copy()
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[i] = (rec[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ft}")
        out[y] = rec.astype(np.uint8)
        prev = rec
    if meta["depth"] == 16:
        arr = out.reshape(h, w, nch, 2)
        vals = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        img = vals.astype(np.float32) / 65535.0
    else:
        img = out.reshape(h, w, nch).astype(np.float32) / 255.0
    if nch == 1:
        img = np.repeat(img, 3, -1)
    elif nch == 2:
        img = np.repeat(img[..., :1], 3, -1)
    elif nch == 4:
        img = img[..., :3]
    return srgb_to_linear(img)


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """sRGB -> linear (bitmap.cpp converts gamma on load)."""
    img = np.asarray(img, np.float32)
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)


def read_auto(path) -> np.ndarray:
    """Load any supported image (Bitmap::Bitmap(path) analog); HDR formats
    return linear radiance, PNG is sRGB-decoded to linear."""
    p = str(path)
    if p.endswith(".exr"):
        return read_exr(p)
    if p.endswith(".pfm"):
        return read_pfm(p)
    if p.endswith(".npy"):
        return np.asarray(np.load(p), np.float32)
    if p.endswith(".png"):
        return read_png(p)
    if p.endswith(".hdr") or p.endswith(".rgbe"):
        return read_rgbe(p)
    if p.lower().endswith((".jpg", ".jpeg", ".ppm", ".tga", ".bmp", ".gif")):
        return _read_pil(p)
    raise ValueError(f"unsupported image format: {p}")


def _read_pil(path) -> np.ndarray:
    """LDR formats the reference reads through libjpeg & friends
    (bitmap.cpp EJPEG/EPPM/ETGA/EBMP); decoded with Pillow here and
    sRGB-linearized like read_png."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ValueError(
            f"reading {path} requires Pillow, which is unavailable") from e
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(img)


def write_ldr_pil(path, img: np.ndarray, tonemap: bool = True):
    """JPEG/PPM/TGA/BMP writer via Pillow (bitmap.cpp write analog)."""
    from PIL import Image
    arr = np.asarray(img, np.float32)
    if tonemap:
        arr = tonemap_srgb(arr)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(str(path))


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) (bitmap.h ERGBE)
# ---------------------------------------------------------------------------

def read_rgbe(path) -> np.ndarray:
    with open(path, "rb") as f:
        line = f.readline()
        assert line.startswith(b"#?"), "not an RGBE file"
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        assert dims[0] == b"-Y", "unsupported RGBE orientation"
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    img = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if data[pos : pos + 2] == b"\x02\x02":  # RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        img[y, x : x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        img[y, x : x + cnt, c] = np.frombuffer(
                            data[pos : pos + cnt], np.uint8
                        )
                        pos += cnt
                        x += cnt
        else:  # flat
            row = np.frombuffer(data[pos : pos + w * 4], np.uint8).reshape(w, 4)
            img[y] = row
            pos += w * 4
    e = img[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    # +0.5 mantissa-center convention (matches the reference's rgbe decode)
    return ((img[..., :3].astype(np.float32) + 0.5) * scale[..., None]
            * (img[..., 3:4] > 0)).astype(np.float32)


def write_rgbe(path, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = img.max(-1)
    # m = f * 2^e with f in [0.5, 1); mantissa byte = v * 2^(8-e)
    f, e = np.frexp(np.maximum(m, 1e-32))
    scale = np.ldexp(1.0, 8 - e)
    nz = m > 1e-32
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.where(
        nz[..., None], np.clip(img * scale[..., None], 0, 255), 0
    ).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_exr_attrs(path) -> dict:
    """Parse just the EXR header attributes; float and string attrs are
    decoded to Python values, everything else kept as (type, raw bytes).
    The data/scripts/rendertime.py:14 readback path."""
    buf = Path(path).read_bytes()
    magic, _ = struct.unpack_from("<ii", buf, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\x00", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        raw = buf[pos:pos + size]
        pos += size
        if typ == "float":
            attrs[name] = struct.unpack("<f", raw)[0]
        elif typ == "string":
            attrs[name] = raw.decode()
        else:
            attrs[name] = (typ, raw)
    return attrs


def write_image(path, img, metadata: dict | None = None) -> None:
    """Dispatch on extension (Bitmap::write analog)."""
    img = np.asarray(img)
    p = str(path)
    if p.endswith(".exr"):
        write_exr(p, img, metadata=metadata)
    elif p.endswith(".pfm"):
        write_pfm(p, img)
    elif p.endswith(".png"):
        write_png(p, img)
    elif p.endswith(".npy"):
        write_npy(p, img)
    elif p.lower().endswith((".jpg", ".jpeg", ".ppm", ".tga", ".bmp")):
        write_ldr_pil(p, img)
    elif p.endswith(".hdr") or p.endswith(".rgbe"):
        write_rgbe(p, img)
    else:
        raise ValueError(f"unsupported image format: {p}")
