"""Tiled HDR film: stream scanline bands to disk during rendering.

The reference's tiledhdrfilm (src/films/tiledhdrfilm.cpp) streams
finished ImageBlocks into a tiled OpenEXR file so huge-resolution
renders never hold the whole framebuffer. The batched redesign renders the
film in ROW BANDS — one jitted band program (traced band origin, so XLA
compiles once), executed per band, each band written into a
pre-allocated uncompressed scanline EXR through seek-writes. Peak host
memory is one band; device memory is one band's wavefront.

Box reconstruction only: like the reference's tiled film, which
documents that "reconstruction filters with a radius > 0.5 are not
supported" (tiledhdrfilm.cpp warns and clamps), band-local splatting
cannot see neighbours' contributions."""
from __future__ import annotations

import struct

import numpy as np

_EXR_MAGIC = 20000630


class TiledEXRWriter:
    """Incremental uncompressed float32 RGB scanline EXR writer: header
    + offset table up-front, rows seek-written as bands finish."""

    def __init__(self, path, width: int, height: int,
                 metadata: dict | None = None):
        from ..io.image import _exr_attr

        self.w, self.h = width, height
        chans = b""
        for c in (b"B", b"G", b"R"):
            chans += c + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
        chans += b"\x00"
        header = _exr_attr(b"channels", b"chlist", chans)
        for k, v in (metadata or {}).items():
            if isinstance(v, (int, float)):
                header += _exr_attr(k.encode(), b"float",
                                    struct.pack("<f", float(v)))
            else:
                header += _exr_attr(k.encode(), b"string", str(v).encode())
        header += _exr_attr(b"compression", b"compression", b"\x00")
        box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
        header += _exr_attr(b"dataWindow", b"box2i", box)
        header += _exr_attr(b"displayWindow", b"box2i", box)
        header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
        header += _exr_attr(b"pixelAspectRatio", b"float",
                            struct.pack("<f", 1.0))
        header += _exr_attr(b"screenWindowCenter", b"v2f",
                            struct.pack("<ff", 0, 0))
        header += _exr_attr(b"screenWindowWidth", b"float",
                            struct.pack("<f", 1.0))
        header += b"\x00"
        preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
        self._data_start = len(preamble) + 8 * height
        self._line_bytes = 8 + width * 4 * 3
        offsets = struct.pack(
            "<" + "Q" * height,
            *[self._data_start + y * self._line_bytes for y in range(height)])
        self._f = open(path, "wb")
        self._f.write(preamble + offsets)
        self._written = np.zeros(height, bool)

    def write_rows(self, y0: int, rows: np.ndarray) -> None:
        """rows: (bh, W, 3) float32, scanlines [y0, y0+bh)."""
        rows = np.asarray(rows, np.float32)
        bh = rows.shape[0]
        self._f.seek(self._data_start + y0 * self._line_bytes)
        buf = bytearray()
        for i in range(bh):
            r = rows[i]
            data = np.concatenate(
                [r[:, 2], r[:, 1], r[:, 0]]).astype(np.float32).tobytes()
            buf += struct.pack("<ii", y0 + i, len(data)) + data
        self._f.write(bytes(buf))
        self._written[y0:y0 + bh] = True

    def close(self):
        if not self._written.all():
            # zero-fill unwritten scanlines so the file stays readable
            blank = np.zeros((1, self.w, 3), np.float32)
            for y in np.nonzero(~self._written)[0]:
                self.write_rows(int(y), blank)
        self._f.close()


def render_tiled(scene, cam, li_fn, cfg, path, tile_rows: int = 64,
                 metadata: dict | None = None, progress: bool = False):
    """Render the film in row bands, streaming each into `path`. One
    XLA program for all bands (band origin is a traced scalar); sample
    streams use GLOBAL pixel ids, so the image is bit-identical to the
    full-frame render of the same config. Returns the mean radiance."""
    import jax
    import jax.numpy as jnp

    from ..core.rng import SampleStream
    from ..models import sensor as sensorlib
    from . import film as filmlib

    if cfg.filter != filmlib.FILTER_BOX:
        raise ValueError(
            "tiled film supports the box filter only "
            "(tiledhdrfilm.cpp has the same radius<=0.5 restriction)")
    w, h = cam.width, cam.height
    bh = min(tile_rows, h)
    while h % bh:
        bh -= 1
    chunk = cfg.resolve_chunk(w, bh)
    nchunks = cfg.spp // chunk
    band_px = jnp.tile((jnp.arange(w * bh, dtype=jnp.uint32) % w), (chunk,))

    @jax.jit
    def band(scene, cam, y0):
        n = w * bh * chunk
        local = jnp.arange(w * bh, dtype=jnp.uint32)
        gpix = local + jnp.uint32(w) * y0          # global pixel ids
        gpix = jnp.repeat(gpix, chunk)
        slot = jnp.tile(jnp.arange(chunk, dtype=jnp.uint32), (w * bh,))
        px_base = (gpix % w).astype(jnp.float32)
        py_base = (gpix // w).astype(jnp.float32)

        def one_chunk(acc, ci):
            sample_ids = slot + ci.astype(jnp.uint32) * jnp.uint32(chunk)
            stream = SampleStream(jnp.uint32(cfg.seed), gpix, sample_ids, 0,
                                  kind=cfg.sampler, spp=cfg.spp)
            jx = stream.next_1d()
            jy = stream.next_1d()
            u_lens = stream.next_2d()
            o, d, imp = sensorlib.sample_rays(
                cam, px_base + jx, py_base + jy, u_lens)
            rad = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
            rad = jnp.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
            return acc + jnp.sum(rad.reshape(bh, w, chunk, 3), axis=2), None

        acc, _ = jax.lax.scan(one_chunk, jnp.zeros((bh, w, 3)),
                              jnp.arange(nchunks))
        return acc / (chunk * nchunks)

    writer = TiledEXRWriter(path, w, h, metadata=metadata)
    total = 0.0
    try:
        for y0 in range(0, h, bh):
            img = np.asarray(band(scene, cam, jnp.uint32(y0)))
            writer.write_rows(y0, img)
            total += float(img.sum())
            if progress:
                import sys
                print(f"[tiled] rows {y0 + bh}/{h}", file=sys.stderr)
    finally:
        writer.close()
    return total / (w * h * 3)
