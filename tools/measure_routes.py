"""Time the intersection routes and the row fetch against each other on one
device, in one process, so every pair shares a card and a power limit.

Sections (all by default, or name some on the command line):
  gather     the Cornell render with the row fetch as a gather vs as the
             one-hot product it replaced;
  crossover  closest and any hit, XLA brute force vs BVH walk from 1k to
             70k triangles, chords and camera-coherent rays;
  renders    the big-mesh render on the BVH route and on the brute-force
             route at 24k-70k triangles.

Usage: python tools/measure_routes.py [--tiny] [section ...]
(--tiny: CPU rehearsal at toy sizes). Writes one JSON line per
measurement to stdout and to chiprun_out/measure_routes.jsonl.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

TINY = "--tiny" in sys.argv
OUT = os.path.join(ROOT, "chiprun_out", "measure_routes.jsonl")
REPS = 2 if TINY else 3


def emit(**rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def error(e) -> str:
    return f"{type(e).__name__}: {e}"[:600]


def timed(fn, *args, reps=REPS):
    """(compile+first-run s, [run ms...]) of fn(*args) with block_until_ready."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return first, times


class patched:
    """Enter a list of mock patches for the duration of a with block."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        for p in self.patches:
            p.start()

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def sphere(nu, nv):
    """Displaced sphere, 2*nu*(nv-1) triangles, BVH attached."""
    from mitsuba_tpu.scene import bvh as bvhlib, ir
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = 1.0 + 0.15 * np.sin(5 * U) * np.sin(4 * V)
    verts = np.stack([np.sin(V) * np.cos(U) * r, np.sin(V) * np.sin(U) * r,
                      np.cos(V) * r], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv - 1), indexing="ij")
    a = (i % nu) * nv + j
    b = ((i + 1) % nu) * nv + j
    tris = np.concatenate([np.stack([a, b, a + 1], -1).reshape(-1, 3),
                           np.stack([b, b + 1, a + 1], -1).reshape(-1, 3)])
    scene = ir.build_scene(verts, tris.astype(np.int32),
                           np.zeros(len(tris), np.int32),
                           [{"type": ir.BSDF_DIFFUSE}])
    return bvhlib.attach(scene)


def rays(n, coherent):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    if coherent:
        xy = jax.random.uniform(k1, (n, 2), minval=-0.5, maxval=0.5)
        o = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 4.0]), (n, 3))
        d = jnp.concatenate([xy, -jnp.ones((n, 1))], -1)
    else:
        a = jax.random.normal(k1, (n, 3))
        a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
        b = jax.random.normal(k2, (n, 3))
        b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
        u = jax.random.uniform(k3, (n, 1)) ** (1 / 3)
        o = a * 2.0
        d = b * u * 0.9 - o
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def agree(a, b):
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    both = va & vb
    ta, tb_ = np.asarray(a.t)[both], np.asarray(b.t)[both]
    return dict(valid_agree=float((va == vb).mean()),
                leaks=int((va & ~vb).sum()),
                t_close=float(np.isclose(ta, tb_, rtol=1e-4).mean())
                if both.any() else 1.0)


def route_patch(r):
    from mitsuba_tpu.ops import trace
    return [mock.patch.object(trace, "route", lambda s: r)]


def render_with(patches, scene, cam, cfg, **kw):
    from mitsuba_tpu.integrators import wavefront
    with patched(patches):
        f = jax.jit(functools.partial(wavefront.render, cfg=cfg, **kw))
        first, t = timed(f, scene, cam)
        img = np.asarray(f(scene, cam))
    return first, t, img


def abba(what, variants, scene, cam, cfg, **kw):
    """Render variant A, B, B, A; report each against the first image."""
    ref = None
    (na, pa), (nb, pb) = variants
    for name, patches in ((na, pa), (nb, pb), (nb, pb), (na, pa)):
        try:
            first, t, img = render_with(patches, scene, cam, cfg, **kw)
        except Exception as e:
            emit(what=what, variant=name, error=error(e))
            continue
        ref = img if ref is None else ref
        emit(what=what, variant=name, res=cam.width, spp=cfg.spp,
             depth=cfg.max_depth, tris=scene.num_triangles, compile_s=first,
             ms=t, mean=float(img.mean()),
             max_abs_diff_vs_first=float(np.abs(img - ref).max()))


def cornell():
    from mitsuba_tpu.integrators import common
    from mitsuba_tpu.scene import builtin
    res, spp = (32, 4) if TINY else (256, 64)
    scene, cam = builtin.cornell_box(width=res, height=res)
    return scene, cam, common.RenderConfig(spp=spp, max_depth=8, rr_depth=5,
                                           seed=0)


def section_gather():
    from mitsuba_tpu.ops import gather

    def one_hot_rows(table, idx):
        oh = (idx[:, None] == jnp.arange(table.shape[0], dtype=idx.dtype)
              [None, :]).astype(table.dtype)
        return jax.lax.dot(oh, table, precision=jax.lax.Precision.HIGHEST)

    scene, cam, cfg = cornell()
    abba("cornell_render_fetch",
         (("one_hot", [mock.patch.object(gather, "fetch_rows",
                                         one_hot_rows)]),
          ("gather", [])), scene, cam, cfg)


CROSSOVER_SIZES = (((32, 17), (64, 33)) if TINY else
                   ((32, 17), (64, 33), (90, 47), (128, 65), (160, 76),
                    (192, 87), (216, 112), (235, 150)))


def section_crossover():
    from mitsuba_tpu.ops import trace
    n = 1024 if TINY else 1 << 17
    for nu, nv in CROSSOVER_SIZES:
        scene = sphere(nu, nv)
        for coherent in (False, True):
            o, d = rays(n, coherent)
            outs = {}
            for r, patches in (("brute", route_patch("brute")),
                               ("bvh", route_patch("bvh"))):
                try:
                    with patched(patches):
                        f = jax.jit(
                            lambda s, o, d: trace.closest_hit(s, o, d))
                        first, t = timed(f, scene, o, d)
                        outs[r] = f(scene, o, d)
                    emit(what="closest", route=r, tris=scene.num_triangles,
                         rays=n, coherent=coherent, compile_s=first, ms=t)
                except Exception as e:
                    emit(what="closest", route=r, tris=scene.num_triangles,
                         error=error(e))
            if len(outs) == 2:
                emit(what="closest_agree", vs="brute", route="bvh",
                     tris=scene.num_triangles, coherent=coherent,
                     **agree(outs["brute"], outs["bvh"]))
            tmax = jnp.full((n,), 3.5)
            for r in ("brute", "bvh"):
                with patched(route_patch(r)):
                    f = jax.jit(lambda s, o, d, t: trace.any_hit(s, o, d, t))
                    first, t = timed(f, scene, o, d, tmax)
                emit(what="any_hit", route=r, tris=scene.num_triangles,
                     rays=n, coherent=coherent, compile_s=first, ms=t)


RENDER_SIZES = ((24, 12),) if TINY else ((160, 76), (192, 87),
                                          (192, 126), (216, 130),
                                          (235, 140), (235, 150))


def section_renders():
    from bench import _bigmesh_scene
    from mitsuba_tpu.integrators import common
    res = 16 if TINY else 128
    cfg = common.RenderConfig(spp=4 if TINY else 16, max_depth=4,
                              rr_depth=3, seed=0)
    for nu, nv in RENDER_SIZES:
        scene, cam = _bigmesh_scene(res, res, nu=nu, nv=nv)
        abba("bigmesh_render", (("bvh", route_patch("bvh")),
                                ("brute", route_patch("brute"))),
             scene, cam, cfg, lanes_per_pixel=4)


SECTIONS = {"gather": section_gather, "crossover": section_crossover,
            "renders": section_renders}


def main():
    from mitsuba_tpu import compile_cache

    compile_cache.enable()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    dev = jax.devices()[0]
    smi = "not available"
    if dev.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    emit(what="device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), nvidia_smi=smi)
    names = [a for a in sys.argv[1:] if not a.startswith("--")] \
        or list(SECTIONS)
    for name in names:
        SECTIONS[name]()


if __name__ == "__main__":
    main()
