"""Smoke run of the renderer's main path on a GPU, through the normal
entry points, in one process.

    python chip_smoke.py           # phases 1-6 on one card
    python chip_smoke.py --four    # phase 7 only, on four cards

Phases: 1 device, 2 CLI render of an XML scene, 3 the five golden images,
4 full-width forward renders (Cornell wavefront, the 70k-triangle render
and chords on the big-mesh route, each against the XLA brute force),
5 gradients (reflectance against finite differences, the boundary vertex
gradient), 7 (--four) the sharded render and the sharded gradient against
one-card runs of the same configuration. There is no phase 6 (kernel
against its plain version): no hand-written kernel is on the path; the
measurements behind that decision are in PERF.md.

Each phase prints one line: what ran, sizes, time, device memory, and each
comparison beside its limit. Any failed phase makes the exit code 1. The
last line is {"ok": true, "device": {...}} and is printed only when every
phase passed. Without a GPU it exits 2 before any phase.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# golden tolerance: float reduction order (incl. scatter-add atomics)
# differs between the CPU that made the goldens and the GPU
GOLDEN_MEAN_REL = 0.015
GOLDEN_TAIL_FRAC = 0.01     # share of pixels off by more than 0.1 relative

# sizes: (resolution, spp) of each full-width run
CORNELL = (256, 256)        # the bench Cornell frame, depth 8
BIGMESH = (128, 16)         # the 70k-triangle render, depth 4
CHORDS = 1 << 17            # kdbench chords through the 70k mesh
GRAD = (256, 16)            # reflectance gradient, depth 4
FOUR = (256, 32)            # sharded render, depth 8
TRAIN = (128, 8)            # sharded train_step, depth 4
REPEATS = 5                 # timed runs of each sharded render

CORNELL_XML = """\
<scene version="0.6.0">
    <integrator type="path">
        <integer name="maxDepth" value="4"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <transform name="toWorld">
            <lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sampleCount" value="64"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="128"/>
            <integer name="height" value="128"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="white">
        <rgb name="reflectance" value="0.7, 0.7, 0.7"/>
    </bsdf>
    <shape type="rectangle">
        <transform name="toWorld">
            <rotate x="1" angle="-90"/>
            <scale value="2"/>
        </transform>
        <ref id="white"/>
    </shape>
    <shape type="sphere">
        <point name="center" x="0" y="0.5" z="0"/>
        <float name="radius" value="0.5"/>
        <bsdf type="roughconductor">
            <float name="alpha" value="0.2"/>
            <string name="distribution" value="ggx"/>
        </bsdf>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <rotate x="1" angle="90"/>
            <translate y="3"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="10, 10, 10"/>
        </emitter>
    </shape>
</scene>
"""


class Failed(Exception):
    """A comparison outside its limit."""


def check(ok: bool, what: str):
    if not ok:
        raise Failed(what)


def peak_bytes() -> int:
    import jax
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1))


def golden_error(img, ref):
    """(mean relative error, share of pixels off by > 0.1 relative)."""
    err = np.abs(img - ref) / np.maximum(ref, 5e-2)
    return float(err.mean()), float((err > 0.1).mean())


def compare_images(name, img, ref, notes):
    mean_rel, tail = golden_error(np.asarray(img), np.asarray(ref))
    notes.append(f"{name}: mean_rel={mean_rel:.3e} (<{GOLDEN_MEAN_REL}) "
                 f"tail={tail:.3e} (<{GOLDEN_TAIL_FRAC})")
    check(np.isfinite(np.asarray(img)).all(), f"{name}: non-finite pixels")
    check(mean_rel < GOLDEN_MEAN_REL and tail < GOLDEN_TAIL_FRAC,
          f"{name}: outside the golden tolerance")


def chords(n, scale=1.0):
    """n kdbench chords through a sphere of radius 2*scale."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    a = jax.random.normal(k1, (n, 3))
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = jax.random.normal(k2, (n, 3))
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    u = jax.random.uniform(k3, (n, 1)) ** (1 / 3)
    o = a * 2.0 * scale
    d = b * u * 0.9 * scale - o
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def agreement(its, ref) -> str:
    """Compare a route's hits with the XLA brute force's; raise on a miss
    the reference found, < 99.9% valid agreement, or t off by > 1e-4."""
    va, vb = np.asarray(ref.valid), np.asarray(its.valid)
    both = va & vb
    agree = float((va == vb).mean())
    leaks = int((va & ~vb).sum())
    t_ok = bool(np.allclose(np.asarray(its.t)[both], np.asarray(ref.t)[both],
                            rtol=1e-4, atol=0.0))
    check(agree > 0.999 and leaks == 0 and t_ok,
          f"hits vs brute: agree={agree} leaks={leaks} t_ok={t_ok}")
    return (f"valid agree={agree:.6f} (>0.999) leaks={leaks} (0) "
            f"t within rtol 1e-4={t_ok}")


def _load_test_module(name):
    """Import tests/<name>.py by path (a `tests` package may shadow it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def memory_of(fn, *args) -> str:
    """Compile fn for args and report XLA's memory analysis."""
    ma = fn.lower(*args).compile().memory_analysis()
    if ma is None:
        return "memory_analysis=n/a"
    return (f"temp={ma.temp_size_in_bytes} args={ma.argument_size_in_bytes} "
            f"out={ma.output_size_in_bytes}")


# --------------------------------------------------------------------------
# phases: each appends its notes to `notes` and raises Failed on a
# comparison outside its limit
# --------------------------------------------------------------------------

def phase_cli(notes):
    """mitsuba_tpu.cli.main on an XML scene; EXR read back and compared
    with an in-process render of the same loaded scene."""
    from mitsuba_tpu import cli
    from mitsuba_tpu.integrators import common
    from mitsuba_tpu.io import image
    from mitsuba_tpu.scene import xml as xmllib

    os.makedirs(WORK, exist_ok=True)
    xml = os.path.join(WORK, "cornell.xml")
    out = os.path.join(WORK, "cornell.exr")
    with open(xml, "w") as f:
        f.write(CORNELL_XML)
    rc = cli.main([xml, "-o", out, "-q"])
    check(rc in (0, None), f"cli returned {rc}")
    img = image.read_exr(out)
    scene, cam, cfg, integ = xmllib.load_xml(xml)
    ref = np.asarray(common.render_jit(scene, cam, cli.resolve_integrator(
        integ), cfg))
    diff = float(np.abs(img - ref).max())
    notes += [f"{cam.width}x{cam.height} {cfg.spp}spp depth {cfg.max_depth}"
              f", {scene.num_triangles} tris",
              f"exr mean={float(img.mean()):.5f} (finite, > 0.01)",
              f"max|exr - in-process|={diff:.2e} (<1e-5)"]
    check(img.shape == (cam.height, cam.width, 3), f"exr shape {img.shape}")
    check(np.isfinite(img).all() and img.mean() > 0.01, "exr mean")
    check(diff < 1e-5, "exr differs from the in-process render")


def phase_goldens(notes):
    """The five golden cases against tests/golden/*.npy (made on the CPU)."""
    sys.path.insert(0, ROOT)
    from tools.golden_scenes import CASES, render_case

    for name in CASES:
        ref = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npy"))
        img = render_case(name)
        check(img.shape == ref.shape, f"{name}: shape {img.shape}")
        compare_images(name, img, ref, notes)


def phase_forward(notes):
    """Full-width renders and the big-mesh route against the brute force."""
    import jax

    from bench import _bigmesh_scene
    from mitsuba_tpu.integrators import common, path, wavefront
    from mitsuba_tpu.ops import intersect, trace
    from mitsuba_tpu.scene import builtin

    # Cornell: the regenerative wavefront against the fixed-depth path.li
    # (same sample streams and estimator)
    res, spp = CORNELL
    scene, cam = builtin.cornell_box(width=res, height=res)
    cfg = common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)
    wf = jax.jit(lambda s, c: wavefront.render(s, c, cfg))
    mem = memory_of(wf, scene, cam)
    t0 = time.perf_counter()
    img = wf(scene, cam).block_until_ready()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = wf(scene, cam).block_until_ready()
    t_wf = time.perf_counter() - t0
    ref = common.render_jit(scene, cam, path.li, cfg).block_until_ready()
    notes.append(f"cornell wavefront {res}x{res} {spp}spp depth 8: "
                 f"{t_wf:.3f}s (first {t_first:.1f}s) {mem}")
    compare_images("cornell wavefront vs path.li", img, ref, notes)

    # the 70k render on the route trace.py picks vs on the brute force
    res, spp = BIGMESH
    scene_b, cam_b = _bigmesh_scene(res, res)
    cfg_b = common.RenderConfig(spp=spp, max_depth=4, rr_depth=3, seed=0)
    route = trace.route(scene_b)
    wf_b = jax.jit(lambda s, c: wavefront.render(s, c, cfg_b,
                                                 lanes_per_pixel=4))
    wf_b(scene_b, cam_b).block_until_ready()
    t0 = time.perf_counter()
    img_b = wf_b(scene_b, cam_b).block_until_ready()
    t_b = time.perf_counter() - t0
    brute_scene = scene_b.replace(bvh=None)
    img_ref = wf_b(brute_scene, cam_b).block_until_ready()
    notes.append(f"big-mesh render {res}x{res} {spp}spp depth 4 "
                 f"({scene_b.num_triangles}"
                 f" tris, route={route}): {t_b:.3f}s, "
                 f"mean={float(img_b.mean()):.5f}")
    compare_images(f"big-mesh {route} vs brute", img_b, img_ref, notes)

    # big-mesh chords: the chosen route against the XLA brute force
    o, d = chords(CHORDS)
    its = jax.jit(trace.closest_hit)(scene_b, o, d)
    ref = jax.jit(intersect.intersect_brute)(scene_b, o, d)
    notes.append(f"big-mesh chords n={CHORDS} route={route}: "
                 + agreement(its, ref))


def phase_gradients(notes):
    """Reflectance gradient vs central differences; boundary gradient."""
    import jax
    import jax.numpy as jnp

    from mitsuba_tpu.integrators import boundary, common, path
    from mitsuba_tpu.scene import builtin

    res, spp = GRAD
    scene, cam = builtin.cornell_box(width=res, height=res)
    # rr_depth > max_depth: no Russian roulette, so at a fixed seed the
    # estimator is smooth in the reflectance and differences are exact up
    # to O(eps^2)
    cfg = common.RenderConfig(spp=spp, max_depth=4, rr_depth=8, seed=5)
    refl0 = scene.materials.reflectance

    def loss(theta):
        refl = refl0.at[0, 0].add(theta)
        s = scene.replace(materials=scene.materials.replace(reflectance=refl))
        return jnp.mean(common.render(s, cam, path.li, cfg))

    t0 = time.perf_counter()
    g = float(jax.jit(jax.grad(loss))(0.0))
    t_g = time.perf_counter() - t0
    f = jax.jit(loss)
    eps = 0.05
    fd = (float(f(eps)) - float(f(-eps))) / (2 * eps)
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    notes.append(f"d mean / d refl[0,0] {res}x{res} {spp}spp depth 4: "
                 f"AD={g:.6f} "
                 f"FD={fd:.6f} rel={rel:.2e} (<0.02) {t_g:.1f}s")
    check(np.isfinite(g) and abs(fd) > 1e-4 and rel < 0.02, "AD vs FD")

    vg = _load_test_module("test_vertex_grad")
    BLOCKER_ROWS = vg.BLOCKER_ROWS
    scene_s, cam_s = vg.shadow_scene()
    bc = boundary.BoundaryConfig(n_edge=4, primary=False)

    def loss_b(theta):
        s = scene_s.replace(vertices=scene_s.vertices
                            .at[BLOCKER_ROWS[0]:BLOCKER_ROWS[1], 0]
                            .add(theta))
        cfg_b = common.RenderConfig(spp=16, max_depth=2, seed=3)
        img = common.render(
            s, cam_s, lambda s_, c_, o, d, st, cf:
            boundary.li_grad(s_, c_, o, d, st, cf, bc), cfg_b)
        return jnp.mean(img)

    gb = float(jax.jit(jax.grad(loss_b))(0.0))
    notes.append(f"boundary vertex gradient={gb:.4f} (finite, < -0.1)")
    check(np.isfinite(gb) and gb < -0.1, "boundary gradient")


def phase_four(notes):
    """render_sharded over (4,1) and (2,2) meshes and the sharded
    train_step gradient, each against the one-card run of the same
    configuration (same sample set; only the reduction order differs)."""
    import jax

    from mitsuba_tpu.integrators import common, path
    from mitsuba_tpu.parallel import render_sharded as rs
    from mitsuba_tpu.scene import builtin

    check(len(jax.devices()) >= 4, f"needs 4 devices: {jax.devices()}")
    res, spp = FOUR
    scene, cam = builtin.cornell_box(width=res, height=res)
    cfg = common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)
    one = rs.make_mesh(1, sp=1)
    layouts = {(1, 1): one}
    for dp, sp in ((4, 1), (2, 2)):
        layouts[(dp, sp)] = rs.make_mesh(4, sp=sp)
    fns = {(1, 1): lambda s, c: rs.render_sharded_jit(s, c, path.li, cfg,
                                                     one)}
    for k in ((4, 1), (2, 2)):
        fns[k] = jax.jit(lambda s, c, mesh=layouts[k]: rs.render_sharded(
            s, c, path.li, cfg, mesh))
    imgs = {k: np.asarray(f(scene, cam).block_until_ready())
            for k, f in fns.items()}
    # interleaved repeats: one slow first call or a clock ramp on one
    # layout shows as spread, not as a difference between layouts
    times = {k: [] for k in fns}
    for _ in range(REPEATS):
        for k, f in fns.items():
            t0 = time.perf_counter()
            f(scene, cam).block_until_ready()
            times[k].append(time.perf_counter() - t0)
    ref = imgs[(1, 1)]
    lim = 1e-4 * float(np.abs(ref).max())
    for (dp, sp), img in imgs.items():
        ts = sorted(times[(dp, sp)])
        diff = float(np.abs(img - ref).max())
        notes.append(f"render_sharded ({dp},{sp}) {res}x{res} {spp}spp "
                     f"depth 8: median {ts[len(ts) // 2]:.4f}s "
                     f"(min {ts[0]:.4f} max {ts[-1]:.4f}, {REPEATS} runs) "
                     f"max|diff vs 1 card|={diff:.2e} (<{lim:.2e})")
        check(np.isfinite(img).all() and diff < lim, f"mesh ({dp},{sp})")

    res_t, spp_t = TRAIN
    scene_t, cam_t = builtin.cornell_box(width=res_t, height=res_t)
    cfg_t = common.RenderConfig(spp=spp_t, max_depth=4, rr_depth=8, seed=1)
    target = np.zeros((res_t, res_t, 3), np.float32)

    def step(key):
        """(parameter leaves, loss, seconds) of one train_step on a layout;
        a failure names the layout."""
        t0 = time.perf_counter()
        try:
            new, loss = rs.train_step_jit(scene_t, cam_t, target, path.li,
                                          cfg_t, layouts[key])
            loss = float(loss)
        except Exception as e:
            raise Failed(f"train_step {key}: {type(e).__name__}: {e}") from e
        return (jax.tree_util.tree_leaves(new), loss,
                time.perf_counter() - t0)

    leaves1, loss1, _ = step((1, 1))
    for dp, sp in ((4, 1), (2, 2)):
        leaves4, loss4, dt = step((dp, sp))
        worst = 0.0
        for a, b in zip(leaves1, leaves4):
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype.kind != "f" or a.size == 0:
                continue
            scale = max(float(np.abs(a).max()), 1e-6)
            worst = max(worst, float(np.abs(a - b).max()) / scale)
        notes.append(f"train_step ({dp},{sp}) {res_t}x{res_t} {spp_t}spp "
                     f"depth 4: "
                     f"{dt:.1f}s loss {loss4:.6f} vs {loss1:.6f}, "
                     f"max rel param diff={worst:.2e} (<1e-4)")
        check(abs(loss4 - loss1) <= 1e-4 * abs(loss1) and worst < 1e-4,
              f"train_step ({dp},{sp})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    from mitsuba_tpu import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{dev.platform} ({dev.device_kind})", file=sys.stderr)
        return 2
    compile_cache.enable()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[1 device] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    for line in smi.stdout.strip().splitlines() or ["(no output)"]:
        print(f"nvidia-smi: {line}", flush=True)

    phases = ([("7 four", phase_four)] if args.four else
              [("2 cli", phase_cli), ("3 goldens", phase_goldens),
               ("4 forward", phase_forward), ("5 gradients", phase_gradients)])
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        notes = []
        try:
            fn(notes)
            status = "PASS"
        except Exception as e:  # a failed phase is reported, the rest run
            ok = False
            status = "FAIL"
            notes.append(f"{type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stderr)
        print(f"[{name}] {status} {time.perf_counter() - t0:.1f}s "
              f"peak_bytes_in_use={peak_bytes()} | " + " | ".join(notes),
              flush=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
