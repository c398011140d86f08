"""Command-line renderer: `python -m mitsuba_tpu scene.xml [-o out.exr]`.

The analog of the `mitsuba` CLI frontend (src/mitsuba/mitsuba.cpp:129
mitsuba_app): parse the scene, pick the integrator, render, develop the
film to disk. Flags mirror the reference where meaningful:
  -D key=value   parameter substitution ($key in XML, mitsuba.cpp:58,168)
  -o file        output (EXR/PNG/PFM/NPY/HDR by extension)
  -s spp         override sample count
  -d depth       override maxDepth
  -t seed        RNG seed
  -q             quiet
Scheduling flags (-p cores, -c nodes) have no analog: parallelism is the
device mesh, controlled with --mesh dp,sp.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="mitsuba_tpu",
        description="Differentiable Monte Carlo renderer in JAX "
                    "(Mitsuba-compatible scenes)",
    )
    ap.add_argument("scene", nargs="+", help="scene XML file(s)")
    ap.add_argument("-o", "--output", default=None, help="output image file")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="define a scene parameter ($key substitution)")
    ap.add_argument("-s", "--spp", type=int, default=None, help="override spp")
    ap.add_argument("-d", "--depth", type=int, default=None, help="override maxDepth")
    ap.add_argument("-t", "--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("-a", action="append", default=[], metavar="path",
                    dest="search_paths",
                    help="prepend a file-resolver search path "
                         "(repeatable; mitsuba -a parity)")
    ap.add_argument("--integrator", default=None,
                    help="override integrator (path/direct/volpath/depth/normal/ao)")
    ap.add_argument("--mesh", default=None, metavar="DP,SP",
                    help="device mesh shape for multi-chip rendering")
    ap.add_argument("--distributed", default=None,
                    metavar="HOST:PORT,N,I[,CARD]",
                    help="multi-process rendering (the mtssrv/-c cluster "
                         "analog, mitsuba.cpp:290-311, mtssrv.cpp:288-374): "
                         "coordinator address, total process count, this "
                         "process's id, and optionally the one local GPU "
                         "this process drives (default: $LOCAL_RANK when "
                         "the launcher sets it, else every local device, "
                         "for one process per host). Launch the same "
                         "command once per process; combine with --mesh to "
                         "lay out the GLOBAL device mesh. Process 0 writes "
                         "the output.")
    ap.add_argument("-j", "--jobs", type=int, default=1,
                    help="render multiple scenes concurrently (mitsuba.cpp"
                         " -j; JAX dispatch overlaps host-side work)")
    ap.add_argument("--time-bins", type=int, default=1, metavar="K",
                    help="object motion blur: render K stratified shutter"
                         " times (animated toWorldEnd / deformable shapes)"
                         " and average; the scene pytree keeps its shapes"
                         " so XLA compiles once")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="EDebug log level (mitsuba.cpp -v)")
    ap.add_argument("--log-file", default=None, metavar="PATH",
                    help="also append log records to a file "
                         "(StreamAppender/logger.h analog)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (debugging without a GPU)")
    ap.add_argument("-r", "--refresh", type=float, default=0.0, metavar="SEC",
                    help="write the partial image every SEC seconds while "
                         "rendering (mitsuba.cpp:107-127 -r flush thread; "
                         "SIGHUP also forces a flush). Renders in "
                         "progressive passes.")
    ap.add_argument("--debug-fp", action="store_true",
                    help="trap NaN/Inf in every jitted computation "
                         "(MTS_DEBUG_FP / SIGFPE analog, "
                         "renderproc.cpp:73-84 — jax_debug_nans re-runs "
                         "the offending op un-jitted and raises)")
    return ap


# Integrators with their own render drivers (not per-ray Li functions).
SPECIAL_INTEGRATORS = ("ptracer", "sppm", "ppm", "photonmapper",
                       "pssmlt", "mlt", "erpt", "multichannel", "irrcache", "bre")


def resolve_integrator(name: str):
    from .integrators import aov, direct, path, volpath

    from .integrators import bdpt, lvcbpt

    from .integrators import spectral

    table = {
        "path": path.li,
        "spectral": spectral.li,
        "spectral_path": spectral.li,
        "volpath": volpath.li,
        "volpath_simple": volpath.li,
        "direct": direct.li,
        "depth": aov.li_depth,
        "normal": aov.li_normal,
        "field": aov.li_normal,
        "ao": aov.li_ao,
        "motion": aov.li_motion,
        "lvcbpt": lvcbpt.li,
        "bdpt": bdpt.li,
        "mybdpt": bdpt.li,
        "mybdpt2": bdpt.li,
        "mypath": path.li,   # fork's instrumented tracer == path + mis_mode
        "mypath2": path.li,
        "vpl": __import__("mitsuba_tpu.integrators.vpl",
                          fromlist=["li"]).li,
    }
    if name in SPECIAL_INTEGRATORS:
        return name
    if name not in table:
        raise SystemExit(
            f"integrator '{name}' is not available "
            f"(have: {sorted(table) + list(SPECIAL_INTEGRATORS)})"
        )
    return table[name]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from .core import logger as loglib

    logger = loglib.get_logger()
    if args.quiet:
        logger.set_log_level(loglib.EWarn)
    elif args.verbose:
        logger.set_log_level(loglib.EDebug)
    if args.log_file:
        logger.add_appender(loglib.FileAppender(args.log_file))
    if len(args.scene) > 1:
        # multi-scene batch (mitsuba.cpp -j): thread pool overlaps the
        # host-side scene loading / dispatch; device work serializes on
        # the single accelerator but stays queued back-to-back
        import concurrent.futures as cf
        import copy

        def one(scene_path):
            a = copy.copy(args)
            a.scene = [scene_path]
            if args.output:
                base, ext = args.output.rsplit(".", 1)
                stem = scene_path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
                a.output = f"{base}_{stem}.{ext}"
            return _render_one(a)

        with cf.ThreadPoolExecutor(max_workers=max(args.jobs, 1)) as ex:
            list(ex.map(one, args.scene))
        return
    _render_one(args)


def _parse_distributed(spec: str, environ=None):
    """HOST:PORT,N,I[,CARD] -> (coordinator, n, i, card).

    card is the local GPU this process drives: CARD, else the launcher's
    LOCAL_RANK (one process per card), else None (every local device)."""
    parts = spec.split(",")
    local_rank = (os.environ if environ is None else environ).get("LOCAL_RANK")
    try:
        if len(parts) not in (3, 4):
            raise ValueError(spec)
        n, i = int(parts[1]), int(parts[2])
        card = (int(parts[3]) if len(parts) == 4
                else int(local_rank) if local_rank else None)
    except ValueError:
        raise SystemExit(f"bad --distributed '{spec}' (LOCAL_RANK="
                         f"{local_rank}), expected "
                         "HOST:PORT,NUM_PROCS,PROCESS_ID[,CARD]") from None
    if card is not None and card < 0:
        raise SystemExit(f"bad --distributed card {card}")
    return parts[0], n, i, card


def _render_one(args):
    t0 = time.time()

    if args.cpu:
        import jax

        # NOTE: must run before any device use; the env var JAX_PLATFORMS
        # can be overridden by PJRT bootstrap hooks, config.update is not
        jax.config.update("jax_platforms", "cpu")
    from . import compile_cache

    compile_cache.enable()
    if args.distributed:
        # jax.distributed must initialize before the first backend use
        # (after the --cpu platform pin above). Every participating
        # process runs the same CLI invocation with its own process id I.
        import jax

        coord, n, i, card = _parse_distributed(args.distributed)
        # with a card, local_device_ids restricts this process to that GPU,
        # so processes sharing a host never reserve the same card's memory
        # (it has no effect on the CPU backend)
        jax.distributed.initialize(
            coordinator_address=coord, num_processes=n, process_id=i,
            local_device_ids=None if card is None else [card])
        if card is not None:
            try:
                jax.local_devices()
            except RuntimeError as e:  # the backend rejects an absent card
                raise SystemExit(f"--distributed: no local GPU {card} "
                                 f"on this host ({e})") from e
    if args.debug_fp:
        import jax

        jax.config.update("jax_debug_nans", True)

    defaults = {}
    for d in args.D:
        if "=" not in d:
            raise SystemExit(f"bad -D argument '{d}', expected key=value")
        k, v = d.split("=", 1)
        defaults[k] = v

    from .scene import xml as xmllib

    scene_path = args.scene[0] if isinstance(args.scene, list) else args.scene
    if not os.path.exists(scene_path):
        raise SystemExit(f"scene file not found: {scene_path}")
    scene, cam, cfg, integ_name = xmllib.load_xml(
        scene_path, defaults=defaults, search_paths=args.search_paths)
    if args.spp:
        cfg = cfg.__class__(**{**cfg.__dict__, "spp": args.spp})
    if args.depth:
        cfg = cfg.__class__(**{**cfg.__dict__, "max_depth": args.depth})
    if args.seed:
        cfg = cfg.__class__(**{**cfg.__dict__, "seed": args.seed})
    li_fn = resolve_integrator(args.integrator or integ_name)

    # large scenes get a BVH automatically (kd-tree build analog,
    # scene.cpp:340 Scene::initialize), where this platform walks it
    from .ops import trace

    scene = trace.with_bvh_if_walked(scene)

    from .core import logger as loglib
    from .utils import stats as statslib

    loglib.Log(loglib.EInfo,
               "%d triangles, %dx%d @ %d spp, integrator=%s",
               scene.num_triangles, cam.width, cam.height, cfg.spp,
               args.integrator or integ_name)
    st = statslib.get_statistics()
    st.add("Scene.triangles", scene.num_triangles)
    st.add("Scene.pixels", cam.width * cam.height)

    from .integrators import common

    if li_fn == "ptracer":
        from .integrators import ptracer

        img = ptracer.render_jit(scene, cam, cfg)
    elif li_fn == "photonmapper":
        from .integrators import photonmapper as pmlib

        img = pmlib.render(scene, cam, cfg,
                           n_passes=max(min(cfg.spp // 4, 16), 1))
    elif li_fn in ("sppm", "ppm"):
        from .integrators import sppm as sppmlib

        img, _ = sppmlib.render(scene, cam, cfg, n_passes=max(cfg.spp // 4, 1))
    elif li_fn == "pssmlt":
        from .integrators import pssmlt as pssmltlib

        img = pssmltlib.render_jit(scene, cam, cfg,
                                   n_mutations=max(cfg.spp, 64))
    elif li_fn == "mlt":
        # path-space MLT (Veach mutators); area-lit scenes — env/delta-lit
        # scenes fall back to primary-sample-space (see mlt.py scope notes)
        if scene.has_area and not (scene.has_env
                                   or scene.delta_emitters is not None):
            from .integrators import mlt as mltlib

            img = mltlib.render_jit(scene, cam, cfg,
                                    n_mutations=max(cfg.spp, 64))
        else:
            from .integrators import pssmlt as pssmltlib

            img = pssmltlib.render_jit(scene, cam, cfg,
                                       n_mutations=max(cfg.spp, 64))
    elif li_fn == "bre":
        from .integrators import bre as brelib

        img = brelib.render_jit(scene, cam, cfg)
    elif li_fn == "irrcache":
        from .integrators import irrcache as irrlib

        img = irrlib.render(scene, cam, cfg)
    elif li_fn == "erpt":
        from .integrators import erpt as erptlib

        img = erptlib.render_jit(scene, cam, cfg,
                                 chain_length=max(cfg.spp, 64))
    elif li_fn == "multichannel":
        # one image per channel: out.exr, out_depth.exr, out_normal.exr, ...
        from .integrators import multichannel as mclib
        import numpy as np
        from .io import image as imagelib

        outs = mclib.render(scene, cam, cfg)
        stem = (args.output or (scene_path.rsplit(".", 1)[0] + ".exr"))
        base, ext = stem.rsplit(".", 1)
        for ch, arr in outs.items():
            p = stem if ch == "radiance" else f"{base}_{ch}.{ext}"
            imagelib.write_image(p, np.asarray(arr))
            if not args.quiet:
                print(f"[mitsuba_tpu] wrote {p}", file=sys.stderr)
        print(f"[mitsuba_tpu] done in {time.time() - t0:.1f}s",
              file=sys.stderr)
        return 0
    elif args.mesh:
        import jax
        from .parallel import render_sharded as rs

        dp, sp = (int(x) for x in args.mesh.split(","))
        if dp * sp > len(jax.devices()):
            raise SystemExit(
                f"--mesh {args.mesh} needs {dp * sp} devices but only "
                f"{len(jax.devices())} are available"
            )
        mesh = rs.make_mesh(dp * sp, sp=sp)
        if args.distributed:
            # Multi-controller SPMD: every process must trace the SAME
            # program over the GLOBAL mesh. Baking scene/cam in as jit
            # constants (no array arguments) is what guarantees that —
            # passing them as arguments would make each process's
            # host-local arrays the inputs of a differently-addressed
            # global computation (tests/distributed_worker.py pattern).
            # The replicated result is then gathered so process 0 can
            # develop the film (the EWorkResult merge, sched_remote.h:221,
            # as one collective).
            from jax.experimental import multihost_utils

            img = jax.jit(
                lambda: rs.render_sharded(scene, cam, li_fn, cfg, mesh))()
            img = multihost_utils.process_allgather(img, tiled=True)
        else:
            img = rs.render_sharded_jit(scene, cam, li_fn, cfg, mesh)
    elif args.time_bins > 1:
        # time-binned object motion blur (deformable.cpp / track.h
        # analog): each bin re-loads the scene at a stratified shutter
        # time; identical pytree shapes -> one XLA compile, K executions
        import numpy as np
        acc = None
        for b in range(args.time_bins):
            tb = (b + 0.5) / args.time_bins
            scene_b, cam_b, _, _ = xmllib.load_xml(
                scene_path, defaults=defaults, time=tb)
            scene_b = trace.with_bvh_if_walked(scene_b)
            cfg_b = cfg.__class__(**{**cfg.__dict__,
                                     "seed": cfg.seed + b * 7919})
            img_b = common.render_jit(scene_b, cam_b, li_fn, cfg_b)
            acc = np.asarray(img_b) if acc is None else acc + np.asarray(img_b)
        img = acc / args.time_bins
    elif cfg.film_tiled and callable(li_fn):
        # tiledhdrfilm: row bands streamed straight to the EXR
        from .film import tiled as tiledlib

        out_t = args.output or (scene_path.rsplit(".", 1)[0] + ".exr")
        if not out_t.endswith(".exr"):
            raise SystemExit("tiledhdrfilm requires an .exr output")
        mean = tiledlib.render_tiled(
            scene, cam, li_fn, cfg, out_t,
            metadata={"spp": float(cfg.spp),
                      "generatedBy": "mitsuba_tpu"},
            progress=not args.quiet)
        render_s = time.time() - t0
        st.add("Render.wall_clock", render_s, unit="s")
        loglib.Log(loglib.EInfo, "wrote %s in %.1fs (mean %.4f, tiled)",
                   out_t, render_s, mean)
        if not args.quiet:
            st.print_stats()
        return 0
    elif args.refresh > 0:
        # progressive passes + periodic/SIGHUP partial-image flush
        # (mitsuba.cpp:91-127: SIGHUP handler + `-r sec` flush thread)
        import signal
        import numpy as np
        from .utils import checkpoint as ckpt

        out_partial = args.output or (scene_path.rsplit(".", 1)[0] + ".exr")
        from .io import image as imagelib

        flush_req = {"at": time.time(), "force": False}

        def _on_hup(signum, frame):
            flush_req["force"] = True

        try:
            signal.signal(signal.SIGHUP, _on_hup)
        except (ValueError, AttributeError):
            pass  # non-main thread / platform without SIGHUP

        def on_pass(state):
            now = time.time()
            if flush_req["force"] or now - flush_req["at"] >= args.refresh:
                imagelib.write_image(out_partial, state.image)
                loglib.Log(loglib.EInfo, "flushed partial film (%d/%d spp)",
                           state.spp_done, cfg.spp)
                flush_req["at"] = now
                flush_req["force"] = False

        pass_spp = max(min(cfg.spp // 8, 64), 1)
        state = ckpt.render_progressive(
            scene, cam, li_fn, cfg, total_spp=cfg.spp, pass_spp=pass_spp,
            on_pass=on_pass, progress=not args.quiet)
        img = state.image
    else:
        img = common.render_jit(scene, cam, li_fn, cfg)

    import numpy as np

    img = np.asarray(img)
    if args.distributed:
        # only the coordinator-side process develops the film (mtssrv
        # workers never write; the client assembles, mitsuba.cpp:311)
        import jax

        if jax.process_index() != 0:
            from .core import logger as _ll
            _ll.Log(_ll.EInfo, "worker %d done (mean %.4f)",
                    jax.process_index(), img.mean())
            return 0
    out = args.output or (scene_path.rsplit(".", 1)[0] + ".exr")
    from .io import image as imagelib

    render_s = time.time() - t0
    # renderTime in the EXR header (film metadata the reference stamps;
    # read back by data/scripts/rendertime.py:14 / `mtsutil rendertime`)
    meta = {"renderTime": render_s,
            "spp": float(cfg.spp),
            "generatedBy": "mitsuba_tpu"} if out.endswith(".exr") else None
    imagelib.write_image(out, img, metadata=meta)
    st.add("Render.wall_clock", render_s, unit="s")
    st.add("Render.samples",
           float(cfg.spp) * cam.width * cam.height)
    loglib.Log(loglib.EInfo, "wrote %s in %.1fs (mean %.4f)",
               out, render_s, img.mean())
    if not args.quiet:
        # Statistics::printStats at exit (mitsuba.cpp:408)
        st.print_stats()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
