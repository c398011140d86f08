"""Device profiling for renders: XLA trace capture + cost-analysis lower
bounds (closes SURVEY §5's profiling gap — the reference's
statistics.h counters exist in utils/stats.py; this adds the
device-level view the reference never had).

Usage:
    python tools/profile_render.py [outdir]          # Cornell path
                                     # (default outdir: chiprun_out/profile)
    python tools/profile_render.py outdir bigmesh    # 70k-tri render

Writes a TensorBoard/XProf trace under <outdir> (open with
`tensorboard --logdir <outdir>` or xprof) and prints a one-line
summary: wall time, the card's power limit, and lower bounds on FLOP/s
and bytes/s from the compiled HLO's cost analysis (which counts a
while_loop body once, so they are not utilisations).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from bench import peak_flops, power_limit  # noqa: E402


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "profile")
    which = sys.argv[2] if len(sys.argv) > 2 else "cornell"

    from mitsuba_tpu import compile_cache
    from mitsuba_tpu.integrators import common
    from mitsuba_tpu.scene import builtin

    compile_cache.enable()
    if which == "cornell":
        scene, cam = builtin.cornell_box(width=256, height=256)
        cfg = common.RenderConfig(spp=64, max_depth=8, rr_depth=5, seed=0)
    else:
        from bench import _bigmesh_scene
        scene, cam = _bigmesh_scene(128, 128)
        cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)

    # compile + flop estimate from XLA's own cost analysis
    from mitsuba_tpu.integrators.wavefront import _jitted
    compiled = _jitted(cfg, 1).lower(scene, cam).compile()
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        flops = float(cost.get("flops", 0.0))
        bytes_acc = float(cost.get("bytes accessed", 0.0))
    except Exception:
        flops, bytes_acc = 0.0, 0.0

    compiled(scene, cam).block_until_ready()

    with jax.profiler.trace(outdir):
        t0 = time.perf_counter()
        compiled(scene, cam).block_until_ready()
        dt = time.perf_counter() - t0

    peak = peak_flops(jax.devices()[0])
    nan = float("nan")
    print(f"scene={which} device={jax.devices()[0]} "
          f"card={power_limit()}")
    print(f"wall={dt*1e3:.1f} ms  cost-analysis flops={flops/1e9:.2f} G  "
          f"FLOP/s lower bound={flops / dt if flops else nan:.3e} "
          f"({flops / dt / peak * 100 if flops else nan:.4f}% of the "
          f"700 W peak)  bytes/s lower bound="
          f"{bytes_acc / dt if bytes_acc else nan:.3e}")
    print("note: XLA cost analysis counts a while_loop body once, so these "
          "are lower bounds, not utilisations — use the trace's op "
          "breakdown.")
    print(f"trace written to {outdir} (tensorboard --logdir {outdir})")


if __name__ == "__main__":
    main()
