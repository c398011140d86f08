"""Multi-device scaling-efficiency benchmark.

Measures the sharded render's scaling over 1, 2, 4, ... devices of one
host: the target machine is one host with four GPUs, all to all over
NVLink. With --cpu it runs on the 8-virtual-device CPU mesh, which
validates the sharding structure rather than wall-clock.

Usage: python tools/bench_scaling.py [--cpu] [--spp N]
Prints one JSON line with per-device-count timings + efficiency.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--res", type=int, default=128)
    args = ap.parse_args()
    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    from mitsuba_tpu import compile_cache
    from mitsuba_tpu.integrators import common, path
    from mitsuba_tpu.parallel import render_sharded as rs
    from mitsuba_tpu.scene import builtin

    compile_cache.enable()
    ndev = len(jax.devices())
    scene, cam = builtin.cornell_box(width=args.res, height=args.res)
    cfg = common.RenderConfig(spp=args.spp, max_depth=4, seed=0)

    results = {}
    counts = [c for c in (1, 2, 4, 8, 16) if c <= ndev]
    for c in counts:
        mesh = rs.make_mesh(c, sp=1)
        img = rs.render_sharded_jit(scene, cam, path.li, cfg, mesh)
        img.block_until_ready()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            img = rs.render_sharded_jit(scene, cam, path.li, cfg, mesh)
        img.block_until_ready()
        results[c] = (time.perf_counter() - t0) / reps

    base = results[counts[0]] * counts[0]
    eff = {c: base / (results[c] * c) for c in counts}
    print(json.dumps({
        "metric": "scaling_efficiency",
        "devices": counts,
        "seconds": {str(c): results[c] for c in counts},
        "efficiency_vs_1dev": {str(c): round(eff[c], 3) for c in counts},
        "platform": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
