"""Decompose the end-to-end big-mesh render cost.

The render dispatches the intersector at the WAVEFRONT width (128^2
pixels x lanes per pixel) while the kdbench microbench runs 2^17-ray
batches; this probe measures, in one process:

  1. closest-hit + any-hit cost vs batch size (16k..131k) for the three
     ray classes the render actually issues: primary (camera cone),
     bounce (cosine-hemisphere off the blob surface), and shadow
     (surface -> area light, any-hit);
  2. the wavefront's step count and live-lane occupancy per step (the
     straggler tail), host-replayed with the same RNG policy.

Timings wait for the device with block_until_ready.

Usage: python tools/probe_render_decompose.py [classes|steps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def make_rays(scene, cam, n, kind, seed=0):
    """Ray batches mimicking the render's three classes."""
    from mitsuba_tpu.ops import trace

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    if kind == "primary":
        xy = jax.random.uniform(k1, (n, 2), minval=0.0, maxval=1.0)
        px = xy[:, 0] * cam.width
        py = xy[:, 1] * cam.height
        from mitsuba_tpu.models import sensor as sensorlib
        o, d, _ = sensorlib.sample_rays(cam, px, py, jnp.zeros((n, 2)))
        return o, d, None
    # start points: primary hits on the blob (trace once)
    from mitsuba_tpu.models import sensor as sensorlib
    xy = jax.random.uniform(k1, (n, 2), minval=0.0, maxval=1.0)
    o0, d0, _ = sensorlib.sample_rays(cam, xy[:, 0] * cam.width,
                                      xy[:, 1] * cam.height,
                                      jnp.zeros((n, 2)))
    its = trace.closest_hit(scene, o0, d0)
    p = o0 + d0 * jnp.where(its.valid, its.t, 2.0)[:, None]
    if kind == "bounce":
        v = jax.random.normal(k2, (n, 3))
        v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
        up = jnp.asarray([0.0, 1.0, 0.0])
        d = v + up[None, :]  # biased upward like a cosine lobe off the floor/blob
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return p + d * 1e-3, d, None
    if kind == "shadow":
        lp = jnp.stack([
            jax.random.uniform(k2, (n,), minval=-0.8, maxval=0.8),
            jnp.full((n,), 2.2),
            jax.random.uniform(k3, (n,), minval=-0.8, maxval=0.8)], -1)
        to_l = lp - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        d = to_l / dist[:, None]
        return p + d * 1e-3, d, dist - 2e-3
    raise ValueError(kind)


def probe_classes():
    from bench import _bigmesh_scene
    from mitsuba_tpu.ops import trace

    from mitsuba_tpu import compile_cache

    compile_cache.enable()
    scene, cam = _bigmesh_scene(128, 128)

    f_closest = jax.jit(lambda s, o, d: trace.closest_hit(s, o, d).t)
    f_any = jax.jit(lambda s, o, d, tm: trace.any_hit(s, o, d, tm))

    print(f"{'class':>8} {'N':>7} {'ms/call':>8} {'Mrays/s':>8}")
    for kind in ("primary", "bounce", "shadow"):
        for n in (1 << 14, 1 << 15, 1 << 16, 1 << 17):
            o, d, tm = make_rays(scene, cam, n, kind)
            o, d = jax.device_put(o), jax.device_put(d)
            if kind == "shadow":
                call = lambda: f_any(scene, o, d, tm)  # noqa: E731
            else:
                call = lambda: f_closest(scene, o, d)  # noqa: E731
            call().block_until_ready()
            reps = 5
            t0 = time.perf_counter()
            jax.block_until_ready([call() for _ in range(reps)])
            dt = (time.perf_counter() - t0) / reps
            print(f"{kind:>8} {n:>7} {dt*1e3:>8.2f} {n/dt/1e6:>8.3f}")


def probe_steps():
    """Replay the regenerative wavefront ON CPU (interpret-free, tiny) to
    count while-loop trips and live-lane occupancy per step."""
    jax.config.update("jax_platforms", "cpu")
    from bench import _bigmesh_scene
    from mitsuba_tpu.integrators import common, wavefront

    scene, cam = _bigmesh_scene(64, 64)   # quarter-res: same depth stats
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)

    # monkeypatch-free: run the same loop eagerly with instrumentation
    import mitsuba_tpu.integrators.wavefront as wf
    stats = []
    orig_while = jax.lax.while_loop

    def counting_while(cond, body, init):
        # only instrument the WAVEFRONT loop (dict state with "done");
        # inner loops (BVH traversal on the CPU path) pass through
        if not (isinstance(init, dict) and "done" in init):
            return orig_while(cond, body, init)
        s = init
        while bool(cond(s)):
            s = body(s)
            live = int((s["done"] < cfg.spp).sum())
            stats.append(live)
        return s

    jax.lax.while_loop = counting_while
    try:
        wf.render(scene, cam, cfg)
    finally:
        jax.lax.while_loop = orig_while
    n = scene and (64 * 64)
    print(f"steps={len(stats)} lanes={n}")
    for i, live in enumerate(stats):
        print(f"  step {i:3d}: live lanes {live:6d} ({live/n:5.1%})")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "classes"
    if which == "classes":
        probe_classes()
    else:
        probe_steps()
