"""Headline benchmark: rays/second, Cornell-box path tracing.

The analog of the reference's `mtsutil kdbench` rays/s utility
(src/utils/kdbench.cpp:35-66) applied to the BASELINE config: Cornell box,
`path` integrator, maxDepth 8, 256 spp at 256x256. Rays counted are
*useful* rays only — active closest-hit wavefront lanes plus NEE shadow
rays (counted exactly with an instrumented pass) — not padded lanes.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline is value / 100e6 (the BASELINE.json >=100M rays/s/chip target).
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp


# Peak float32 FLOP/s per device, keyed by jax's device_kind. Source:
# NVIDIA H100 data sheet, SXM part: 67 TFLOP/s float32 outside the tensor
# cores (the renderer's arithmetic is float32 elementwise work) at the
# 700 W power limit; a card set to a lower limit runs below it, so the
# limit is printed with every result.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}


def peak_flops(device) -> float:
    """Peak float32 FLOP/s of `device`; an unlisted device is an error."""
    try:
        return PEAK_FLOPS[device.device_kind]
    except KeyError:
        raise KeyError(f"no peak FLOP/s on record for {device.device_kind!r}"
                       f" (have: {sorted(PEAK_FLOPS)})") from None


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def _cost_bounds(cfg, scene, cam, dt, lanes_per_pixel=1):
    """Lower bounds on the FLOP/s and bytes/s of one wavefront render, from
    XLA's cost analysis of the compiled program, and the FLOP/s bound as a
    share of the device's peak.

    These are not utilisations: XLA's cost analysis counts a while_loop
    body once, not once per iteration, so the counts are lower bounds for
    the regenerative wavefront. A device metric comes from a profiler
    trace."""
    from mitsuba_tpu.integrators.wavefront import _jitted
    nan = float("nan")
    try:
        cost = (_jitted(cfg, lanes_per_pixel).lower(scene, cam).compile()
                .cost_analysis())
        if isinstance(cost, list):
            cost = cost[0]
        flops = float(cost.get("flops", 0.0))
        bytes_acc = float(cost.get("bytes accessed", 0.0))
    except Exception:
        return {"cost_flops_per_s_lower_bound": nan,
                "cost_bytes_per_s_lower_bound": nan,
                "cost_flops_share_of_peak_lower_bound": nan}
    return {"cost_flops_per_s_lower_bound": flops / dt if flops else nan,
            "cost_bytes_per_s_lower_bound": bytes_acc / dt if bytes_acc
            else nan,
            "cost_flops_share_of_peak_lower_bound":
            flops / dt / peak_flops(jax.devices()[0]) if flops else nan}


def main():
    from mitsuba_tpu import compile_cache
    from mitsuba_tpu.core.rng import SampleStream
    from mitsuba_tpu.integrators import common, path
    from mitsuba_tpu.models import sensor as sensorlib
    from mitsuba_tpu.scene import builtin

    compile_cache.enable()
    width = height = 256
    spp = 256
    cfg = common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)
    scene, cam = builtin.cornell_box(width=width, height=height)

    # --- exact useful-ray count on a sample subset ----------------------
    count_spp = 8
    npix = width * height
    pids = jnp.repeat(jnp.arange(npix, dtype=jnp.uint32), count_spp)
    slot = jnp.tile(jnp.arange(count_spp, dtype=jnp.uint32), (npix,))

    @jax.jit
    def count_rays(scene, cam):
        stream = SampleStream(jnp.uint32(cfg.seed), pids, slot, 0)
        jx, jy = stream.next_1d(), stream.next_1d()
        u_lens = stream.next_2d()
        px = (pids % width).astype(jnp.float32) + jx
        py = (pids // width).astype(jnp.float32) + jy
        o, d, _ = sensorlib.sample_rays(cam, px, py, u_lens)
        _, rays = path.li_with_stats(scene, cam, o, d, stream, cfg)
        return rays

    rays_per_sample = float(count_rays(scene, cam)) / (npix * count_spp)

    # --- timed full render ---------------------------------------------
    # the regenerative wavefront is the fast primal renderer (identical
    # estimator/sample set as path.li — validated bit-exact in tests)
    from mitsuba_tpu.integrators import wavefront

    img = wavefront.render_jit(scene, cam, cfg).block_until_ready()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        img = wavefront.render_jit(scene, cam, cfg).block_until_ready()
    dt = (time.perf_counter() - t0) / reps

    total_rays = rays_per_sample * npix * spp
    rays_per_sec = total_rays / dt
    bounds = _cost_bounds(cfg, scene, cam, dt)

    # --- big-mesh kdbench (bunny-class) ----------------------------------
    # VERDICT r1 asked for a rays/s number on a >=100k-tri scene next to
    # the Cornell number; this is the kdbench protocol (uniform chords
    # through the bounding volume) on a 70k-tri displaced sphere.
    bigmesh = _bigmesh_rays_per_sec()
    # VERDICT r3 item 1: one END-TO-END big-mesh `path` render, not just
    # the intersector microbench
    bm_render = _bigmesh_render_rays_per_sec()

    print(json.dumps({
        "metric": "cornell_path_rays_per_sec",
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / 100e6,
        "detail": {
            "resolution": [width, height], "spp": spp, "max_depth": cfg.max_depth,
            "rays_per_sample": rays_per_sample, "render_s": dt,
            "device": str(jax.devices()[0]),
            "power_limit": power_limit(),
            "mean_radiance": float(img.mean()),
            **bounds,
            **{f"bigmesh_70k_{k}": v for k, v in bm_render[3].items()},
            "bigmesh_70k_rays_per_sec": bigmesh[0],
            "bigmesh_70k_coherent_rays_per_sec": bigmesh[1],
            "bigmesh_70k_render_rays_per_sec": bm_render[0],
            "bigmesh_70k_render_s": bm_render[1],
            "bigmesh_70k_render_mean": bm_render[2],
        },
    }))


def _bigmesh_rays_per_sec(n_rays: int = 1 << 17, reps: int = 5) -> float:
    import numpy as np

    from mitsuba_tpu.ops import trace
    from mitsuba_tpu.scene import bvh as bvhlib, ir

    nu, nv = 235, 150
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = 1.0 + 0.15 * np.sin(5 * U) * np.sin(4 * V)
    verts = np.stack([np.sin(V) * np.cos(U) * r, np.sin(V) * np.sin(U) * r,
                      np.cos(V) * r], -1).reshape(-1, 3).astype(np.float32)
    idx = lambda i, j: (i % nu) * nv + j  # noqa: E731
    tris = []
    for i in range(nu):
        for j in range(nv - 1):
            tris.append([idx(i, j), idx(i + 1, j), idx(i, j + 1)])
            tris.append([idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)])
    tris = np.asarray(tris, np.int32)
    scene = ir.build_scene(verts, tris, np.zeros(len(tris), np.int32),
                           [{"type": ir.BSDF_DIFFUSE}])
    scene = bvhlib.attach(scene)

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    a = jax.random.normal(k1, (n_rays, 3))
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = jax.random.normal(k2, (n_rays, 3))
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    u = jax.random.uniform(k3, (n_rays, 1)) ** (1 / 3)
    o = a * 2.0
    d = b * u * 0.9 - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    # camera-like coherent set (one origin, cone of directions) — the
    # regime rendering workloads actually run in
    xy = jax.random.uniform(k1, (n_rays, 2), minval=-0.5, maxval=0.5)
    oc = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 4.0]), (n_rays, 3))
    dc = jnp.concatenate([xy, -jnp.ones((n_rays, 1))], -1)
    dc = dc / jnp.linalg.norm(dc, axis=-1, keepdims=True)

    f = jax.jit(lambda s, o_, d_: trace.closest_hit(s, o_, d_).t)
    out = []
    for oo, dd in ((o, d), (oc, dc)):
        f(scene, oo, dd).block_until_ready()
        t0 = time.perf_counter()
        rs = [f(scene, oo, dd) for _ in range(reps)]
        jax.block_until_ready(rs)
        out.append(n_rays / ((time.perf_counter() - t0) / reps))
    return tuple(out)




def _bigmesh_scene(width=128, height=128, nu=235, nv=150):
    """Displaced sphere (2*nu*(nv-1) tris: 70k by default) over a floor
    with an area light — the end-to-end big-mesh render fixture."""
    import numpy as np

    from mitsuba_tpu.models import sensor as sensorlib
    from mitsuba_tpu.scene import bvh as bvhlib, ir

    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = 1.0 + 0.15 * np.sin(5 * U) * np.sin(4 * V)
    verts = np.stack([np.sin(V) * np.cos(U) * r, np.sin(V) * np.sin(U) * r,
                      np.cos(V) * r], -1).reshape(-1, 3).astype(np.float32)
    idx = lambda i, j: (i % nu) * nv + j  # noqa: E731
    tris = []
    for i in range(nu):
        for j in range(nv - 1):
            tris.append([idx(i, j), idx(i + 1, j), idx(i, j + 1)])
            tris.append([idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)])
    base = len(verts)
    quads = np.asarray([
        # floor y=-1.3
        [-4, -1.3, -4], [-4, -1.3, 4], [4, -1.3, 4], [4, -1.3, -4],
        # light y=+2.2 (normal -y)
        [-0.8, 2.2, -0.8], [0.8, 2.2, -0.8], [0.8, 2.2, 0.8],
        [-0.8, 2.2, 0.8],
    ], np.float32)
    verts = np.concatenate([verts, quads])
    extra = [[base, base + 1, base + 2], [base, base + 2, base + 3],
             [base + 4, base + 5, base + 6], [base + 4, base + 6, base + 7]]
    tris = np.asarray(tris + extra, np.int32)
    T = len(tris)
    tri_mat = np.zeros((T,), np.int32)
    tri_rad = {T - 2: [12.0, 12.0, 12.0], T - 1: [12.0, 12.0, 12.0]}
    scene = ir.build_scene(
        verts, tris, tri_mat,
        [{"type": ir.BSDF_DIFFUSE, "reflectance": [0.6, 0.55, 0.5]}],
        tri_radiance=tri_rad)
    scene = bvhlib.attach(scene)
    cam = sensorlib.make_camera(origin=[0.0, 0.8, 3.6], target=[0, 0, 0],
                                fov_x=45.0, width=width, height=height)
    return scene, cam


def _bigmesh_render_rays_per_sec(spp: int = 16, reps: int = 3):
    from mitsuba_tpu.core.rng import SampleStream
    from mitsuba_tpu.integrators import common, path, wavefront
    from mitsuba_tpu.models import sensor as sensorlib

    width = height = 128
    scene, cam = _bigmesh_scene(width, height)
    cfg = common.RenderConfig(spp=spp, max_depth=4, rr_depth=3, seed=0)

    # useful-ray count on a subset (same protocol as the Cornell number)
    count_spp = 2
    npix = width * height
    pids = jnp.repeat(jnp.arange(npix, dtype=jnp.uint32), count_spp)
    slot = jnp.tile(jnp.arange(count_spp, dtype=jnp.uint32), (npix,))

    @jax.jit
    def count_rays(scene, cam):
        stream = SampleStream(jnp.uint32(cfg.seed), pids, slot, 0)
        jx, jy = stream.next_1d(), stream.next_1d()
        u_lens = stream.next_2d()
        px = (pids % width).astype(jnp.float32) + jx
        py = (pids // width).astype(jnp.float32) + jy
        o, d, _ = sensorlib.sample_rays(cam, px, py, u_lens)
        _, rays = path.li_with_stats(scene, cam, o, d, stream, cfg)
        return rays

    rays_per_sample = float(count_rays(scene, cam)) / (npix * count_spp)

    # compact=True takes effect only with fuse=True, which render_jit
    # leaves off: it is inert here (see PERF.md)
    lanes = 4
    img = wavefront.render_jit(scene, cam, cfg, lanes_per_pixel=lanes,
                               compact=True).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        img = wavefront.render_jit(scene, cam, cfg, lanes_per_pixel=lanes,
                                   compact=True).block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    total_rays = rays_per_sample * npix * spp
    bounds = _cost_bounds(cfg, scene, cam, dt, lanes)
    return total_rays / dt, dt, float(img.mean()), bounds


if __name__ == "__main__":
    main()
