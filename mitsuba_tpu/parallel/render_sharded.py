"""SPMD sharded rendering over a device mesh.

Replaces the reference's distributed scheduler (Scheduler/RemoteWorker/
StreamBackend, src/libcore/sched.cpp:427,649, sched_remote.cpp) with a
shard_map program over a 2D mesh:

  * axis "dp" — data parallel over film pixels (the analog of
    BlockedRenderProcess's 32x32 blocks, renderproc.cpp:151; here blocks
    are contiguous pixel ranges, and a shard's locality ordering does not
    matter).
  * axis "sp" — sample parallel over spp (the analog of farming independent
    sample batches to more nodes); partial sums combine with one psum,
    replacing EWorkResult messages (sched_remote.h:221-237).

Because the sampler is a pure function of (seed, pixel, sample-index), the
sharded render computes the *same estimate* as a single-device render with
the same config — device count only changes reduction order (float
associativity), not the sample set. That replaces the reference's
deterministic work-unit replay.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..core.rng import SampleStream
from ..film import film as filmlib
from ..integrators.common import RenderConfig


def make_mesh(n_devices: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a ("dp", "sp") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    assert n_devices % sp == 0, (n_devices, sp)
    return Mesh(devices.reshape(n_devices // sp, sp), ("dp", "sp"))


def _radiance_sum(scene, cam, li_fn, cfg: RenderConfig, pixel_ids, sample_base,
                  n_samples: int, chunk: int):
    """Sum of per-sample radiance for each pixel id: (Np, 3).

    pixel_ids: (Np,) uint32 flattened pixel indices (y * W + x).
    sample_base: scalar uint32 first sample index (shifts the sample stream,
    so "sp" shards cover disjoint sample ranges of the SAME global set).
    """
    from ..models import sensor as sensorlib

    npx = pixel_ids.shape[0]
    w = cam.width
    pids = jnp.repeat(pixel_ids, chunk)
    slot = jnp.tile(jnp.arange(chunk, dtype=jnp.uint32), (npx,))
    px_base = (pids % w).astype(jnp.float32)
    py_base = (pids // w).astype(jnp.float32)
    nchunks = n_samples // chunk

    def body(acc, ci):
        sample_ids = sample_base + slot + ci.astype(jnp.uint32) * jnp.uint32(chunk)
        stream = SampleStream(jnp.uint32(cfg.seed), pids, sample_ids, 0,
                              kind=cfg.sampler, spp=cfg.spp)
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        o, d, imp = sensorlib.sample_rays(cam, px_base + jx, py_base + jy, u_lens)
        radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
        radiance = jnp.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
        return acc + jnp.sum(radiance.reshape(npx, chunk, 3), axis=1), None

    acc0 = jnp.zeros((npx, 3), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(nchunks))
    return acc


def _film_sum(scene, cam, li_fn, cfg: RenderConfig, pixel_ids, sample_base,
              n_samples: int, chunk: int):
    """Filtered-splat variant of _radiance_sum: accumulates a FULL-frame
    (H, W, 3) image + (H, W) weight film from this shard's pixels. Splats
    from a shard spill across its pixel-range boundary (filter radius up
    to 3 px), so each shard carries a whole film and the films psum —
    exactly the reference's ImageBlock-with-border merge
    (imageblock.h:103) expressed as a collective."""
    from ..models import sensor as sensorlib

    npx = pixel_ids.shape[0]
    w, h = cam.width, cam.height
    pids = jnp.repeat(pixel_ids, chunk)
    slot = jnp.tile(jnp.arange(chunk, dtype=jnp.uint32), (npx,))
    px_base = (pids % w).astype(jnp.float32)
    py_base = (pids // w).astype(jnp.float32)
    nchunks = n_samples // chunk

    def body(acc, ci):
        img, wgt = acc
        sample_ids = sample_base + slot + ci.astype(jnp.uint32) * jnp.uint32(chunk)
        stream = SampleStream(jnp.uint32(cfg.seed), pids, sample_ids, 0,
                              kind=cfg.sampler, spp=cfg.spp)
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        px = px_base + jx
        py = py_base + jy
        o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)
        radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
        radiance = jnp.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
        ci_img, ci_wgt = filmlib.splat(w, h, px, py, radiance, cfg.filter)
        return (img + ci_img, wgt + ci_wgt), None

    acc0 = (jnp.zeros((h, w, 3), jnp.float32), jnp.zeros((h, w), jnp.float32))
    (img, wgt), _ = jax.lax.scan(body, acc0, jnp.arange(nchunks))
    return img, wgt


def render_sharded(scene, cam, li_fn, cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    """Full-frame render distributed over `mesh` -> (H, W, 3).

    Box filter uses the fast per-pixel-mean path; other reconstruction
    filters splat into per-shard full films merged by one psum.
    """
    ndp = mesh.shape["dp"]
    nsp = mesh.shape.get("sp", 1)
    w, h = cam.width, cam.height
    assert cfg.spp % nsp == 0, f"spp {cfg.spp} not divisible by sp={nsp}"
    spp_local = cfg.spp // nsp
    chunk = min(max(1, (1 << 19) // max(w * h // ndp, 1)), spp_local)
    while spp_local % chunk:
        chunk -= 1

    npix = w * h
    pad = (-npix) % ndp
    pixel_ids = jnp.arange(npix + pad, dtype=jnp.uint32)
    # padded lanes re-render pixel 0; discarded on reshape

    if cfg.filter != filmlib.FILTER_BOX:
        # filtered splatting: every shard carries a full film; films merge
        # with one psum over the whole mesh (splats spill across shard
        # boundaries, so per-range reductions would clip filter tails)
        def shard_fn_film(scene, cam, pixel_ids):
            sp_idx = jax.lax.axis_index("sp")
            base = sp_idx.astype(jnp.uint32) * jnp.uint32(spp_local)
            img, wgt = _film_sum(scene, cam, li_fn, cfg, pixel_ids, base,
                                 spp_local, chunk)
            img = jax.lax.psum(jax.lax.psum(img, "sp"), "dp")
            wgt = jax.lax.psum(jax.lax.psum(wgt, "sp"), "dp")
            return img / jnp.maximum(wgt, 1e-8)[..., None]

        return shard_map(
            shard_fn_film,
            mesh=mesh,
            in_specs=(P(), P(), P("dp")),
            out_specs=P(),
            check_vma=False,
        )(scene, cam, pixel_ids)

    def shard_fn(scene, cam, pixel_ids):
        sp_idx = jax.lax.axis_index("sp")
        base = sp_idx.astype(jnp.uint32) * jnp.uint32(spp_local)
        acc = _radiance_sum(scene, cam, li_fn, cfg, pixel_ids, base,
                            spp_local, chunk)
        acc = jax.lax.psum(acc, "sp")
        return acc / jnp.float32(cfg.spp)

    out = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("dp")),
        out_specs=P("dp"),
        # the renderer builds unvarying constants (chunk index arrays)
        # inside the shard; skip the varying-manual-axes check rather than
        # pcast every constant
        check_vma=False,
    )(scene, cam, pixel_ids)
    return out[:npix].reshape(h, w, 3)


@lru_cache(maxsize=64)
def _jitted_sharded(li_fn, cfg: RenderConfig, mesh: Mesh):
    return jax.jit(partial(render_sharded, li_fn=li_fn, cfg=cfg, mesh=mesh))


def render_sharded_jit(scene, cam, li_fn, cfg: RenderConfig, mesh: Mesh):
    return _jitted_sharded(li_fn, cfg, mesh)(scene, cam)


def train_step(scene, cam, target, li_fn, cfg: RenderConfig, mesh: Mesh,
               lr: float = 0.05):
    """One differentiable-rendering optimization step, fully sharded.

    The "training step" of this framework: render the scene under the mesh,
    L2 loss against `target`, gradients w.r.t. every differentiable scene
    leaf (vertices, material params, emitter radiance, texels) via
    reverse-mode AD *through the sharded wavefront*, SGD update. XLA emits
    the gradient psums — the analog of the reference's
    result-aggregation messages, with no explicit protocol.

    Returns (new_scene, loss).
    """

    # differentiate w.r.t. the float leaves only (indices/type codes are
    # int arrays; jax.grad rejects them as differentiation inputs)
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    is_diff = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating) for l in leaves]
    float_leaves = tuple(l for l, d in zip(leaves, is_diff) if d)

    def rebuild(fp):
        it = iter(fp)
        merged = [next(it) if d else l for l, d in zip(leaves, is_diff)]
        return jax.tree_util.tree_unflatten(treedef, merged)

    def loss_fn(fp):
        img = render_sharded(rebuild(fp), cam, li_fn, cfg, mesh)
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(float_leaves)
    new_float = tuple(p - lr * g for p, g in zip(float_leaves, grads))
    return rebuild(new_float), loss


# XLA's CUDA-graph command buffers failed once to build the four-card
# train step on H100s ("Failed to add kernel node to a CUDA graph:
# CUDA_ERROR_INVALID_VALUE"), after other sharded programs had run in the
# process; compiled alone, the same step ran with and without them. The
# fault is in XLA's graph runtime, not in the step, so the step is
# compiled without command buffers (PERF.md). The option is XLA's own and
# changes nothing on the CPU.
TRAIN_COMPILER_OPTIONS = {"xla_gpu_enable_command_buffer": ""}


@lru_cache(maxsize=64)
def _jitted_train(li_fn, cfg: RenderConfig, mesh: Mesh, lr: float):
    return jax.jit(partial(train_step, li_fn=li_fn, cfg=cfg, mesh=mesh,
                           lr=lr),
                   compiler_options=TRAIN_COMPILER_OPTIONS)


def train_step_jit(scene, cam, target, li_fn, cfg: RenderConfig, mesh: Mesh,
                   lr: float = 0.05):
    """`train_step`, compiled once per (li_fn, cfg, mesh, lr) with
    TRAIN_COMPILER_OPTIONS. Returns (new_scene, loss)."""
    return _jitted_train(li_fn, cfg, mesh, lr)(scene, cam, target)
