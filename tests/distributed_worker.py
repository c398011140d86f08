"""Worker process for the multi-process (DCN-rehearsal) sharded-render
test (tests/test_distributed.py). Two of these run side by side, each
owning 4 virtual CPU devices; jax.distributed + gloo collectives stand in
for the multi-host path (SURVEY §4's "do better than the
reference's mtssrv loopback" item).

Usage: python tests/distributed_worker.py <coordinator> <num_procs> <pid>
Prints "RESULT <mean> <maxabsdiff-vs-local>" on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    from mitsuba_tpu import compile_cache

    compile_cache.enable()
    coord, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

    import numpy as np
    from jax.experimental import multihost_utils

    from mitsuba_tpu.integrators import common, path
    from mitsuba_tpu.parallel import render_sharded as rs
    from mitsuba_tpu.scene import builtin

    scene, cam = builtin.cornell_box(width=16, height=16)
    cfg = common.RenderConfig(spp=16, max_depth=3, seed=0)
    mesh = rs.make_mesh(4 * nprocs, sp=2)

    # scene/cam/pixel ids are identical process-local constants; jit with
    # no arguments bakes them into the SPMD program on every process
    fn = jax.jit(lambda: rs.render_sharded(scene, cam, path.li, cfg, mesh))
    img = fn()
    img_global = np.asarray(multihost_utils.process_allgather(img, tiled=True))

    # the pure-function sampler guarantees the distributed estimate equals
    # the single-device render up to reduction order
    local = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    diff = float(np.abs(img_global - local).max())
    print(f"RESULT {img_global.mean():.6f} {diff:.2e}", flush=True)


if __name__ == "__main__":
    main()
