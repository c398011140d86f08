"""Multi-device / multi-host parallel rendering.

Replacement for the reference's Scheduler + RemoteWorker fabric
(src/libcore/sched.cpp, sched_remote.cpp — work units over TCP/SSH): here
parallelism is SPMD over a `jax.sharding.Mesh`. The film is data-parallel
over pixels ("dp"), samples-per-pixel can be split over a second axis
("sp"), and XLA emits the psum collectives that replace the reference's
message protocol (sched_remote.h:221-237). Scene "resource registration"
(sched.h:281-292) becomes replication of the scene pytree across the mesh.
"""
from . import render_sharded as _rs_module  # noqa: F401
from .render_sharded import (  # noqa: F401
    make_mesh,
    render_sharded_jit,
    train_step,
    train_step_jit,
)

# NOTE: `render_sharded` (the function) would shadow the submodule of the
# same name in this namespace; reach the function via the submodule or use
# render_sharded_jit.
