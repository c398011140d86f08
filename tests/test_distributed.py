"""Multi-process DCN rehearsal (VERDICT r1 item 9): two OS processes, 4
virtual CPU devices each, jax.distributed + gloo collectives, one global
("dp", "sp") mesh — the closest local stand-in for the reference's
mtssrv cluster mode (src/mitsuba/mtssrv.cpp) and for real multi-host
clusters. Verifies the sharded render is process-count invariant."""
import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_render():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert lines, f"proc {pid} no RESULT:\n{out[-3000:]}"
        _, mean, diff = lines[0].split()
        results.append((float(mean), float(diff)))
    # both processes computed the same global image, equal to the
    # single-device render up to float reduction order
    assert abs(results[0][0] - results[1][0]) < 1e-6
    for mean, diff in results:
        assert mean > 0.02
        assert diff < 1e-4, diff


@pytest.mark.slow
def test_two_process_cli_render(tmp_path):
    """Multi-host CLI entry (VERDICT r4 item 5; mitsuba.cpp:290-311 /
    mtssrv.cpp:288-374 analog): two OS processes launched through
    `python -m mitsuba_tpu ... --distributed HOST:PORT,2,I --mesh 4,2`;
    process 0 writes the film, and it equals the single-process render
    up to float reduction order."""
    import numpy as np

    from tests.test_loaders import CORNELL_XML

    scene_p = tmp_path / "scene.xml"
    scene_p.write_text(CORNELL_XML)
    out_p = tmp_path / "out.exr"

    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mitsuba_tpu", str(scene_p), "--cpu",
             "--distributed", f"127.0.0.1:{port},2,{pid}",
             "--mesh", "4,2", "-o", str(out_p), "-q"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=repo, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
    assert out_p.exists()

    from mitsuba_tpu.integrators import common, path
    from mitsuba_tpu.io import image as imagelib
    from mitsuba_tpu.scene import xml as xmllib

    img = imagelib.read_exr(out_p)
    scene, cam, cfg, _ = xmllib.load_xml(scene_p)
    local = np.asarray(common.render_jit(scene, cam, path.li, cfg))
    assert img.shape == local.shape
    assert float(np.abs(img - local).max()) < 1e-4
    assert img.mean() > 0.02
