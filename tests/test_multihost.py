"""Multi-host (2-process) distribution test — SURVEY §5.8 / VERDICT item 5.

Two subprocesses, 4 virtual CPU devices each, joined by
`jax.distributed.initialize` into one 8-device mesh; the distributed BA's
psum-reduced camera system crosses the process boundary. Launch recipe =
the one documented in sphericalsfm_tpu/parallel/multihost.py.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_ba(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_multihost_worker.py")
    port = _free_port()

    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            SPHERICALSFM_COORDINATOR=f"127.0.0.1:{port}",
            SPHERICALSFM_NUM_PROCESSES="2",
            SPHERICALSFM_PROCESS_ID=str(pid),
            PYTHONPATH=repo,
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, worker, str(out)],
                env=env, cwd=repo,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=500)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout.decode(errors="replace"))
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-3000:]

    res = [json.load(open(o)) for o in outs]
    for pid, r in enumerate(res):
        assert r["distributed"] is True
        assert r["process_index"] == pid
        assert r["num_devices"] == 8
        assert r["num_local_devices"] == 4

    # both controllers must agree bitwise on the replicated result
    assert res[0]["cost"] == res[1]["cost"]
    np.testing.assert_array_equal(res[0]["cam_r"], res[1]["cam_r"])
    # PCG camera solve across the process boundary: bitwise-identical
    # controllers and the same optimum as the dense solve
    assert res[0]["cost_pcg"] == res[1]["cost_pcg"]
    np.testing.assert_allclose(
        res[0]["cost_pcg"], res[0]["cost"], rtol=1e-6, atol=1e-18
    )

    # and match the single-process result on the same problem
    sys.path.insert(0, os.path.join(repo, "tests"))
    import _multihost_worker as w
    from sphericalsfm_tpu.optim.ba import bundle_adjust

    p_single = w.build_problem()
    ref = bundle_adjust(p_single, max_iters=12, solve_dtype_name="float32")
    np.testing.assert_allclose(res[0]["cost"], float(ref.cost), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(res[0]["cam_r"]), np.asarray(ref.cam_r), atol=1e-6
    )
