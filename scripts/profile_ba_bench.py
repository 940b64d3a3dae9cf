"""Time the 64-camera BA scene (`eval.synthetic.make_bench_scene`, the
scene bench.py uses) under each camera solver x matmul precision, plus the
size of its observation-pair table.

Usage: python scripts/profile_ba_bench.py [solver ...]
"""

import os
import sys
import time

os.environ.setdefault("SPHERICALSFM_TPU_X64", "0")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402

from sphericalsfm_tpu.eval.synthetic import make_bench_scene  # noqa: E402
from sphericalsfm_tpu.optim.ba import (  # noqa: E402
    bundle_adjust, count_cc_pairs, sort_obs_by_camera,
)


def run(prob, solver, prec, iters=20):
    kw = dict(max_iters=iters, solve_dtype_name="float32",
              camera_solver=solver, matmul_precision=prec)
    if solver == "pcg":
        kw.update(pcg_rtol=1e-2, pcg_iters=25)
    res = bundle_adjust(prob, **kw)
    jax.block_until_ready(res.points)
    t0 = time.perf_counter()
    res = bundle_adjust(prob, **kw)
    jax.block_until_ready(res.points)
    dt = time.perf_counter() - t0
    cost = float(res.cost)
    return int(res.iterations) / dt, cost, int(res.iterations)


def main():
    print("device:", jax.devices()[0])
    prob = make_bench_scene()
    sp = sort_obs_by_camera(prob)
    print("cc_pairs:", count_cc_pairs(sp))
    solvers = sys.argv[1:] or ["dense_pairs", "dense", "pcg"]
    for solver in solvers:
        for prec in ("highest", "default"):
            ips, cost, it = run(prob, solver, prec)
            print(f"solver={solver:12s} prec={prec:8s} "
                  f"iters/s={ips:7.2f} cost={cost:.6g} iters={it}", flush=True)


if __name__ == "__main__":
    main()
