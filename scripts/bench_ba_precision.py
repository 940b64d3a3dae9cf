"""Measure BA matmul-precision modes: HIGHEST vs HIGH (and DEFAULT).

The LM loop traces under `default_matmul_precision("highest")` because
reduced-precision matmul inputs stall LM above the optimum near
convergence (docs/NUMERICS.md). A cheaper mode (TF32 on the GPU) may be
enough for the Hessian contractions. This script answers that
empirically: per-LM-iteration wall time and reached cost
for each mode on ring scenes at the dense_pairs and PCG scales.

Usage: python scripts/bench_ba_precision.py [C W P]
(with C W P given, only that one scene is swept; default sweeps all three)
"""

import os
import sys
import time

os.environ.setdefault("SPHERICALSFM_TPU_X64", "0")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from sphericalsfm_tpu.eval.synthetic import make_ring_scene  # noqa: E402
from sphericalsfm_tpu.optim.ba import bundle_adjust  # noqa: E402


def run(prob, prec, iters, **kw):
    res = bundle_adjust(prob, max_iters=iters, matmul_precision=prec,
                        solve_dtype_name="float32", ftol=1e-14, **kw)
    float(res.cost)  # warm (compile)
    t0 = time.perf_counter()
    res = bundle_adjust(prob, max_iters=iters, matmul_precision=prec,
                        solve_dtype_name="float32", ftol=1e-14, **kw)
    cost = float(res.cost)
    dt = time.perf_counter() - t0
    return int(res.iterations) / dt, cost, int(res.iterations)


def main():
    print("device:", jax.devices()[0])
    if len(sys.argv) >= 4:
        C, W, P = (int(a) for a in sys.argv[1:4])
        kw = (dict(camera_solver="pcg", pcg_rtol=1e-2, pcg_iters=25)
              if C > 512 else {})
        scenes = [(f"C={C}", dict(C=C, W=W, P=P), kw, 30 if C <= 512 else 10)]
    else:
        scenes = [
            ("dense_pairs C=64", dict(C=64, W=680, P=8192), dict(), 30),
            ("dense_pairs C=256", dict(C=256, W=560, P=32768), dict(), 30),
            ("pcg C=2000", dict(C=2000, W=520, P=131072),
             dict(camera_solver="pcg", pcg_rtol=1e-2, pcg_iters=25), 10),
        ]
    for name, sk, kw, iters in scenes:
        prob = make_ring_scene(**sk)
        K = int(np.count_nonzero(np.asarray(prob.obs_w)))
        for prec in ("highest", "high", "default"):
            ips, cost, it = run(prob, prec, iters, **kw)
            print(f"{name:20s} obs={K:8d} prec={prec:8s} "
                  f"iters/s={ips:7.2f} reached_cost={cost:.6g} iters={it}",
                  flush=True)


if __name__ == "__main__":
    main()
