"""PCG forcing sweep at the e2e driver's regime (C≈256, K≈80k obs).

Compares wall time and reached cost of the PCG camera solve across inner
tolerances/iteration caps, plus the dense solver for reference — the data
behind the driver's pcg_rtol/pcg_iters defaults (inexact Newton: LM steps
don't need tight inner solves; the trust region absorbs the inexactness).

Usage: python scripts/bench_ba_forcing.py [C] [W] [P]
"""

import os
import sys
import time

os.environ.setdefault("SPHERICALSFM_TPU_X64", "0")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sphericalsfm_tpu.eval.synthetic import make_ring_scene  # noqa: E402
from sphericalsfm_tpu.optim.ba import bundle_adjust


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 312
    P = int(sys.argv[3]) if len(sys.argv) > 3 else 16384
    prob = make_ring_scene(C=C, W=W, P=P)
    K = int(np.count_nonzero(np.asarray(prob.obs_w)))
    print(f"scene: {C} cams, {P} pts, {K} obs")

    cases = [
        ("dense", dict(camera_solver="dense")),
        ("pcg rtol=1e-4 cap=100", dict(camera_solver="pcg",
                                       pcg_rtol=1e-4, pcg_iters=100)),
        ("pcg rtol=1e-2 cap=100", dict(camera_solver="pcg",
                                       pcg_rtol=1e-2, pcg_iters=100)),
        ("pcg rtol=1e-1 cap=100", dict(camera_solver="pcg",
                                       pcg_rtol=1e-1, pcg_iters=100)),
        ("pcg rtol=1e-2 cap=25", dict(camera_solver="pcg",
                                      pcg_rtol=1e-2, pcg_iters=25)),
        ("pcg rtol=1e-4 cap=25", dict(camera_solver="pcg",
                                      pcg_rtol=1e-4, pcg_iters=25)),
    ]
    for name, kw in cases:
        kw = dict(kw, solve_dtype_name="float32", ftol=1e-12, max_iters=20)
        try:
            res = bundle_adjust(prob, **kw)
            float(res.cost)  # compile + warm
            t0 = time.perf_counter()
            res = bundle_adjust(prob, **kw)
            cost = float(res.cost)
            dt = time.perf_counter() - t0
            it = int(res.iterations)
            print(f"{name:26s}: {it / dt:6.2f} iters/s "
                  f"({dt / it * 1e3:6.1f} ms/iter), cost {cost:.6g} "
                  f"after {it} iters")
        except Exception as e:
            print(f"{name:26s}: FAILED {e}")


if __name__ == "__main__":
    main()
