"""Large-scale BA benchmark: ≥2000 cameras and ≥1M observations on one
card through the matrix-free PCG Schur solve, on the ring scene of
`eval.synthetic.make_ring_scene`.

Usage: python scripts/bench_ba_scale.py [C] [W] [P]
"""

import os
import sys
import time

os.environ.setdefault("SPHERICALSFM_TPU_X64", "0")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from sphericalsfm_tpu.eval.synthetic import make_ring_scene  # noqa: E402
from sphericalsfm_tpu.optim.ba import bundle_adjust  # noqa: E402


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 520
    P = int(sys.argv[3]) if len(sys.argv) > 3 else 131072
    t0 = time.perf_counter()
    prob = make_ring_scene(C=C, W=W, P=P)
    K = int(np.count_nonzero(np.asarray(prob.obs_w)))
    print(f"scene: {C} cams, {P} pts, {K} obs "
          f"(built in {time.perf_counter()-t0:.1f}s)", flush=True)

    for coarse, rtol, cap in ((0, 1e-2, 25), (0, 1e-2, 12), (0, 1e-4, 100)):
        kw = dict(camera_solver="pcg", solve_dtype_name="float32",
                  pcg_rtol=rtol, pcg_iters=cap, ftol=1e-12,
                  pcg_coarse=coarse)
        t0 = time.perf_counter()
        res = bundle_adjust(prob, max_iters=15, **kw)
        float(res.cost)  # compile and wait for the result
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = bundle_adjust(prob, max_iters=15, **kw)
        cost = float(res.cost)
        t_warm = time.perf_counter() - t0
        it = int(res.iterations)
        rms = np.sqrt(2 * cost / max(K, 1) / 2)
        print(f"coarse={coarse} rtol={rtol} cap={cap}: cold {t_cold:.1f}s; "
              f"warm {it} iters in {t_warm:.2f}s -> {it / t_warm:.2f} "
              f"iters/s  cost {float(res.initial_cost):.4g} -> {cost:.6g} "
              f"rms {rms:.3f}px", flush=True)


if __name__ == "__main__":
    main()
