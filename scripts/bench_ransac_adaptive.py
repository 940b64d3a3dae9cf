"""Adaptive-RANSAC accuracy/speed sweep vs the static engine.

VERDICT r2 item 4: the adaptive early exit traded 22% median rotation
accuracy (0.056 -> 0.0685 deg) for speed. This sweeps min_rounds / lo_rounds
configurations on the bench.py workload to find the config that holds
within ~5% of static accuracy at >=2x static throughput.

Usage: python scripts/bench_ransac_adaptive.py
"""

import os
import sys
import time

os.environ.setdefault("SPHERICALSFM_TPU_X64", "0")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sphericalsfm_tpu.eval.synthetic import make_random_problems  # noqa: E402
from sphericalsfm_tpu.ransac.spherical import (  # noqa: E402
    spherical_ransac, spherical_ransac_adaptive,
)

PAIRS = 64
CORR = 256
HYPOTHESES = 512
FOCAL = 600.0


def make_data(outlier_frac=0.0):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        prob = make_random_problems(
            jax.random.PRNGKey(0), batch=PAIRS, num_corr=CORR,
            rotation_deg=2.0, point_noise=1.0 / FOCAL, dtype=jnp.float32,
        )
        v = prob.v
        if outlier_frac > 0:
            k1, k2 = jax.random.split(jax.random.PRNGKey(7))
            is_out = jax.random.uniform(k1, prob.u.shape[:-1]) < outlier_frac
            junk = jax.random.normal(k2, v.shape) * 0.5
            junk = junk.at[..., 2].set(1.0)
            v = jnp.where(is_out[..., None], junk, v)
    u = np.asarray(prob.u, np.float32)
    v = np.asarray(v, np.float32)
    m = np.asarray(prob.valid)
    R = np.asarray(prob.R, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), PAIRS)
    return u, v, m, R, np.asarray(keys)


def rot_err_deg_np(r_est, R_gt):
    """Host-side f64 rotation error: sub-0.04 deg angles vanish into the
    f32 acos floor (cos(0.04deg) is ~2 ulps from 1.0f), so the on-device
    f32 metric cannot resolve the accuracy differences measured here."""
    th = np.linalg.norm(r_est, axis=-1, keepdims=True)
    k = r_est / np.maximum(th, 1e-300)
    K = np.zeros(r_est.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    th = th[..., None]
    R_est = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    Rd = np.einsum("...ij,...ik->...jk", R_est, R_gt)
    tr = np.clip((np.trace(Rd, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def bench(fn, device, u, v, m, keys, reps=10, precision=None):
    run = jax.jit(jax.vmap(fn), device=device)
    args = [jax.device_put(x, device) for x in (keys, u, v, m)]
    import contextlib

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:  # applies at trace time
        res = run(*args)
        res.r.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = run(*args)
        res.r.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    return PAIRS / dt, res


def main():
    accel = jax.devices()[0]
    print("device:", accel)
    sq = jnp.float32((2.0 / FOCAL) ** 2)
    for frac in (0.0, 0.3):
        u, v, m, R_gt, keys = make_data(frac)
        configs = [("static512", lambda k, uu, vv, mm: spherical_ransac(
            k, uu, vv, mm, sq_thresh=sq, num_hypotheses=HYPOTHESES))]
        for tag, rs, min_r, lo in (
            ("default(128x4)", 128, 1, 2),
            ("min2", 128, 2, 2),
            ("rounds256x2", 256, 1, 2),
        ):
            configs.append((
                f"adapt[{tag}]",
                lambda k, uu, vv, mm, rs=rs, min_r=min_r, lo=lo:
                spherical_ransac_adaptive(
                    k, uu, vv, mm, sq_thresh=sq, round_size=rs,
                    max_rounds=HYPOTHESES // rs, min_rounds=min_r,
                    lo_rounds=lo,
                ),
            ))
        for name, fn in configs:
            pps, res = bench(fn, accel, u, v, m, keys)
            errs = rot_err_deg_np(np.asarray(res.r, np.float64),
                                  np.asarray(R_gt, np.float64))
            print(f"outliers={frac:.1f} {name:24s} {pps:8.1f} pairs/s  "
                  f"median_rot={np.median(errs):.4f} deg  "
                  f"p90={np.quantile(errs, 0.9):.4f}", flush=True)


if __name__ == "__main__":
    main()
