"""General (5-pt) essential-matrix RANSAC — the non-spherical comparison path.

Capability parity with the reference's estimate_pairwise_five_point
(/root/reference/examples/spherical_sfm_tools.cpp:433-573): LO-MSAC with the
Stewenius-class 5-pt solver and COLMAP-style cheirality disambiguation,
giving each image pair a general relative rotation for the uncalibrated
pipeline's -fivepoint mode. Off the main path: the spherical 3-pt engine is
the production path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.so3 import skew, so3_exp, so3_log
from ..optim.lm import levenberg_marquardt
from ..solvers.five_point import (
    cheirality_best,
    decompose_essential,
    solve_essential_5pt,
)
from .engine import best_model, msac_score, sample_tuples
from .spherical import sampson_error


class GeneralRansacResult(NamedTuple):
    E: jnp.ndarray
    r: jnp.ndarray            # (3,) relative rotation (axis-angle)
    t: jnp.ndarray            # (3,) unit translation
    score: jnp.ndarray
    inlier_mask: jnp.ndarray
    num_inliers: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=(
        "num_hypotheses", "final_least_squares", "refine_iters",
        "solver_method",
    ),
)
def general_essential_ransac(
    key: jax.Array,
    u: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray,
    sq_thresh: jnp.ndarray,
    num_hypotheses: int = 256,
    final_least_squares: bool = True,
    refine_iters: int = 20,
    solver_method: str = "auto",
) -> GeneralRansacResult:
    samples = sample_tuples(key, mask, num_hypotheses, 5)  # (M, 5)
    Es, valid = solve_essential_5pt(
        u[samples], v[samples], method=solver_method
    )  # (M, 10, 3, 3)
    Es = Es.reshape(-1, 3, 3)
    valid = valid.reshape(-1)
    errs = sampson_error(Es[:, None], u[None], v[None])[:, 0]
    best, score, inliers = best_model(errs, valid, sq_thresh, mask)
    E_best = Es[best]

    Rs, ts = decompose_essential(E_best)
    R, t, _ = cheirality_best(Rs, ts, u, v, inliers)
    r = so3_log(R)

    if final_least_squares:
        w = inliers.astype(u.dtype)

        def residual(params):
            rr = params[:3]
            tt = params[3:]
            tt = tt / jnp.maximum(jnp.linalg.norm(tt), 1e-12)
            E = skew(tt) @ so3_exp(rr)
            return sampson_error(E, u, v)

        params0 = jnp.concatenate([r, t])
        res = levenberg_marquardt(
            residual, params0, mask=w, max_iters=refine_iters, init_lambda=1e-6
        )
        r_ref = res.x[:3]
        t_ref = res.x[3:] / jnp.maximum(jnp.linalg.norm(res.x[3:]), 1e-12)
        E_ref = skew(t_ref) @ so3_exp(r_ref)
        errs_ref = sampson_error(E_ref, u, v)
        score_ref = msac_score(errs_ref, sq_thresh, mask)
        better = score_ref < score
        E_best = jnp.where(better, E_ref, E_best)
        score = jnp.where(better, score_ref, score)
        inliers = jnp.where(better, (errs_ref < sq_thresh) & mask, inliers)
        r = jnp.where(better, r_ref, r)
        t = jnp.where(better, t_ref, t)

    return GeneralRansacResult(
        E=E_best, r=r, t=t, score=score, inlier_mask=inliers,
        num_inliers=jnp.sum(inliers),
    )
