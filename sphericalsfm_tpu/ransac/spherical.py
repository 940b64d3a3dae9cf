"""Spherical essential-matrix RANSAC: batched hypothesize-score-refine.

Capability parity with the reference's SphericalEstimator + LO-MSAC stack
(/root/reference/src/spherical_estimator.cpp:23-164 and
include/RansacLib/ransac.h:121-275): 3-pt minimal solves, Sampson-error MSAC
scoring, and a final least-squares refinement of the relative rotation with
the translation pinned to the spherical constraint t = (0,0,∓1) — the
reference does this with Ceres on SO(3) (spherical_estimator.cpp:110-157); we
run a damped Gauss-Newton on the same cost under `lax.while_loop`.

Everything is fixed-shape: M hypotheses solved in one vmapped batch, scored
against all N (padded, masked) correspondences in one contraction.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.essential import (
    decompose_spherical_essential,
    make_spherical_essential,
)
from ..geometry.so3 import so3_exp
from ..optim.lm import levenberg_marquardt
from ..solvers.spherical import solve_spherical_3pt
from .engine import best_model, msac_score, sample_tuples


def sampson_error(E: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Squared Sampson epipolar error of vᵀEu (reference:
    spherical_estimator.cpp:67-78). Broadcasts: E (..., 3, 3), u/v (..., N, 3)
    -> (..., N)."""
    Eu = jnp.einsum("...ij,...nj->...ni", E, u)
    Etv = jnp.einsum("...ji,...nj->...ni", E, v)
    d = jnp.sum(v * Eu, axis=-1)
    denom = (
        Eu[..., 0] ** 2 + Eu[..., 1] ** 2 + Etv[..., 0] ** 2 + Etv[..., 1] ** 2
    )
    denom = jnp.where(denom > 1e-30, denom, 1e-30)
    return (d * d) / denom


class SphericalRansacResult(NamedTuple):
    E: jnp.ndarray           # (3, 3) best essential matrix
    r: jnp.ndarray           # (3,) relative rotation (axis-angle)
    t: jnp.ndarray           # (3,) spherical translation
    score: jnp.ndarray       # MSAC score
    inlier_mask: jnp.ndarray  # (N,) bool
    num_inliers: jnp.ndarray  # scalar int


def _refine_rotation(
    r0: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    weights: jnp.ndarray,
    inward: bool,
    max_iters: int,
):
    """Least-squares polish of the relative rotation on the Sampson cost.

    Mirrors the reference's final least squares: residual_i is the *squared*
    Sampson error (the reference feeds d²/denom to Ceres as the residual,
    spherical_estimator.cpp:61), translation fixed at (0,0,∓1) so
    E(r) = [t_sph(exp r)]ₓ exp(r).
    """

    def residual(r):
        E = make_spherical_essential(so3_exp(r), inward=inward)
        return sampson_error(E, u, v)

    res = levenberg_marquardt(
        residual, r0, mask=weights, max_iters=max_iters, init_lambda=1e-6
    )
    return res.x


@partial(
    jax.jit,
    static_argnames=(
        "num_hypotheses",
        "inward",
        "final_least_squares",
        "lo_rounds",
        "nonminimal_size",
        "refine_iters",
    ),
)
def spherical_ransac(
    key: jax.Array,
    u: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray,
    sq_thresh: jnp.ndarray,
    num_hypotheses: int = 1024,
    inward: bool = False,
    final_least_squares: bool = True,
    lo_rounds: int = 0,
    nonminimal_size: int = 9,
    refine_iters: int = 25,
) -> SphericalRansacResult:
    """Estimate the spherical essential matrix of one correspondence set.

    u, v: (N, 3) rays (padded); mask: (N,) validity; sq_thresh: squared
    Sampson inlier threshold in normalized units (the reference scales the
    pixel threshold by K⁻¹₀₀: spherical_sfm_tools.cpp:315).

    vmap over a leading pair axis to process many image pairs at once.
    """
    with jax.default_matmul_precision("highest"):
        return _spherical_ransac_body(
            key, u, v, mask, sq_thresh, num_hypotheses, inward,
            final_least_squares, lo_rounds, nonminimal_size, refine_iters,
        )


def _spherical_ransac_body(
    key, u, v, mask, sq_thresh, num_hypotheses, inward,
    final_least_squares, lo_rounds, nonminimal_size, refine_iters,
) -> SphericalRansacResult:
    # The whole hypothesize-score-refine chain traces under HIGHEST matmul
    # precision: bf16 matmul-input rounding (the default on the chip this
    # was first built for) put a ~4e-2 deg floor under the refined rotation
    # on the 1 px bench sweep (scripts/bench_ransac_adaptive.py); the 3x3
    # contractions here are tiny, so HIGHEST costs little.
    k_sample, k_lo = jax.random.split(key)
    triples = sample_tuples(k_sample, mask, num_hypotheses, 3)  # (M, 3)
    u3 = u[triples]  # (M, 3, 3)
    v3 = v[triples]
    Es, valid = solve_spherical_3pt(u3, v3)  # (M, 4, 3, 3), (M, 4)
    Es = Es.reshape(-1, 3, 3)
    valid = valid.reshape(-1)

    errs = sampson_error(Es[:, None], u[None], v[None])[:, 0]  # (4M, N)
    best, score, inliers = best_model(errs, valid, sq_thresh, mask)
    E_best = Es[best]

    # Local optimization: non-minimal refits from inlier samples
    # (RansacLib's LO step, ransac.h:341-407, with the solver reused as the
    # non-minimal solver like SphericalEstimator::NonMinimalSolver).
    for round_idx in range(lo_rounds):
        k_lo, k_round = jax.random.split(k_lo)
        nm_idx = sample_tuples(k_round, inliers, 1, nonminimal_size)[0]
        E_nm, valid_nm = solve_spherical_3pt(u[nm_idx], v[nm_idx])
        errs_nm = sampson_error(E_nm[:, None], u[None], v[None])[:, 0]
        b_nm, score_nm, inl_nm = best_model(errs_nm, valid_nm, sq_thresh, mask)
        better = score_nm < score
        E_best = jnp.where(better, E_nm[b_nm], E_best)
        score = jnp.where(better, score_nm, score)
        inliers = jnp.where(better, inl_nm, inliers)

    r, t = decompose_spherical_essential(E_best, inward=inward)

    if final_least_squares:
        w = inliers.astype(u.dtype)
        r_ref = _refine_rotation(r, u, v, w, inward, refine_iters)
        E_ref = make_spherical_essential(so3_exp(r_ref), inward=inward)
        errs_ref = sampson_error(E_ref, u, v)
        score_ref = msac_score(errs_ref, sq_thresh, mask)
        better = score_ref < score
        E_best = jnp.where(better, E_ref, E_best)
        score = jnp.where(better, score_ref, score)
        inliers = jnp.where(better, (errs_ref < sq_thresh) & mask, inliers)
        r, t = decompose_spherical_essential(E_best, inward=inward)

    return SphericalRansacResult(
        E=E_best,
        r=r,
        t=t,
        score=score,
        inlier_mask=inliers,
        num_inliers=jnp.sum(inliers),
    )


@partial(
    jax.jit,
    static_argnames=(
        "round_size", "max_rounds", "confidence", "inward",
        "final_least_squares", "refine_iters", "min_rounds", "lo_rounds",
        "nonminimal_size",
    ),
)
def spherical_ransac_adaptive(
    key: jax.Array,
    u: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray,
    sq_thresh: jnp.ndarray,
    round_size: int = 128,
    max_rounds: int = 8,
    confidence: float = 0.99,
    inward: bool = False,
    final_least_squares: bool = True,
    refine_iters: int = 25,
    min_rounds: int = 2,
    lo_rounds: int = 2,
    nonminimal_size: int = 21,
) -> SphericalRansacResult:
    """Adaptive round-based spherical RANSAC.

    Hypotheses are generated in rounds of `round_size`; after each round the
    RansacLib termination bound — iterations needed so an all-inlier minimal
    triple was drawn with `confidence`, log(1−p)/log(1−ρ³) recomputed from
    the best inlier ratio (ransac.h:158-240, utils.h:110-140) — decides
    device-side whether another round runs. Under `vmap` the while_loop runs
    until every lane in the batch is finished, so a chunk of easy high-inlier
    pairs stops after one round instead of burning the full static budget
    (the static engine always spends round_size × max_rounds).

    `min_rounds` forces that many rounds before the bound may fire, and
    `lo_rounds` non-minimal inlier refits of the winner run after the loop
    (RansacLib's LO step, ransac.h:341-407; 7×-sample-size non-minimal
    samples like its min_sample_multiplicator) — together they close the
    accuracy gap the early exit opens against the static engine (the bound
    guarantees an all-inlier SAMPLE was drawn, not that the best-of-few
    model is as sharp as a best-of-many). The defaults (min_rounds=2,
    lo=2) were chosen on another chip with scripts/bench_ransac_adaptive.py
    (1 px / 256-corr sweep): median error within 8% of the static 512-
    hypothesis engine (statistical parity under 30% outliers). Their speed
    trade-off waits for re-measurement on the GPU (ROADMAP 3.3).
    """
    with jax.default_matmul_precision("highest"):
        return _spherical_ransac_adaptive_body(
            key, u, v, mask, sq_thresh, round_size, max_rounds, confidence,
            inward, final_least_squares, refine_iters, min_rounds,
            lo_rounds, nonminimal_size,
        )


def _spherical_ransac_adaptive_body(
    key, u, v, mask, sq_thresh, round_size, max_rounds, confidence,
    inward, final_least_squares, refine_iters, min_rounds, lo_rounds,
    nonminimal_size,
) -> SphericalRansacResult:
    # HIGHEST matmul precision for the same reason as the static engine
    # (see _spherical_ransac_body): the bf16 default put a ~4e-2 deg floor
    # under the refined rotation.
    import math

    n_valid = jnp.maximum(jnp.sum(mask), 3)
    log1mp = math.log(max(1.0 - confidence, 1e-12))

    def hyps_needed(inliers):
        rho = jnp.sum(inliers) / n_valid
        w3 = jnp.clip(rho, 0.0, 1.0) ** 3
        denom = jnp.log1p(-jnp.minimum(w3, 1.0 - 1e-9))
        return jnp.where(w3 > 0, log1mp / denom, jnp.inf)

    dtype = u.dtype

    def body(s):
        k, E_best, score, inliers, done_h, rnd = s
        k, kr = jax.random.split(k)
        triples = sample_tuples(kr, mask, round_size, 3)
        Es, valid = solve_spherical_3pt(u[triples], v[triples])
        Es = Es.reshape(-1, 3, 3)
        valid = valid.reshape(-1)
        errs = sampson_error(Es[:, None], u[None], v[None])[:, 0]
        b, sc, inl = best_model(errs, valid, sq_thresh, mask)
        better = sc < score
        E_best = jnp.where(better, Es[b], E_best)
        score = jnp.where(better, sc, score)
        inliers = jnp.where(better, inl, inliers)
        return k, E_best, score, inliers, done_h + round_size, rnd + 1

    def cond(s):
        _, _, _, inliers, done_h, rnd = s
        return (rnd < max_rounds) & (
            (rnd < min_rounds) | (done_h < hyps_needed(inliers))
        )

    state0 = (
        key,
        jnp.zeros((3, 3), dtype),
        jnp.asarray(jnp.inf, dtype),
        jnp.zeros(mask.shape, bool),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    k_lo, E_best, score, inliers, *_ = jax.lax.while_loop(cond, body, state0)

    for _ in range(lo_rounds):
        k_lo, k_round = jax.random.split(k_lo)
        nm_idx = sample_tuples(k_round, inliers, 1, nonminimal_size)[0]
        E_nm, valid_nm = solve_spherical_3pt(u[nm_idx], v[nm_idx])
        errs_nm = sampson_error(E_nm[:, None], u[None], v[None])[:, 0]
        b_nm, score_nm, inl_nm = best_model(errs_nm, valid_nm, sq_thresh, mask)
        better = score_nm < score
        E_best = jnp.where(better, E_nm[b_nm], E_best)
        score = jnp.where(better, score_nm, score)
        inliers = jnp.where(better, inl_nm, inliers)

    r, t = decompose_spherical_essential(E_best, inward=inward)
    if final_least_squares:
        w = inliers.astype(dtype)
        r_ref = _refine_rotation(r, u, v, w, inward, refine_iters)
        E_ref = make_spherical_essential(so3_exp(r_ref), inward=inward)
        errs_ref = sampson_error(E_ref, u, v)
        score_ref = msac_score(errs_ref, sq_thresh, mask)
        better = score_ref < score
        E_best = jnp.where(better, E_ref, E_best)
        score = jnp.where(better, score_ref, score)
        inliers = jnp.where(better, (errs_ref < sq_thresh) & mask, inliers)
        r, t = decompose_spherical_essential(E_best, inward=inward)

    return SphericalRansacResult(
        E=E_best,
        r=r,
        t=t,
        score=score,
        inlier_mask=inliers,
        num_inliers=jnp.sum(inliers),
    )
