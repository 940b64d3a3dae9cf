"""RANSAC triangulation — per-point, batched over the whole map.

Capability parity with the reference's TriangulationEstimator + Retriangulate
(/root/reference/src/triangulation_estimator.cpp:46-127, sfm.cpp:156-192):
2-view minimal DLT, all-view non-minimal DLT, reprojection-error scoring with
cheirality rejection, and least-squares refinement. The reference runs an
independent LO-MSAC per point inside `cv::parallel_for_`; here the *entire
map* retriangulates as one vmapped fixed-shape kernel: observations are
bucketed per point into a padded (max_track, ...) table.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.so3 import so3_exp
from ..ops.linalg import inv3x3
from ..optim.lm import levenberg_marquardt
from .engine import best_model, sample_tuples

_BIG = 1e18


def triangulate_midpoint(
    Rs: jnp.ndarray,      # (V, 3, 3) world->camera rotations
    ts: jnp.ndarray,      # (V, 3)
    obs: jnp.ndarray,     # (V, 2) principal-point-centered pixels
    focal: jnp.ndarray,   # scalar
) -> jnp.ndarray:
    """Closed-form least-squares ray intersection (generalized midpoint).

    Minimizes Σᵥ ‖(I − dᵥdᵥᵀ)(X − Cᵥ)‖² over X, where dᵥ is the unit viewing
    ray of view v in world coordinates and Cᵥ its camera center — a 3×3
    normal system solved with the adjugate inverse. Pure elementwise
    arithmetic: unlike the DLT (4×4 eigendecomposition per hypothesis) this
    is cheap on any device, so it is the minimal-sample hypothesis generator
    inside the RANSAC loop; the DLT refit + LM polish still produce the
    final estimate. Near-parallel rays yield a near-singular system whose
    garbage candidate is rejected by MSAC scoring (the engine's fixed-shape
    degeneracy policy).
    """
    d_cam = jnp.concatenate(
        [obs / focal, jnp.ones(obs.shape[:-1] + (1,), obs.dtype)], axis=-1
    )
    d = jnp.einsum("...ji,...j->...i", Rs, d_cam)          # Rᵀ · ray
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    C = -jnp.einsum("...ji,...j->...i", Rs, ts)            # camera centers
    eye = jnp.eye(3, dtype=obs.dtype)
    Pm = eye - d[..., :, None] * d[..., None, :]           # (V, 3, 3)
    A = jnp.sum(Pm, axis=-3) + 1e-9 * eye
    b = jnp.sum(jnp.einsum("...ij,...j->...i", Pm, C), axis=-2)
    return jnp.einsum("ij,j->i", inv3x3(A), b)


def triangulate_dlt(
    Rs: jnp.ndarray,      # (T, 3, 3) world->camera rotations
    ts: jnp.ndarray,      # (T, 3)
    obs: jnp.ndarray,     # (T, 2) principal-point-centered pixels
    focal: jnp.ndarray,   # scalar
    weights: jnp.ndarray,  # (T,) 0/1 selection of observations
) -> jnp.ndarray:
    """Weighted homogeneous DLT over selected observations -> (3,) point.

    Rows per observation: x̂·P₂ − P₀ and ŷ·P₂ − P₁ with (x̂, ŷ) = obs/focal
    and P = [R | t] (reference: triangulation_estimator.cpp:65-86). The 4-dim
    normal matrix AᵀA is formed with weights so padded rows vanish; the point
    is the smallest eigenvector, dehomogenized.
    """
    P = jnp.concatenate([Rs, ts[..., :, None]], axis=-1)  # (T, 3, 4)
    xy = obs / focal
    rows_x = xy[..., 0:1] * P[..., 2, :] - P[..., 0, :]  # (T, 4)
    rows_y = xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = jnp.concatenate([rows_x, rows_y], axis=-2)  # (2T, 4)
    w = jnp.concatenate([weights, weights], axis=-1)
    AtA = jnp.einsum("ni,nj,n->ij", A, A, w)
    _, V = jnp.linalg.eigh(AtA)
    Xh = V[:, 0]
    wcoord = jnp.where(jnp.abs(Xh[3]) > 1e-15, Xh[3], 1e-15)
    return Xh[:3] / wcoord


def reprojection_sq_error(
    X: jnp.ndarray, Rs: jnp.ndarray, ts: jnp.ndarray, obs: jnp.ndarray, focal
) -> jnp.ndarray:
    """Squared reprojection error per observation; cheirality violations → BIG
    (reference: triangulation_estimator.cpp:46-54)."""
    PX = jnp.einsum("...ij,j->...i", Rs, X) + ts
    z = PX[..., 2]
    proj = focal * PX[..., :2] / jnp.where(jnp.abs(z) > 1e-15, z, 1e-15)[..., None]
    err = jnp.sum((proj - obs) ** 2, axis=-1)
    return jnp.where(z > 0, err, _BIG)


class TriangulationResult(NamedTuple):
    X: jnp.ndarray            # (3,) triangulated point (zeros if failed)
    num_inliers: jnp.ndarray  # scalar
    ok: jnp.ndarray           # bool: ≥3 inliers


@partial(jax.jit, static_argnames=("num_hypotheses", "refine_iters"))
def triangulation_ransac(
    key: jax.Array,
    rs: jnp.ndarray,       # (T, 3) camera axis-angle (padded track)
    ts: jnp.ndarray,       # (T, 3)
    obs: jnp.ndarray,      # (T, 2)
    mask: jnp.ndarray,     # (T,) observation validity
    focal: jnp.ndarray,
    sq_thresh: float = 4.0,
    num_hypotheses: int = 64,
    refine_iters: int = 10,
) -> TriangulationResult:
    """LO-MSAC triangulation of one track; vmap over the point axis.

    Matches Retriangulate's policy (sfm.cpp:174-190): tracks with <3 valid
    observations fail; succeeds only with ≥3 inliers. sq_thresh defaults to
    4 px² like the reference.
    """
    Rs = so3_exp(rs)
    pairs = sample_tuples(key, mask, num_hypotheses, 2)  # (M, 2)

    def solve_pair(pair):
        return triangulate_midpoint(Rs[pair], ts[pair], obs[pair], focal)

    Xs = jax.vmap(solve_pair)(pairs)  # (M, 3)
    errs = jax.vmap(lambda X: reprojection_sq_error(X, Rs, ts, obs, focal))(Xs)
    valid_models = jnp.all(jnp.isfinite(Xs), axis=-1)
    best, score, inliers = best_model(errs, valid_models, sq_thresh, mask)
    X = Xs[best]

    # Non-minimal refit on inliers (LO step) + least-squares polish.
    X_nm = triangulate_dlt(Rs, ts, obs, focal, inliers.astype(rs.dtype))

    def residual(Xp):
        PX = jnp.einsum("tij,j->ti", Rs, Xp) + ts
        z = jnp.where(jnp.abs(PX[:, 2]) > 1e-15, PX[:, 2], 1e-15)
        proj = focal * PX[:, :2] / z[:, None]
        return proj - obs  # (T, 2) blocks

    X_ref = levenberg_marquardt(
        residual, X_nm, mask=inliers.astype(rs.dtype), max_iters=refine_iters
    ).x

    def score_of(Xc):
        e = reprojection_sq_error(Xc, Rs, ts, obs, focal)
        return jnp.sum(jnp.where(mask, jnp.minimum(e, sq_thresh), 0.0)), e

    cands = jnp.stack([X, X_nm, X_ref])
    scores, errs_c = jax.vmap(score_of)(cands)
    scores = jnp.where(jnp.all(jnp.isfinite(cands), axis=-1), scores, jnp.inf)
    pick = jnp.argmin(scores)
    X_final = cands[pick]
    inl_final = (errs_c[pick] < sq_thresh) & mask
    n_inl = jnp.sum(inl_final)
    ok = (n_inl >= 3) & (jnp.sum(mask) >= 3)
    return TriangulationResult(
        X=jnp.where(ok, X_final, jnp.zeros_like(X_final)),
        num_inliers=n_inl,
        ok=ok,
    )
