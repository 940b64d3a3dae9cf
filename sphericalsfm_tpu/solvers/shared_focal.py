"""Six-point shared-focal relative pose — focal-sweep elimination solver.

Capability parity with the reference's SixPointEstimator
(/root/reference/examples/six_point_estimator.{h,cpp}), which wraps PoseLib's
Gröbner-basis `relpose_6pt_shared_focal` (built but not called by any driver
— an available capability). Same API role: 6 pixel correspondences with an
unknown shared focal length → candidate (E, f) pairs.

Different (eigensolver-free) derivation: with 6 epipolar constraints the
fundamental matrix has a 3-dim nullspace F(x, y) = x·F₁ + y·F₂ + F₃. For a
*fixed* focal f (K² = diag(f², f², 1)) the essentiality of E = K F K is
equivalent to 2·F K² Fᵀ K² F − tr(K² F K² Fᵀ)·F = 0 plus det F = 0 — ten
cubics in (x, y) whose 10×10 coefficient matrix is built by the same
fixed-node polynomial interpolation as the 3-pt solver and eliminated to a
quartic. The true focal values are where this per-focal system becomes
consistent, so the solver sweeps a log-spaced focal grid (one extra vmap
axis), scores each candidate by its Demazure residual, polishes the focal by
a golden-section step, and returns the best candidates. Fully batched and
jittable on any backend (no general eigensolver).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry.essential import essential_params
from .quartic import solve_quartic
from .spherical import _VAND_INV_T, _NODES

_HI = jax.lax.Precision.HIGHEST


def _fundamental_rows(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """vᵀ F u = 0 rows over row-major F params. (..., N, 9)."""
    uu = u[..., None, :]
    vv = v[..., :, None]
    return (vv * uu).reshape(u.shape[:-1] + (9,))


def _nullspace3_of9(A: jnp.ndarray) -> jnp.ndarray:
    """(..., 6, 9) -> (..., 9, 3) exact complement via eigh (6 rows, rank 6)."""
    AtA = jnp.einsum("...ni,...nj->...ij", A, A, precision=_HI)
    _, V = jnp.linalg.eigh(AtA)
    return V[..., :, :3]


def _demazure_residual(E: jnp.ndarray) -> jnp.ndarray:
    Et = jnp.swapaxes(E, -1, -2)
    EEt = E @ Et
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    nrm = jnp.linalg.norm(E, axis=(-2, -1))
    nrm3 = jnp.maximum(nrm**3, 1e-30)
    return (
        jnp.linalg.norm(T, axis=(-2, -1)) + jnp.abs(jnp.linalg.det(E))
    ) / nrm3


def _shared_focal_constraints(F: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """The ten per-focal essentiality constraints of F at w = f²."""
    K2 = jnp.stack([w, w, jnp.ones_like(w)], axis=-1)
    FK2 = F * K2[..., None, :]         # F @ diag
    M = FK2 @ jnp.swapaxes(F, -1, -2)  # F K² Fᵀ
    MK2 = M * K2[..., None, :]
    T = 2.0 * (MK2 @ F) - (
        MK2[..., 0, 0] + MK2[..., 1, 1] + MK2[..., 2, 2]
    )[..., None, None] * F
    detF = jnp.broadcast_to(jnp.linalg.det(F), T.shape[:-2])
    return jnp.concatenate(
        [T.reshape(T.shape[:-2] + (9,)), detF[..., None]], axis=-1
    )


def _solve_at_focal(B: jnp.ndarray, w: jnp.ndarray):
    """Candidate (x, y) roots of the per-focal system.

    B: (..., 9, 3) nullspace; w: (...,) squared focal. Returns
    xy (..., 4, 2) candidates.
    """
    dtype = B.dtype
    nodes = jnp.asarray(_NODES, dtype)
    xyz = jnp.concatenate([nodes, jnp.ones((10, 1), dtype)], axis=-1)
    p_nodes = jnp.einsum("...ij,nj->...ni", B, xyz, precision=_HI)
    F_nodes = p_nodes.reshape(p_nodes.shape[:-1] + (3, 3))
    g = _shared_focal_constraints(F_nodes, w[..., None])  # (..., 10, 10)
    g = jnp.swapaxes(g, -1, -2)
    C = jnp.einsum(
        "...en,nm->...em", g, jnp.asarray(_VAND_INV_T, dtype), precision=_HI
    )
    C1 = C[..., :, :6]
    C2 = C[..., :, 6:]
    C1tC1 = jnp.einsum("...ki,...kj->...ij", C1, C1, precision=_HI)
    C1tC2 = jnp.einsum("...ki,...kj->...ij", C1, C2, precision=_HI)
    L = jnp.linalg.cholesky(
        C1tC1 + 1e-14 * jnp.eye(6, dtype=dtype)
    )
    y_ = jax.scipy.linalg.solve_triangular(L, C1tC2, lower=True)
    G = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y_, lower=False
    )
    g5 = G[..., 5, :]
    g4 = G[..., 4, :]
    roots, _ = solve_quartic(
        g5[..., 0], g5[..., 1] - g4[..., 0], g5[..., 2] - g4[..., 1],
        g5[..., 3] - g4[..., 2], -g4[..., 3],
    )
    y = roots
    x = -(
        g5[..., None, 0] * y**3 + g5[..., None, 1] * y * y
        + g5[..., None, 2] * y + g5[..., None, 3]
    )
    return jnp.stack([x, y], axis=-1)  # (..., 4, 2)


def _coefficient_matrix(B: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """The 10×10 per-focal cubic coefficient matrix C(w) by interpolation.

    B: (..., 9, 3) nullspace; w: (...,) squared focal (broadcast over B's
    batch). At the true focal C is rank-deficient (solutions exist); away
    from it σ_min(C) is O(1) — the focal discriminator.
    """
    dtype = B.dtype
    nodes = jnp.asarray(_NODES, dtype)
    xyz = jnp.concatenate([nodes, jnp.ones((10, 1), dtype)], axis=-1)
    p_nodes = jnp.einsum("...ij,nj->...ni", B, xyz, precision=_HI)
    F_nodes = p_nodes.reshape(p_nodes.shape[:-1] + (3, 3))
    g = _shared_focal_constraints(F_nodes, w[..., None])  # (..., 10, 10)
    g = jnp.swapaxes(g, -1, -2)
    C = jnp.einsum(
        "...en,nm->...em", g, jnp.asarray(_VAND_INV_T, dtype), precision=_HI
    )
    return C / jnp.maximum(
        jnp.linalg.norm(C, axis=(-2, -1), keepdims=True), 1e-30
    )


def _sigma_min(C: jnp.ndarray) -> jnp.ndarray:
    from ..ops.linalg import sigma_min_small

    return sigma_min_small(C)


@partial(jax.jit, static_argnames=("num_focal_samples", "polish_steps"))
def solve_shared_focal_6pt(
    u: jnp.ndarray,
    v: jnp.ndarray,
    min_focal: float = 0.3,
    max_focal: float = 3.0,
    num_focal_samples: int = 64,
    polish_steps: int = 12,
):
    """Relative pose + shared focal from ≥6 correspondences.

    u, v: (..., N, 3) rays normalized by a *nominal* focal guess; the
    returned focal is the multiplier on that guess in [min_focal, max_focal].

    Returns (Es (..., 12, 3, 3) calibrated-frame essential candidates,
    valid (..., 12), focal (..., 12)): four elimination roots at each of the
    three best-separated minima of σ_min(C(f)) (the problem has up to 15
    solutions spread over focal values; downstream RANSAC scoring picks the
    consistent one). σ_min(C(f)) drops to machine zero exactly where the
    per-focal cubic system becomes consistent — the focal discriminator.
    """
    dtype = u.dtype
    # Trace the WHOLE solver under HIGHEST matmul precision: the eigh/svd/
    # cholesky/triangular-solve internals below run default-precision
    # matmuls otherwise, and a backend's default may round f32 inputs
    # (bf16 on the chip this was first built for, TF32 on the GPU) — with
    # bf16 inputs the median focal error went from 6% to 38% (the per-einsum
    # precision=_HI tags cover only the explicit contractions).
    with jax.default_matmul_precision("highest"):
        return _solve_shared_focal_6pt_body(
            u, v, min_focal, max_focal, num_focal_samples, polish_steps)


def _solve_shared_focal_6pt_body(u, v, min_focal, max_focal,
                                 num_focal_samples, polish_steps):
    dtype = u.dtype
    A = _fundamental_rows(u, v)
    B = _nullspace3_of9(A)  # (..., 9, 3)
    batch = B.shape[:-2]

    log_lo = jnp.log(jnp.asarray(min_focal, dtype))
    log_hi = jnp.log(jnp.asarray(max_focal, dtype))
    grid = jnp.exp(jnp.linspace(log_lo, log_hi, num_focal_samples))

    def sig_at(f):
        return _sigma_min(_coefficient_matrix(B, jnp.broadcast_to(f * f, batch)))

    sig_all = jax.vmap(sig_at, out_axes=-1)(grid)  # (..., S)

    # The 6-pt shared-focal problem has up to 15 solutions, typically spread
    # over several focal values — keep the best 3 well-separated minima
    # (masked argmin with a ±3-cell exclusion window) and refine each.
    NMIN = 3
    sig_work = sig_all
    idxs = []
    cell = jnp.arange(num_focal_samples)
    for _ in range(NMIN):
        b = jnp.argmin(sig_work, axis=-1)
        idxs.append(b)
        excl = jnp.abs(cell[None, :] - b[..., None]) <= 3
        sig_work = jnp.where(excl.reshape(sig_work.shape), jnp.inf, sig_work)
    f_cands = jnp.stack([grid[b] for b in idxs], axis=-1)  # (..., NMIN)
    s_cands = jnp.stack(
        [jnp.take_along_axis(sig_all, b[..., None], axis=-1)[..., 0] for b in idxs],
        axis=-1,
    )

    # Golden-section-style shrink around each minimum on log f.
    step0 = (log_hi - log_lo) / (num_focal_samples - 1)
    half = jnp.full(batch + (NMIN,), step0, dtype)
    f_best = f_cands
    s_best = s_cands
    Bx = B[..., None, :, :]  # broadcast over the NMIN axis

    for _ in range(polish_steps):
        f_lo = f_best * jnp.exp(-half)
        f_hi = f_best * jnp.exp(half)
        s_lo = _sigma_min(_coefficient_matrix(Bx, f_lo * f_lo))
        s_hi = _sigma_min(_coefficient_matrix(Bx, f_hi * f_hi))
        pick_lo = (s_lo < s_best) & (s_lo <= s_hi)
        pick_hi = (s_hi < s_best) & (s_hi < s_lo)
        f_best = jnp.where(pick_lo, f_lo, jnp.where(pick_hi, f_hi, f_best))
        s_best = jnp.minimum(s_best, jnp.minimum(s_lo, s_hi))
        half = half * 0.6

    # Solve the (consistent) per-focal systems: 4 roots per focal minimum.
    xy = _solve_at_focal(Bx, f_best * f_best)  # (..., NMIN, 4, 2)
    ones = jnp.ones(xy.shape[:-1] + (1,), dtype)
    coef = jnp.concatenate([xy, ones], axis=-1)
    F = jnp.einsum("...ij,...mkj->...mki", B, coef).reshape(
        xy.shape[:-1] + (3, 3)
    )
    K = jnp.stack([f_best, f_best, jnp.ones_like(f_best)], axis=-1)
    K2 = (K[..., :, None] * K[..., None, :])[..., None, :, :]
    # E = K F K *is* the calibrated-frame essential matrix (x_pixᵀ F x_pix =
    # x_calᵀ (K F K) x_cal with x_cal = K⁻¹ x_pix).
    Es = F * K2                              # (..., NMIN, 4, 3, 3)
    focals_out = jnp.broadcast_to(f_best[..., None], xy.shape[:-1])
    Es = Es.reshape(batch + (NMIN * 4, 3, 3))
    focals_out = focals_out.reshape(batch + (NMIN * 4,))
    nrm = jnp.linalg.norm(Es, axis=(-2, -1), keepdims=True)
    valid = jnp.isfinite(nrm[..., 0, 0]) & (nrm[..., 0, 0] > 1e-12)
    Es = Es / jnp.where(valid[..., None, None], nrm, 1.0)
    Es = jnp.where(valid[..., None, None], Es, jnp.zeros_like(Es))
    return Es, valid, focals_out
