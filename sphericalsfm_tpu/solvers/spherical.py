"""Three-point spherical essential-matrix solver — batched, interpolation-based.

Capability parity with the reference's two 3-pt minimal solvers
(spherical_solver_action_matrix / spherical_solver_polynomial,
/root/reference/src/spherical_solvers.cpp:102-660), but a different —
batched, eigensolver-free — derivation. The reference carries ~500 lines of
symbolically generated coefficient code (Matlab codegen) and, for the
action-matrix variant, a 4x4 nonsymmetric eigendecomposition.
We instead build the polynomial system *numerically*:

1. A spherical essential matrix has the structure
   E = [[a, b, c], [b, -a, d], [e, f, 0]]  (6 parameters p).
   Each correspondence (u, v) gives one linear equation vᵀE u = 0 in p, so 3
   correspondences leave a 3-dim nullspace basis B (6×3):
   p(x, y) = B @ [x, y, 1].
2. E is essential iff the ten cubic constraints vanish: the nine entries of
   the Demazure matrix 2 E Eᵀ E − tr(E Eᵀ) E plus det E. Each is a cubic in
   (x, y) with 10 monomials. Because all ten cubics vanish on the ≤4 solution
   points, their span has rank ≤ 6 — so the 10×10 coefficient matrix C can be
   *eliminated* exactly like the reference's 6×10 system.
3. Instead of symbolic expansion, C is recovered by polynomial interpolation:
   evaluate the ten constraints at 10 fixed sample points (x_i, y_i) and
   multiply by a precomputed inverse Vandermonde. This is one (10,10)x(10,10)
   matmul per hypothesis — trivially vmappable.
4. Least-squares elimination G = (C₁ᵀC₁)⁻¹ C₁ᵀ C₂ (monomial order
   [x³, x²y, xy², x², xy, x | y³, y², y, 1]) expresses x-monomials in
   y-monomials; rows for `x` and `xy` combine into a quartic in y, solved in
   closed form (Ferrari), and x back-substitutes from the `x` row.

All four candidate roots are returned (real parts; spurious ones score out in
RANSAC, same policy as the reference's SolveQuarticReals). Works for minimal
(N=3) and non-minimal (N>3) samples — the latter replaces step 1's exact
nullspace with the 3 smallest right singular directions of the stacked
constraints, mirroring the reference's use of the same code path for
non-minimal solves.
"""

from __future__ import annotations

import numpy as _np

import jax
import jax.numpy as jnp

from ..geometry.essential import essential_from_params
from .quartic import solve_quartic

# --- fixed interpolation nodes -------------------------------------------------
# Two rings of 5 points; condition number of the Vandermonde ≈ 21.
_NODES = []
for _k in range(10):
    _rad = 1.0 if _k < 5 else 0.6
    _ang = 2.0 * _np.pi * (_k % 5) / 5.0 + (0.31 if _k >= 5 else 0.0)
    _NODES.append((_rad * _np.cos(_ang), _rad * _np.sin(_ang)))
_NODES = _np.asarray(_NODES)  # (10, 2)

# Monomial order: [x³, x²y, xy², x², xy, x, y³, y², y, 1]
def _monomials_np(x, y):
    return _np.stack(
        [x**3, x**2 * y, x * y**2, x**2, x * y, x, y**3, y**2, y, _np.ones_like(x)],
        axis=-1,
    )


_VAND = _monomials_np(_NODES[:, 0], _NODES[:, 1])  # (10 samples, 10 monomials)
# g[k, i] = Σ_j C[k, j] · V[i, j]  →  C = g @ inv(Vᵀ)
_VAND_INV_T = _np.linalg.inv(_VAND.T)  # (10, 10), float64, computed once


def epipolar_constraint_rows(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Linear constraint row(s) of vᵀ E u = 0 in the 6 spherical parameters.

    u, v: (..., 3) rays. Returns (..., 6) rows in parameter order
    [E00, E01, E02, E12, E20, E21].
    """
    return jnp.stack(
        [
            v[..., 0] * u[..., 0] - v[..., 1] * u[..., 1],
            v[..., 0] * u[..., 1] + v[..., 1] * u[..., 0],
            v[..., 0] * u[..., 2],
            v[..., 1] * u[..., 2],
            v[..., 2] * u[..., 0],
            v[..., 2] * u[..., 1],
        ],
        axis=-1,
    )


_HI = jax.lax.Precision.HIGHEST


def _nullspace3(A: jnp.ndarray) -> jnp.ndarray:
    """3-dim (approximate) nullspace of (..., N, 6) via eigh of AᵀA -> (..., 6, 3).

    Columns are ordered so the *smallest*-eigenvalue direction comes last:
    the solver's affine chart is p(x, y) = x·B₀ + y·B₁ + B₂, and for
    non-minimal (N > 5) samples the solution concentrates on the smallest
    singular direction — putting it in the constant column keeps the solution
    near (x, y) = (0, 0) instead of at infinity.

    All contractions use Precision.HIGHEST: a backend's default matmul
    precision may be reduced (TF32 on the GPU), which is fatal for the
    elimination.

    Minimal samples (N = 3) take the exact orthogonal-complement path —
    Gram-Schmidt basis completion, no eigensolver at all (the hot RANSAC
    path); non-minimal samples need the best rank-3 subspace of a noisy
    system and use eigh.
    """
    if A.shape[-2] == 3:
        from ..ops.linalg import nullspace_exact

        return nullspace_exact(A, 3)
    AtA = jnp.einsum("...ni,...nj->...ij", A, A, precision=_HI)
    _, V = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    return V[..., :, :3][..., :, ::-1]


def _spd_solve(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Cholesky solve of an SPD system (the normal equations here are SPD,
    so no pivoted LU is needed)."""
    L = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )


def _constraints(p: jnp.ndarray) -> jnp.ndarray:
    """The 10 cubic essential constraints of a parameter vector (..., 6) -> (..., 10).

    Nine entries of 2 E Eᵀ E − tr(E Eᵀ) E plus det E.
    """
    E = essential_from_params(p)
    Et = jnp.swapaxes(E, -1, -2)
    EEt = E @ Et
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    detE = jnp.linalg.det(E)
    return jnp.concatenate(
        [T.reshape(T.shape[:-2] + (9,)), detE[..., None]], axis=-1
    )


def solve_spherical_3pt(u: jnp.ndarray, v: jnp.ndarray):
    """Solve for spherical essential matrices from ray correspondences.

    u, v: (..., N, 3) with N ≥ 3 (batch axes leading). Returns (Es, valid):
    Es (..., 4, 3, 3) candidate essential matrices normalized to ‖E‖=1, and
    valid (..., 4) boolean mask of finite/real candidates.
    """
    dtype = u.dtype
    with jax.default_matmul_precision("highest"):
        return _solve_spherical_3pt_impl(u, v, dtype)


def _solve_spherical_3pt_impl(u, v, dtype):
    A = epipolar_constraint_rows(u, v)  # (..., N, 6)
    B = _nullspace3(A)  # (..., 6, 3)

    # Evaluate constraints at the interpolation nodes: p_i = B @ [x_i, y_i, 1].
    nodes = jnp.asarray(_NODES, dtype=dtype)  # (10, 2)
    xyz = jnp.concatenate([nodes, jnp.ones((10, 1), dtype=dtype)], axis=-1)  # (10,3)
    p_nodes = jnp.einsum("...ij,nj->...ni", B, xyz, precision=_HI)  # (..., 10, 6)
    g = _constraints(p_nodes)  # (..., 10 nodes, 10 eqs)
    g = jnp.swapaxes(g, -1, -2)  # (..., 10 eqs, 10 nodes)
    C = jnp.einsum(
        "...en,nm->...em", g, jnp.asarray(_VAND_INV_T, dtype=dtype), precision=_HI
    )  # (..., 10 eqs, 10 monomials)

    # Least-squares elimination: x-monomials in terms of y-monomials.
    C1 = C[..., :, :6]
    C2 = C[..., :, 6:]
    C1tC1 = jnp.einsum("...ki,...kj->...ij", C1, C1, precision=_HI)
    C1tC2 = jnp.einsum("...ki,...kj->...ij", C1, C2, precision=_HI)
    G = _spd_solve(C1tC1, C1tC2)  # (..., 6, 4)

    # Row 5 ↔ monomial `x`, row 4 ↔ `xy`:
    #   x  = −(G₅ · [y³, y², y, 1]);  x·y = −(G₄ · [y³, y², y, 1])
    # ⇒ quartic  G₅₀ y⁴ + (G₅₁−G₄₀) y³ + (G₅₂−G₄₁) y² + (G₅₃−G₄₂) y − G₄₃ = 0.
    g5 = G[..., 5, :]
    g4 = G[..., 4, :]
    qa = g5[..., 0]
    qb = g5[..., 1] - g4[..., 0]
    qc = g5[..., 2] - g4[..., 1]
    qd = g5[..., 3] - g4[..., 2]
    qe = -g4[..., 3]
    roots_re, _ = solve_quartic(qa, qb, qc, qd, qe)  # (..., 4)

    # Newton polish of the real root candidates — recovers the precision the
    # closed-form path loses in float32 (and costs a handful of FMAs).
    y = roots_re
    for _ in range(2):
        qa_, qb_, qc_, qd_, qe_ = (
            t[..., None] for t in (qa, qb, qc, qd, qe)
        )
        p = (((qa_ * y + qb_) * y + qc_) * y + qd_) * y + qe_
        dp = ((4.0 * qa_ * y + 3.0 * qb_) * y + 2.0 * qc_) * y + qd_
        step = p / jnp.where(jnp.abs(dp) > 1e-30, dp, 1e-30)
        y = y - jnp.clip(step, -1.0, 1.0)
    x = -(
        g5[..., None, 0] * y**3
        + g5[..., None, 1] * y * y
        + g5[..., None, 2] * y
        + g5[..., None, 3]
    )
    ones = jnp.ones_like(y)
    sol_xyz = jnp.stack([x, y, ones], axis=-1)  # (..., 4, 3)
    p = jnp.einsum("...ij,...kj->...ki", B, sol_xyz)  # (..., 4, 6)
    norm = jnp.linalg.norm(p, axis=-1, keepdims=True)
    valid = jnp.isfinite(norm[..., 0]) & (norm[..., 0] > 1e-12)
    p = p / jnp.where(valid[..., None], norm, 1.0)
    Es = essential_from_params(p)  # (..., 4, 3, 3)
    Es = jnp.where(valid[..., None, None], Es, jnp.zeros_like(Es))
    return Es, valid
