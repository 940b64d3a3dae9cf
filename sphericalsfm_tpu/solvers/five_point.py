"""Five-point general essential-matrix solver — interpolation-built action matrix.

Capability parity with the reference's 5-pt comparison stack
(/root/reference/evaluation/five_point/: SteweniusEstimator's N×9 epipolar
system + 4-dim nullspace + 727-line generated Gröbner solver, and the
PoseLib-backed NisterEstimator), used by estimate_pairwise_five_point and the
solver benchmarks. Same *derivation philosophy* as our 3-pt solver
(solvers/spherical.py): instead of machine-generated symbolic coefficients,
the polynomial system is constructed numerically —

1. nullspace: E(x,y,z) = x·B₁ + y·B₂ + z·B₃ + B₄ from the (N×9) epipolar
   system's 4 smallest singular directions;
2. the ten cubic constraints (nine Demazure entries + det E) are cubics in
   (x,y,z) with 20 monomials; they vanish on the ≤10 solutions, so the
   10×20 coefficient matrix C has the classical Stewenius structure. C is
   recovered by evaluating the constraints at 20 fixed nodes and multiplying
   by a precomputed inverse Vandermonde (one 10×20 · 20×20 matmul);
3. Gauss elimination of the 10 degree-3 monomials against the 10 degree-≤2
   quotient-basis monomials gives the 10×10 action matrix for multiplication
   by x; its eigenvectors yield (x, y, z) and thus up to 10 essential
   matrices.

The eigendecomposition is a general (nonsymmetric) 10×10 problem. On CPU the
LAPACK-backed jnp.linalg.eig is used; off the CPU the batched QR-iteration
+ Newton-polish real-eigenpair solver in ops/linalg.py (`eig_real_batched`)
takes over. It was written for a backend without a general eig;
jnp.linalg.eig now lowers for CUDA too, so which of the two is faster on
the GPU is a measurement still to make (off the main path: only the
`-fivepoint` mode uses it).
"""

from __future__ import annotations

import numpy as _np

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

# Monomial order: degree-3 block (10) then degree-≤2 quotient basis (10).
_DEG3 = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
    (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
]
_BASIS = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_MONOS = _DEG3 + _BASIS


def _eval_monos_np(pts):
    out = _np.stack(
        [
            pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c
            for (a, b, c) in _MONOS
        ],
        axis=-1,
    )
    return out


# 20 interpolation nodes on three shells (condition-checked at module load).
def _make_nodes():
    rng = _np.random.default_rng(12345)
    best = None
    for _ in range(200):
        pts = rng.normal(size=(20, 3))
        pts /= _np.linalg.norm(pts, axis=-1, keepdims=True)
        pts *= rng.uniform(0.6, 1.2, (20, 1))
        M = _eval_monos_np(pts)
        c = _np.linalg.cond(M)
        if best is None or c < best[0]:
            best = (c, pts, M)
    return best[1], best[2]


_NODES5, _VAND5 = _make_nodes()
_VAND5_INV_T = _np.linalg.inv(_VAND5.T)


def epipolar_rows_general(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rows of vᵀ E u = 0 in the 9 row-major parameters of E. (..., N, 9)."""
    uu = u[..., None, :]  # (..., N, 1, 3)
    vv = v[..., :, None]  # (..., N, 3, 1)
    return (vv * uu).reshape(u.shape[:-1] + (9,))


def _nullspace4(A: jnp.ndarray) -> jnp.ndarray:
    AtA = jnp.einsum("...ni,...nj->...ij", A, A, precision=_HI)
    _, V = jnp.linalg.eigh(AtA)
    # smallest direction into the constant slot (same chart logic as the
    # 3-pt solver): basis columns [v3, v2, v1, v0]
    return V[..., :, :4][..., :, ::-1]


def _constraints_general(E: jnp.ndarray) -> jnp.ndarray:
    Et = jnp.swapaxes(E, -1, -2)
    EEt = E @ Et
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    detE = jnp.linalg.det(E)
    return jnp.concatenate(
        [T.reshape(T.shape[:-2] + (9,)), detE[..., None]], axis=-1
    )


def _action_matrix(C: jnp.ndarray) -> jnp.ndarray:
    """Multiplication-by-x action matrix from the eliminated system.

    C: (..., 10, 20) with columns ordered [deg-3 | basis]. Rows of
    G = C₁⁻¹C₂ express each degree-3 monomial as −G·basis. For each basis
    monomial bᵢ, x·bᵢ is either a degree-3 monomial (a −G row) or another
    basis monomial (a unit row).
    """
    C1 = C[..., :, :10]
    C2 = C[..., :, 10:]
    C1tC1 = jnp.einsum("...ki,...kj->...ij", C1, C1, precision=_HI)
    C1tC2 = jnp.einsum("...ki,...kj->...ij", C1, C2, precision=_HI)
    L = jnp.linalg.cholesky(C1tC1)
    y = jax.scipy.linalg.solve_triangular(L, C1tC2, lower=True)
    G = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )  # (..., 10, 10)

    deg3_index = {m: i for i, m in enumerate(_DEG3)}
    basis_index = {m: i for i, m in enumerate(_BASIS)}
    rows = []
    dtype = C.dtype
    for (a, b, c) in _BASIS:
        xm = (a + 1, b, c)
        if xm in basis_index:
            unit = jnp.zeros(C.shape[:-2] + (10,), dtype)
            unit = unit.at[..., basis_index[xm]].set(1.0)
            rows.append(unit)
        else:
            rows.append(-G[..., deg3_index[xm], :])
    return jnp.stack(rows, axis=-2)  # (..., 10, 10)


def solve_essential_5pt(u: jnp.ndarray, v: jnp.ndarray, method: str = "auto"):
    """Essential matrices from ≥5 ray correspondences (..., N, 3).

    Returns (Es (..., 10, 3, 3) normalized candidates, valid (..., 10)).
    `method`: "eig" (LAPACK general eig, CPU backends), "qr" (batched
    QR-iteration real eigensolver, any backend), or "auto" (eig on the CPU,
    qr elsewhere).
    vmappable and jittable either way.
    """
    dtype = u.dtype
    if method == "auto":
        method = "eig" if jax.default_backend() == "cpu" else "qr"
    with jax.default_matmul_precision("highest"):
        A = epipolar_rows_general(u, v)
        B = _nullspace4(A)  # (..., 9, 4)

        nodes = jnp.asarray(_NODES5, dtype)  # (20, 3)
        xyzw = jnp.concatenate([nodes, jnp.ones((20, 1), dtype)], axis=-1)
        p_nodes = jnp.einsum("...ij,nj->...ni", B, xyzw, precision=_HI)
        E_nodes = p_nodes.reshape(p_nodes.shape[:-1] + (3, 3))
        g = _constraints_general(E_nodes)  # (..., 20 nodes, 10 eqs)
        g = jnp.swapaxes(g, -1, -2)  # (..., 10 eqs, 20 nodes)
        C = jnp.einsum(
            "...en,nm->...em", g, jnp.asarray(_VAND5_INV_T, dtype),
            precision=_HI,
        )

        M = _action_matrix(C)
        # Right eigenvectors of M are the monomial vectors m(x,y,z) (M·m =
        # x·m on the variety): the eigenvalue is x, and (x, y, z) read off
        # the linear slots 6..8 over the constant slot 9.
        if method == "eig":
            lam, V = jnp.linalg.eig(M)
            V = jnp.swapaxes(V, -1, -2)  # (..., 10 eigvecs, 10)
            real_ok = jnp.abs(jnp.imag(lam)) < 1e-6 * (
                1.0 + jnp.abs(jnp.real(lam))
            )
        else:
            from ..ops.linalg import eig_real_batched

            _, V_r, real_ok = eig_real_batched(M)
            V = jnp.swapaxes(V_r, -1, -2)  # rows = eigenvectors (real)
        const = V[..., 9]
        ok_const = jnp.abs(const) > 1e-12
        const_safe = jnp.where(ok_const, const, 1.0)
        x = V[..., 6] / const_safe
        y = V[..., 7] / const_safe
        z = V[..., 8] / const_safe
        real = real_ok & ok_const
        xr = jnp.real(x).astype(dtype)
        yr = jnp.real(y).astype(dtype)
        zr = jnp.real(z).astype(dtype)
        coef = jnp.stack([xr, yr, zr, jnp.ones_like(xr)], axis=-1)
        p = jnp.einsum("...ij,...kj->...ki", B, coef)  # (..., 10, 9)
        norm = jnp.linalg.norm(p, axis=-1, keepdims=True)
        valid = real & jnp.isfinite(norm[..., 0]) & (norm[..., 0] > 1e-12)
        p = p / jnp.where(valid[..., None], norm, 1.0)
        Es = p.reshape(p.shape[:-1] + (3, 3))
        Es = jnp.where(valid[..., None, None], Es, jnp.zeros_like(Es))
        return Es, valid


def decompose_essential(E: jnp.ndarray):
    """Four (R, t) candidates of a general essential matrix.

    Returns (Rs (..., 4, 3, 3), ts (..., 4, 3)) with ‖t‖=1, the classical
    U·D(±90°)·Vᵀ twisted pair × ±t (reference: five_point_estimator.cpp's
    COLMAP-derived DecomposeEssentialMatrix).
    """
    U, _, Vt = jnp.linalg.svd(E)
    detU = jnp.linalg.det(U)
    detV = jnp.linalg.det(jnp.swapaxes(Vt, -1, -2))
    U = U * jnp.sign(detU)[..., None, None]
    Vt = Vt * jnp.sign(detV)[..., None, None]
    D = jnp.asarray([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]], E.dtype)
    R1 = U @ D @ Vt
    R2 = U @ D.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts


def cheirality_best(Rs, ts, u, v, mask):
    """Pick the (R, t) candidate with the most points in front of both
    cameras via midpoint triangulation (reference PoseFromEssentialMatrix).

    Rs (..., 4, 3, 3), ts (..., 4, 3), u/v (..., N, 3). Returns (R, t, votes).
    """
    from ..geometry.essential import _midpoint_depth_sign

    z1 = _midpoint_depth_sign(
        Rs[..., :, None, :, :], ts[..., :, None, :], u[..., None, :, :], v[..., None, :, :]
    )  # (..., 4, N) depth in camera 1
    # depth in camera 2: transform the midpoint; approximate by projecting
    # the frame-1 depth point: X2 = R X + t; a point in front of both needs
    # z>0 in both. Recompute via the transformed midpoint:
    # reuse z1's construction cheaply by symmetry (swap cameras, inverse pose)
    R_inv = jnp.swapaxes(Rs, -1, -2)
    t_inv = -jnp.einsum("...ij,...j->...i", R_inv, ts)
    z2 = _midpoint_depth_sign(
        R_inv[..., :, None, :, :], t_inv[..., :, None, :],
        v[..., None, :, :], u[..., None, :, :],
    )
    votes = jnp.sum(((z1 > 0) & (z2 > 0)) & mask[..., None, :], axis=-1)
    best = jnp.argmax(votes, axis=-1)
    R = jnp.take_along_axis(Rs, best[..., None, None, None], axis=-3)[..., 0, :, :]
    t = jnp.take_along_axis(ts, best[..., None, None], axis=-2)[..., 0, :]
    return R, t, votes
