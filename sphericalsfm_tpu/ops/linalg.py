"""Batched small-matrix linear algebra in closed forms.

XLA lowers jnp.linalg.{eigh, svd} through QDWH-style iterations that are
wildly oversized for the 3×3/6×6 matrices at the heart of the minimal
solvers (SURVEY.md §7 hard-parts). The replacements here are *structure*
specializations with no iteration at all:

* the minimal sample's nullspace is an exact orthogonal complement →
  Gram-Schmidt basis completion;
* an essential matrix has singular values (s, s, 0), and the twisted-pair
  decomposition is invariant to the gauge inside the repeated subspace →
  the SVD reduces to one null vector (closed-form adjugate) plus a basis
  completion.

Everything is straight-line vectorized code that fuses into surrounding
kernels and vmaps cleanly in f32/f64 on any backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _mgs_complete(rows: jnp.ndarray, k_extra: int) -> jnp.ndarray:
    """Orthonormal completion of the row space of (..., R, n).

    Returns (..., n, k_extra): an orthonormal basis of the orthogonal
    complement. The candidate pool is the n standard basis vectors; the
    k_extra with the largest residual after projection are kept (pivoting),
    then re-orthonormalized. Exact (up to roundoff) when rows has full rank R.
    """
    R = rows.shape[-2]
    n = rows.shape[-1]
    # Orthonormalize the given rows (modified Gram-Schmidt, unrolled).
    q = []
    for i in range(R):
        v = rows[..., i, :]
        for qj in q:
            v = v - qj * jnp.sum(qj * v, axis=-1, keepdims=True)
        norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        q.append(v / jnp.maximum(norm, 1e-30))

    # Residuals of the standard basis vectors.
    eye = jnp.eye(n, dtype=rows.dtype)
    resid = jnp.broadcast_to(eye, rows.shape[:-2] + (n, n))
    for qj in q:
        resid = resid - qj[..., None, :] * jnp.sum(
            qj[..., None, :] * resid, axis=-1, keepdims=True
        )
    rnorm = jnp.linalg.norm(resid, axis=-1)
    # Pick the k_extra best-conditioned candidates (static top-k by sort).
    order = jnp.argsort(-rnorm, axis=-1)[..., :k_extra]
    cand = jnp.take_along_axis(resid, order[..., :, None], axis=-2)

    out = []
    for i in range(k_extra):
        v = cand[..., i, :]
        for qj in out:
            v = v - qj * jnp.sum(qj * v, axis=-1, keepdims=True)
        norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        out.append(v / jnp.maximum(norm, 1e-30))
    return jnp.stack(out, axis=-1)  # (..., n, k_extra)


def nullspace_exact(A: jnp.ndarray, k: int) -> jnp.ndarray:
    """Exact k-dim nullspace of full-row-rank (..., R, n) with R + k = n."""
    return _mgs_complete(A, k)


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of a batched (..., 3, 3).

    Replacement for `jnp.linalg.inv` on small batched blocks: the general
    path lowers to batched LU, which was slow to compile and run on the
    chip this was first built for; the adjugate is pure elementwise
    arithmetic. Caller guarantees
    invertibility (BA uses it on damped SPD point blocks).
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def chol3x3(M: jnp.ndarray, floor: float = 1e-30) -> jnp.ndarray:
    """Closed-form lower Cholesky of batched SPD (..., 3, 3) blocks.

    Branchless and NaN-free by construction: pivots are clamped to `floor`
    before the sqrt/divide, so all-zero blocks (dead / frozen points whose
    inverse was masked to 0) come back as a finite ~sqrt(floor)·I factor
    instead of NaN — callers multiply it by exactly-zero couplings, and
    NaN·0 would poison the product where 0 is required. Used to split the
    damped point-block inverse Hpp⁻¹ = L·Lᵀ so the Schur correction
    factorizes as (U L)(U L)ᵀ (one aggregated operand instead of two).
    """
    a11 = jnp.maximum(M[..., 0, 0], floor)
    l11 = jnp.sqrt(a11)
    l21 = M[..., 1, 0] / l11
    l31 = M[..., 2, 0] / l11
    a22 = jnp.maximum(M[..., 1, 1] - l21 * l21, floor)
    l22 = jnp.sqrt(a22)
    l32 = (M[..., 2, 1] - l31 * l21) / l22
    a33 = jnp.maximum(M[..., 2, 2] - l31 * l31 - l32 * l32, floor)
    l33 = jnp.sqrt(a33)
    z = jnp.zeros_like(l11)
    return jnp.stack(
        [
            jnp.stack([l11, z, z], axis=-1),
            jnp.stack([l21, l22, z], axis=-1),
            jnp.stack([l31, l32, l33], axis=-1),
        ],
        axis=-2,
    )


def smallest_eigvec_3x3(S: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of a symmetric (..., 3, 3).

    Closed form: the smallest eigenvalue via the trigonometric (Cardano)
    formula, then the eigenvector from the largest column of the adjugate of
    S − λI. No iterations; accurate when the smallest eigenvalue is
    well-separated (the essential-matrix case: spectrum (s², s², 0)).
    """
    s00 = S[..., 0, 0]
    s11 = S[..., 1, 1]
    s22 = S[..., 2, 2]
    s01 = S[..., 0, 1]
    s02 = S[..., 0, 2]
    s12 = S[..., 1, 2]
    q = (s00 + s11 + s22) / 3.0
    p1 = s01 * s01 + s02 * s02 + s12 * s12
    p2 = (s00 - q) ** 2 + (s11 - q) ** 2 + (s22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-37))
    b00 = (s00 - q) / p
    b11 = (s11 - q) / p
    b22 = (s22 - q) / p
    b01 = s01 / p
    b02 = s02 / p
    b12 = s12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    # Eigenvector: adjugate columns of (S − λI); pick the largest.
    M = S - lam_min[..., None, None] * jnp.eye(3, dtype=S.dtype)
    c0 = jnp.cross(M[..., :, 1], M[..., :, 2], axis=-1)
    c1 = jnp.cross(M[..., :, 2], M[..., :, 0], axis=-1)
    c2 = jnp.cross(M[..., :, 0], M[..., :, 1], axis=-1)
    n0 = jnp.sum(c0 * c0, axis=-1)
    n1 = jnp.sum(c1 * c1, axis=-1)
    n2 = jnp.sum(c2 * c2, axis=-1)
    use0 = (n0 >= n1) & (n0 >= n2)
    use1 = (~use0) & (n1 >= n2)
    v = jnp.where(use0[..., None], c0, jnp.where(use1[..., None], c1, c2))
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(vn, 1e-30)


def svd3_rank2(E: jnp.ndarray):
    """SVD factors (U, s, Vt) of (..., 3, 3) rank-2 matrices with a repeated
    top singular value — the essential-matrix case.

    The twisted-pair decomposition is gauge-invariant inside the repeated
    subspace, so V = [v₀ v₁ v₂] takes v₂ = closed-form null vector of EᵀE and
    (v₀, v₁) = any orthonormal completion; U follows as u_k = Ê v_k with
    u₂ = u₀ × u₁ (right-handed by construction).
    """
    EtE = jnp.einsum("...ji,...jk->...ik", E, E, precision=_HI)
    v2 = smallest_eigvec_3x3(EtE)
    v01 = _mgs_complete(v2[..., None, :], 2)  # (..., 3, 2)
    v0 = v01[..., :, 0]
    v1 = v01[..., :, 1]

    u0 = jnp.einsum("...ij,...j->...i", E, v0)
    s0 = jnp.linalg.norm(u0, axis=-1)
    u0 = u0 / jnp.maximum(s0[..., None], 1e-30)
    u1 = jnp.einsum("...ij,...j->...i", E, v1)
    u1p = u1 - u0 * jnp.sum(u0 * u1, axis=-1, keepdims=True)
    s1 = jnp.linalg.norm(u1p, axis=-1)
    u1 = u1p / jnp.maximum(s1[..., None], 1e-30)
    u2 = jnp.cross(u0, u1, axis=-1)
    U = jnp.stack([u0, u1, u2], axis=-1)
    s = jnp.stack([s0, s1, jnp.zeros_like(s0)], axis=-1)
    V = jnp.stack([v0, v1, v2], axis=-1)
    return U, s, jnp.swapaxes(V, -1, -2)


def _balance(M: jnp.ndarray, sweeps: int = 4) -> tuple:
    """Diagonal similarity balancing (row/col norm equalization).

    Returns (M_balanced, d) with M_b = D⁻¹ M D, D = diag(d). Improves the
    convergence and f32 conditioning of the QR eigenvalue iteration below.
    """
    n = M.shape[-1]
    d = jnp.ones(M.shape[:-1], M.dtype)
    eye = jnp.eye(n, dtype=bool)

    def fro2(dd):
        Mb = M * dd[..., None, :] / dd[..., :, None]
        return Mb, jnp.sum(Mb * Mb, axis=(-2, -1))

    for _ in range(sweeps):
        Mb, f0 = fro2(d)
        off = jnp.where(eye, 0.0, Mb)
        r = jnp.sqrt(jnp.sum(off * off, axis=-1))  # off-diag row norms
        c = jnp.sqrt(jnp.sum(off * off, axis=-2))  # off-diag col norms
        s = jnp.where(
            (r > 1e-30) & (c > 1e-30),
            jnp.sqrt(jnp.maximum(c, 1e-30) / jnp.maximum(r, 1e-30)),
            1.0,
        )
        d_new = d * jnp.clip(s, 0.1, 10.0)
        # accept a sweep only where it shrinks the matrix — simultaneous
        # Osborne updates can diverge on structured (unit-row) matrices
        _, f1 = fro2(d_new)
        better = (f1 < f0)[..., None]
        d = jnp.where(better, d_new, d)
    Mb = M * d[..., None, :] / d[..., :, None]
    return Mb, d


def eig_real_batched(M: jnp.ndarray, aberth_iters: int = 60,
                     inv_iters: int = 4):
    """Real eigenpairs of small nonsymmetric matrices, on any backend.

    jnp.linalg.eig is not lowered on every backend; this replacement runs
    everywhere. The
    eigenvalues are the roots of p(z) = det(M − zI); all n of them (complex
    included) are found simultaneously by Aberth–Ehrlich iteration — the
    globally-convergent simultaneous root finder with built-in pairwise
    repulsion — using the numerically stable trace form
    p/p' = −1/tr((M − zI)⁻¹). The complex linear solve is a real 2n×2n
    embedding [[Aᵣ, −Aᵢ],[Aᵢ, Aᵣ]] through QR (no LU, no complex linalg). Real roots then get null vectors from QR-clamped
    inverse iteration plus a bordered-system eigenpair Newton polish.

    M (..., n, n) → (lam (..., n), V (..., n, n) column eigenvectors,
    valid (..., n)). Invalid (complex/failed) slots are zeroed. Accuracy
    ~machine eps of the input dtype for well-separated real eigenvalues.
    """
    n = M.shape[-1]
    dtype = M.dtype
    feps = float(jnp.finfo(dtype).eps)
    flatM = M.reshape((-1, n, n))
    B = flatM.shape[0]
    eye = jnp.eye(n, dtype=dtype)

    # scale by the Gershgorin-style eigenvalue bound so roots live in O(1)
    R_bound = jnp.max(jnp.sum(jnp.abs(flatM), axis=-1), axis=-1)  # (B,)
    R_bound = jnp.maximum(R_bound, 1e-30)
    Mn = flatM / R_bound[:, None, None]

    # Characteristic polynomial by Faddeev–LeVerrier — n batched n×n
    # matmuls (at HIGHEST precision), computed ONCE. The previous
    # trace form p/p' = −1/tr((Mn − zI)⁻¹) solved a 2n×2n real-embedded
    # system per root per Aberth iteration (60·n tiny QRs per problem — the
    # entire 5-pt/6-pt throughput floor); Horner on
    # the coefficients is elementwise (re,im)-plane arithmetic instead.
    # Coefficient-basis roots are worse-conditioned than matrix eigenvalues
    # (Wilkinson), but Aberth only needs to land each root inside the basin
    # of the bordered matrix-Newton polish below, which restores
    # matrix-level accuracy; the validity check is matrix-residual-based,
    # so a basin miss degrades to an invalid slot, not a wrong eigenpair.
    hp = jax.lax.Precision.HIGHEST
    Bk = jnp.broadcast_to(eye, Mn.shape)
    coeffs = [jnp.ones((B,), dtype)]  # leading coefficient of z^n
    for k in range(1, n + 1):
        Ak = jnp.matmul(Mn, Bk, precision=hp)
        ck = -jnp.trace(Ak, axis1=-2, axis2=-1) / k
        coeffs.append(ck)
        Bk = Ak + ck[:, None, None] * eye
    pc = jnp.stack(coeffs, axis=-1)            # (B, n+1), z^n … z^0
    # Rescale z = s·w with s = |c_n|^(1/n) (geometric-mean root radius):
    # the Gershgorin matrix normalization is dominated by the largest
    # eigenvalue, leaving the remaining roots orders of magnitude inside
    # the unit init circle where Aberth converges poorly.
    s_pow = jnp.maximum(jnp.abs(pc[:, -1]), 1e-60) ** (1.0 / n)
    s_pow = jnp.clip(s_pow, 1e-12, 1e2)
    pows = s_pow[:, None] ** jnp.arange(n + 1, dtype=dtype)
    pc = pc / pows                              # (B, n+1) balanced
    dc = pc[:, :-1] * jnp.arange(n, 0, -1, dtype=dtype)  # (B, n) p'

    def ratio_all(_, zr, zi):
        # Horner for p and p' at z = zr + i·zi, all (B, n) planes.
        pr = jnp.broadcast_to(pc[:, 0:1], zr.shape)
        pi = jnp.zeros_like(zr)
        for k in range(1, n + 1):
            pr, pi = (pr * zr - pi * zi + pc[:, k:k + 1],
                      pr * zi + pi * zr)
        qr_ = jnp.broadcast_to(dc[:, 0:1], zr.shape)
        qi_ = jnp.zeros_like(zr)
        for k in range(1, n):
            qr_, qi_ = (qr_ * zr - qi_ * zi + dc[:, k:k + 1],
                        qr_ * zi + qi_ * zr)
        d = jnp.maximum(qr_ * qr_ + qi_ * qi_, 1e-300)
        return ((pr * qr_ + pi * qi_) / d, (pi * qr_ - pr * qi_) / d)

    # Aberth–Ehrlich: zᵢ ← zᵢ − Nᵢ / (1 − Nᵢ·Σ_{j≠i} 1/(zᵢ−zⱼ))
    k = jnp.arange(n, dtype=dtype)
    ang = 2.0 * jnp.pi * (k + 0.5) / n + 0.4
    zr0 = jnp.broadcast_to(1.2 * jnp.cos(ang), (B, n))
    zi0 = jnp.broadcast_to(1.2 * jnp.sin(ang), (B, n))

    def aberth_body(_, zs):
        zr, zi = zs
        Nr, Ni = ratio_all(Mn, zr, zi)
        dr = zr[:, :, None] - zr[:, None, :]
        di = zi[:, :, None] - zi[:, None, :]
        d2 = dr * dr + di * di
        offdiag = ~jnp.eye(n, dtype=bool)
        d2 = jnp.where(offdiag, jnp.maximum(d2, 1e-24), 1.0)
        sr = jnp.sum(jnp.where(offdiag, dr / d2, 0.0), axis=-1)
        si = jnp.sum(jnp.where(offdiag, -di / d2, 0.0), axis=-1)
        # denom = 1 − N·S
        den_r = 1.0 - (Nr * sr - Ni * si)
        den_i = -(Nr * si + Ni * sr)
        dd = jnp.maximum(den_r * den_r + den_i * den_i, 1e-24)
        wr = (Nr * den_r + Ni * den_i) / dd
        wi = (Ni * den_r - Nr * den_i) / dd
        wr = jnp.clip(jnp.where(jnp.isfinite(wr), wr, 0.0), -0.5, 0.5)
        wi = jnp.clip(jnp.where(jnp.isfinite(wi), wi, 0.0), -0.5, 0.5)
        return zr - wr, zi - wi

    zr, zi = jax.lax.fori_loop(0, aberth_iters, aberth_body, (zr0, zi0))

    # Real-eigenvalue CANDIDATES from every root: λ = s·(Re z + Im z). A
    # near-double real pair a±δ stagnates in coefficient-basis Aberth as a
    # complex conjugate pair a±iδ′ with δ′ ≈ δ (the local polynomial is
    # (z−a)²−δ², indistinguishable from (z−a)²+δ′² at the Horner noise
    # floor) — Re+Im maps the stagnated pair back to ≈ a±δ, one member
    # each, and the matrix-level polish below finishes the job. Genuinely
    # real roots have Im ≈ 0 (unchanged); genuinely complex roots produce
    # candidates with no nearby real eigenvalue, which the matrix-residual
    # validity check rejects. All n candidates are polished; dedupe runs
    # AFTER the polish so pair members that merge are dropped honestly.
    lam_c = (zr + zi) * s_pow[:, None]          # (B, n), matrix scale

    # Inverse iteration for null vectors of A = Mn − λI via QR with a
    # clamped R diagonal (forming AᵀA would square away the gap between
    # σ_min ~ 0 and the next small singular values of near-defective cases).
    A = Mn[:, None] - lam_c[..., None, None] * eye  # (B, n, n, n)
    Qa, Ra = jnp.linalg.qr(A)
    diagR = jnp.diagonal(Ra, axis1=-2, axis2=-1)
    delta = 10.0 * feps * jnp.maximum(
        jnp.max(jnp.abs(diagR), axis=-1, keepdims=True), 1e-30
    )
    sgn = jnp.where(diagR < 0, -1.0, 1.0)
    clamped = jnp.where(jnp.abs(diagR) < delta, sgn * delta, diagR)
    Rsafe = Ra + (clamped - diagR)[..., None] * eye
    v = jnp.ones(A.shape[:-1], dtype)  # (B, n, n)
    for _ in range(inv_iters):
        y = jnp.einsum("bkji,bkj->bki", Qa, v)  # Qᵀ v
        v = jax.scipy.linalg.solve_triangular(
            Rsafe, y[..., None], lower=False
        )[..., 0]
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)

    # Joint eigenpair Newton polish on the bordered system
    # [[M−λI, −v], [vᵀ, 0]]·[dv; dλ] = [−(M−λI)v; 0]: non-normal matrices
    # amplify the remaining λ error into the vector — two exact Newton steps
    # take the pair to machine precision.
    def polish(Mi, lam_i, v_i):
        for _ in range(10):
            Ai = Mi - lam_i * eye
            r_i = Ai @ v_i
            top = jnp.concatenate([Ai, -v_i[:, None]], axis=1)
            bot = jnp.concatenate(
                [v_i[None, :], jnp.zeros((1, 1), dtype)], axis=1
            )
            J = jnp.concatenate([top, bot], axis=0)
            rhs = jnp.concatenate([-r_i, jnp.zeros((1,), dtype)])
            Qj, Rj = jnp.linalg.qr(J)
            dx = jax.scipy.linalg.solve_triangular(
                Rj, Qj.T @ rhs, lower=False
            )
            ok = jnp.all(jnp.isfinite(dx))
            v_i = jnp.where(ok, v_i + dx[:n], v_i)
            v_i = v_i / jnp.maximum(jnp.linalg.norm(v_i), 1e-30)
            lam_i = jnp.where(ok, lam_i + dx[n], lam_i)
        return lam_i, v_i

    flatL2, v = jax.vmap(jax.vmap(polish, in_axes=(None, 0, 0)))(
        Mn, lam_c, v
    )
    lam_c = jnp.where(jnp.isfinite(flatL2), flatL2, lam_c)

    # validity: v really is a null vector of A (scale-aware residual)
    A = Mn[:, None] - lam_c[..., None, None] * eye
    res = jnp.linalg.norm(jnp.einsum("bkij,bkj->bki", A, v), axis=-1)
    matn = jnp.sqrt(jnp.sum(Mn * Mn, axis=(-2, -1)) / n)[:, None]
    valid = (res < 1e2 * feps ** 0.5 * (1.0 + matn)) & jnp.isfinite(lam_c)

    # Dedupe AFTER the polish: candidates that converged onto the same
    # eigenvalue keep only the smallest-residual member (index tie-break).
    # Each slot's dedupe radius widens with its own matrix residual: a slot
    # stalled ~res/γ away from the root it shares (near-defective cases
    # converge linearly) must still collapse onto the accurate member,
    # while accurate slots keep the tight radius so genuinely close
    # eigenvalue pairs — the 5-pt near-double roots — are preserved.
    dtol = 1e4 * feps
    radius = jnp.maximum(
        dtol * (1.0 + jnp.abs(lam_c[:, :, None])), 30.0 * res[:, :, None]
    )
    close = jnp.abs(lam_c[:, :, None] - lam_c[:, None, :]) <= radius
    res_key = jnp.where(valid, res, jnp.inf)
    idx = jnp.arange(n)
    better = (res_key[:, None, :] < res_key[:, :, None]) | (
        (res_key[:, None, :] == res_key[:, :, None])
        & (idx[None, None, :] < idx[None, :, None])
    )
    shadowed = jnp.any(
        close & better & valid[:, None, :] & (idx[None, None, :] != idx[None, :, None]),
        axis=-1,
    )
    valid = valid & ~shadowed

    lam_out = (lam_c * R_bound[:, None]).reshape(M.shape[:-1])
    V = jnp.swapaxes(v, -1, -2).reshape(M.shape)  # columns = eigenvectors
    valid = valid.reshape(M.shape[:-1])
    lam_out = jnp.where(valid, lam_out, 0.0)
    V = jnp.where(valid[..., None, :], V, 0.0)
    return lam_out, V, valid


def sigma_min_small(C: jnp.ndarray, iters: int = 5) -> jnp.ndarray:
    """Smallest singular value of a small batched (..., m, n) matrix, m ≥ n.

    Inverse iteration on G = CᵀC through the trace-unrolled Cholesky
    (`chol_small`/`tri_inv_lower_small`) + a final Rayleigh quotient —
    a replacement for `jnp.linalg.svd(..., compute_uv=False)`,
    whose QDWH lowering is wildly oversized for 10×10 discriminator
    evaluations (the 6-pt solver calls σ_min ~90 times per solve; VERDICT
    r4 weak #6). Forming CᵀC halves the attainable precision to ~√eps·‖C‖,
    which is ample for a rank-deficiency DISCRIMINATOR (the minimum's
    location is what matters, not its depth). The ridge keeps the factor
    finite at exact rank deficiency; inverse iteration converges in 2-3
    steps exactly where it matters (σ_min ≪ σ_next near the root).
    """
    n = C.shape[-1]
    G = jnp.einsum("...ji,...jk->...ik", C, C, precision=_HI)
    tr = jnp.trace(G, axis1=-2, axis2=-1) / n
    feps = float(jnp.finfo(C.dtype).eps)
    ridge = (10.0 * feps * jnp.maximum(tr, 1e-30))[..., None, None]
    L = chol_small(G + ridge * jnp.eye(n, dtype=C.dtype))
    Li = tri_inv_lower_small(L)
    x = jnp.ones(C.shape[:-2] + (n,), C.dtype)
    for _ in range(iters):
        y = jnp.einsum("...ij,...j->...i", Li, x)
        x = jnp.einsum("...ji,...j->...i", Li, y)
        x = x / jnp.maximum(
            jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30
        )
    # σ = ‖C x‖ with the converged right-singular-vector estimate — full
    # working precision (a Gram Rayleigh quotient xᵀGx floors at √eps·‖C‖;
    # the vector error enters ‖Cx‖ only at second order).
    Cx = jnp.einsum("...ij,...j->...i", C, x, precision=_HI)
    return jnp.linalg.norm(Cx, axis=-1)


def chol_small(A: jnp.ndarray, floor: float = 1e-30) -> jnp.ndarray:
    """Trace-unrolled lower Cholesky of a small (..., b, b) SPD block.

    Generalizes `chol3x3` to any compile-time block size: the b(b+1)/2
    scalar recurrences unroll at trace time into fused elementwise ops, so
    there is NO sequential while_loop on device (XLA's `cholesky` lowered
    to an O(b)-deep loop nest on the chip this was first built for). Pivots are clamped to `floor` before
    sqrt/divide — branchless and NaN-free on all-zero blocks.
    """
    b = A.shape[-1]
    L = [[None] * b for _ in range(b)]
    z = jnp.zeros_like(A[..., 0, 0])
    for j in range(b):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, floor))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, b):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
        for i in range(j):
            L[i][j] = z
    return jnp.stack(
        [jnp.stack(row, axis=-1) for row in L], axis=-2
    )


def tri_inv_lower_small(L: jnp.ndarray) -> jnp.ndarray:
    """Trace-unrolled inverse of a small (..., b, b) lower-triangular block.

    Forward substitution against the identity, fully unrolled — the
    companion to `chol_small` (XLA's `triangular_solve` was an O(b)-deep
    sequential loop on the chip this was first built for). Caller guarantees nonzero diagonal (chol_small
    floors its pivots).
    """
    b = L.shape[-1]
    X = [[None] * b for _ in range(b)]
    z = jnp.zeros_like(L[..., 0, 0])
    for j in range(b):
        for i in range(b):
            if i < j:
                X[i][j] = z
            elif i == j:
                X[i][j] = 1.0 / L[..., i, i]
            else:
                s = z
                for k in range(j, i):
                    s = s - L[..., i, k] * X[k][j]
                X[i][j] = s / L[..., i, i]
    return jnp.stack(
        [jnp.stack(row, axis=-1) for row in X], axis=-2
    )


def block_chol_solve(S: jnp.ndarray, rhs: jnp.ndarray,
                     block: int = 8) -> jnp.ndarray:
    """Dense SPD solve S x = rhs via a block-column Cholesky scan.

    Currently bench/test-only: the production dense Schur step was faster
    with XLA's cholesky+triangular solves in context on the chip this was
    first built for (optim/ba.py dense path), so no pipeline code calls
    this. Kept as the measured
    alternative; both sides wait for re-measurement on the GPU (ROADMAP
    3.3).

    Replacement for `jnp.linalg.cholesky` + two `solve_triangular` calls,
    which XLA lowered to while-loops whose sequential depth is O(D) tiny
    steps on the chip this was first built for. Here the factorization runs as a lax.scan over
    D/b block columns with closed-form (trace-unrolled) b×b factor and
    triangular inverse per step, and the FORWARD substitution is fused into
    the same scan (classic outer-product elimination carries the rhs), so
    the total sequential depth is 2·D/b steps.

    The input is padded to a multiple of `block` with identity rows, which
    factor trivially and stay decoupled. Caller handles equilibration /
    ridge; same contract as the previous inline Cholesky path.
    """
    dtype = S.dtype
    D = S.shape[0]
    nb = -(-D // block)
    Dp = nb * block
    Spad = jnp.eye(Dp, dtype=dtype).at[:D, :D].set(S)
    bpad = jnp.zeros((Dp,), dtype).at[:D].set(rhs)
    # M[i, k] = b×b block (i, k)
    M = Spad.reshape(nb, block, nb, block).transpose(0, 2, 1, 3)
    bb = bpad.reshape(nb, block)
    idx = jnp.arange(nb)

    def fwd(carry, j):
        M, bb = carry
        col = jax.lax.dynamic_slice(
            M, (0, j, 0, 0), (nb, 1, block, block))[:, 0]       # M[:, j]
        Djj = jax.lax.dynamic_slice(
            col, (j, 0, 0), (1, block, block))[0]
        Linv = tri_inv_lower_small(chol_small(Djj))              # L_jj^{-1}
        # Column j of the factor: L_ij = M[i,j] · L_jj^{-T}; row j itself
        # reproduces L_jj because D_jj = L_jj L_jjᵀ.
        Lcol = col @ Linv.T
        keep = (idx >= j).astype(dtype)
        Lcol = Lcol * keep[:, None, None]
        # Fused forward substitution: y_j = L_jj^{-1} b_j, then eliminate
        # b_i -= L_ij y_j below; row j of bb now HOLDS y_j.
        bj = jax.lax.dynamic_slice(bb, (j, 0), (1, block))[0]
        yj = Linv @ bj
        below = (idx > j).astype(dtype)
        bb = bb - (Lcol @ yj) * below[:, None]
        bb = jax.lax.dynamic_update_slice(bb, yj[None], (j, 0))
        # Trailing Schur update M[i,k] -= L_ij L_kjᵀ (i, k > j).
        Lu = Lcol * below[:, None, None]
        M = M - jnp.einsum("iab,kcb->ikac", Lu, Lu)
        return (M, bb), (Lcol, Linv)

    (_, y), (Lcols, Linvs) = jax.lax.scan(fwd, (M, bb), idx)

    # Backward substitution Lᵀ x = y over reversed block rows:
    # x_j = L_jj^{-T} (y_j − Σ_{k>j} L_kjᵀ x_k); Lcols[j] is column j.
    def bwd(x, inp):
        j, Lcol, Linv = inp
        yj = jax.lax.dynamic_slice(y, (j, 0), (1, block))[0]
        above = (idx > j).astype(dtype)
        s = jnp.einsum("kba,kb->a", Lcol * above[:, None, None], x)
        xj = Linv.T @ (yj - s)
        return jax.lax.dynamic_update_slice(x, xj[None], (j, 0)), None

    x, _ = jax.lax.scan(
        bwd, jnp.zeros((nb, block), dtype),
        (idx[::-1], Lcols[::-1], Linvs[::-1]),
    )
    return x.reshape(Dp)[:D]
