"""Seven-point fundamental/essential solver — the classic F = F₁ + λF₂
null-space family with det F(λ) = 0 reduced to a closed-form cubic.

Role parity: the reference's relative-pose comparison benchmarks its
spherical 3-pt solver against PoseLib's 7-pt (among others)
(/root/reference/examples/test_spherical_relpose.cpp:596-631). PoseLib is
not installable in this environment, so the baseline is reimplemented
directly; it joins the 5-pt and 8-pt columns of `relpose_comparison`.

Construction (the house interpolation style, no symbolic expansion): the
two smallest eigendirections of AᵀA span the null space of the 7×9
epipolar constraint matrix; det(F₁ + λF₂) is a cubic in λ whose
coefficients are recovered from determinant evaluations at 4 integer nodes
through a fixed 4×4 Vandermonde inverse; real roots come from Cardano in
the same hand-rolled (re, im) arithmetic the quartic solver uses — fully
batched, static shapes, no general eigensolver (3×3 eigh/svd only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .eight_point import _normalize_rays
from .quartic import _c_cbrt, _c_div, _c_mul, _c_sqrt

_HI = jax.lax.Precision.HIGHEST

# Inverse of the Vandermonde matrix for nodes λ ∈ {0, 1, −1, 2} and the
# monomial basis [1, λ, λ², λ³] — exact in float (entries are n/6).
_NODES = (0.0, 1.0, -1.0, 2.0)
_VINV = (
    (1.0, 0.0, 0.0, 0.0),
    (-1.0 / 2.0, 1.0, -1.0 / 3.0, -1.0 / 6.0),
    (-1.0, 1.0 / 2.0, 1.0 / 2.0, 0.0),
    (1.0 / 2.0, -1.0 / 2.0, -1.0 / 6.0, 1.0 / 6.0),
)


def _solve_cubic_real(c0, c1, c2, c3):
    """Real roots of c₃x³ + c₂x² + c₁x + c₀ = 0 (batched). Returns
    (roots (..., 3), is_real (..., 3)); complex-pair slots carry the real
    part (downstream scoring rejects them — fixed-shape RANSAC style)."""
    dtype = c0.dtype
    tiny = jnp.finfo(dtype).tiny
    a = jnp.where(jnp.abs(c3) > tiny, c3, tiny)
    b, c, d = c2 / a, c1 / a, c0 / a
    # depressed cubic t³ + pt + q with x = t − b/3
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sr, si = _c_sqrt(disc, jnp.zeros_like(disc))
    ur, ui = _c_cbrt(-q / 2.0 + sr, si)
    # v = -p/3 / u (complex); u=0 ⇒ p=0, handled by the tiny clamp
    den_r = jnp.where(jnp.hypot(ur, ui) > tiny, ur, tiny)
    vr, vi = _c_div(-p / 3.0, jnp.zeros_like(p), den_r, ui)
    # three cube roots: u·ω^k + v·ω̄^k, ω = exp(2πi/3)
    w_r, w_i = -0.5, jnp.sqrt(jnp.asarray(3.0, dtype)) / 2.0
    roots, reals = [], []
    cur = (ur, ui)
    curv = (vr, vi)
    for _ in range(3):
        tr = cur[0] + curv[0]
        ti = cur[1] + curv[1]
        roots.append(tr - b / 3.0)
        reals.append(jnp.abs(ti) < 1e-6 * (1.0 + jnp.abs(tr)))
        cur = _c_mul(cur[0], cur[1], w_r, w_i)
        curv = _c_mul(curv[0], curv[1], w_r, -w_i)
    return jnp.stack(roots, -1), jnp.stack(reals, -1)


def solve_essential_7pt(u: jnp.ndarray, v: jnp.ndarray):
    """Essential candidates from exactly 7 ray correspondences (..., 7, 3).

    Returns (E (..., 3, 3, 3) ‖E‖=1 candidates, valid (..., 3)). Each real
    root of the det cubic yields one candidate, projected onto the
    essential manifold (equal singular values) for pose decomposition;
    complex-pair slots are marked invalid.
    """
    un, Tu, _ = _normalize_rays(u)
    vn, Tv, _ = _normalize_rays(v)
    A = (vn[..., :, :, None] * un[..., :, None, :]).reshape(
        un.shape[:-1] + (9,)
    )
    AtA = jnp.einsum("...ni,...nj->...ij", A, A, precision=_HI)
    _, V = jnp.linalg.eigh(AtA)
    F1 = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    F2 = V[..., :, 1].reshape(V.shape[:-2] + (3, 3))

    dets = [
        jnp.linalg.det(F1 + lam * F2) for lam in _NODES
    ]  # 4 evaluations of the cubic
    coef = [
        sum(_VINV[k][n] * dets[n] for n in range(4)) for k in range(4)
    ]  # c0..c3
    lams, is_real = _solve_cubic_real(*coef)

    F = F1[..., None, :, :] + lams[..., :, None, None] * F2[..., None, :, :]
    E = (
        jnp.swapaxes(Tv, -1, -2)[..., None, :, :] @ F @ Tu[..., None, :, :]
    )
    U, S, Vt = jnp.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S_ess = jnp.stack([s, s, jnp.zeros_like(s)], axis=-1)
    E = U @ (S_ess[..., :, None] * Vt)
    norm = jnp.linalg.norm(E, axis=(-2, -1), keepdims=True)
    valid = is_real & jnp.isfinite(norm[..., 0, 0]) & (norm[..., 0, 0] > 1e-12)
    E = E / jnp.where(valid[..., None, None], norm, 1.0)
    return jnp.where(valid[..., None, None], E, 0.0), valid
