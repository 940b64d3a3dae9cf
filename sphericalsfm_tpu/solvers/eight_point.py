"""Normalized 8-point DLT essential-matrix baseline.

The reference compares its spherical solvers against a normalized 8-pt
baseline in test_spherical_relpose (examples/test_spherical_relpose.cpp:
596-631, the `eightpt` column of its CSVs). Classic Hartley-normalized DLT:
center/scale the image coordinates, stack the N×9 epipolar system, take the
smallest right singular direction, de-normalize, and project onto the
essential manifold (singular values → (s, s, 0)).

Batched, jittable, no general eigensolver (9×9 eigh + 3×3 svd only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _normalize_rays(x: jnp.ndarray):
    """Hartley normalization of rays (..., N, 3) on the z=1 plane.

    Returns (x_n, T) with x_n = x @ Tᵀ and mean distance √2 from centroid.
    """
    xy = x[..., :2] / jnp.maximum(jnp.abs(x[..., 2:]), 1e-12) * jnp.sign(
        x[..., 2:]
    )
    c = jnp.mean(xy, axis=-2, keepdims=True)
    d = jnp.linalg.norm(xy - c, axis=-1)
    s = jnp.sqrt(2.0) / jnp.maximum(jnp.mean(d, axis=-1, keepdims=True), 1e-12)
    s_ = s[..., None]
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.concatenate([s, zeros, -s * c[..., 0, 0:1]], axis=-1),
            jnp.concatenate([zeros, s, -s * c[..., 0, 1:2]], axis=-1),
            jnp.concatenate([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )  # (..., 3, 3)
    xh = jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)
    return jnp.einsum("...ij,...nj->...ni", T, xh), T, s_


def solve_essential_8pt(u: jnp.ndarray, v: jnp.ndarray):
    """Essential matrix from ≥8 ray correspondences (..., N, 3).

    Returns (E (..., 3, 3) normalized ‖E‖=1, valid (...,)).
    """
    un, Tu, _ = _normalize_rays(u)
    vn, Tv, _ = _normalize_rays(v)
    # rows of vnᵀ F un = 0 in row-major F
    A = (vn[..., :, :, None] * un[..., :, None, :]).reshape(
        un.shape[:-1] + (9,)
    )
    AtA = jnp.einsum("...ni,...nj->...ij", A, A, precision=_HI)
    _, V = jnp.linalg.eigh(AtA)
    f = V[..., :, 0]  # smallest eigendirection
    F = f.reshape(f.shape[:-1] + (3, 3))
    # de-normalize: vᵀ(Tvᵀ F Tu)u = 0
    E = jnp.swapaxes(Tv, -1, -2) @ F @ Tu
    # project to the essential manifold: singular values (s, s, 0)
    U, S, Vt = jnp.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S_ess = jnp.stack([s, s, jnp.zeros_like(s)], axis=-1)
    E = U @ (S_ess[..., :, None] * Vt)
    norm = jnp.linalg.norm(E, axis=(-2, -1), keepdims=True)
    valid = jnp.isfinite(norm[..., 0, 0]) & (norm[..., 0, 0] > 1e-12)
    E = E / jnp.where(valid[..., None, None], norm, 1.0)
    return jnp.where(valid[..., None, None], E, 0.0), valid
