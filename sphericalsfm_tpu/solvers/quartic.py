"""Closed-form quartic root finding, batched, with hand-rolled complex math.

Solves a x⁴ + b x³ + c x² + d x + e = 0 via Ferrari's reduction to a
depressed cubic — the same closed-form path the reference uses
(spherical_solvers.cpp:15-98, itself from the Theia library) — but vectorized
over a batch axis and implemented on (re, im) float pairs so it runs
without relying on complex-dtype support in every backend.

Always returns 4 roots as (re, im) arrays; callers keep real parts (the
reference's SolveQuarticReals likewise keeps the real part of every root and
lets downstream scoring reject spurious candidates — convenient for
fixed-shape batched RANSAC).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def _c_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _c_div(ar, ai, br, bi):
    den = br * br + bi * bi
    den = jnp.where(den > 0, den, jnp.finfo(ar.dtype).tiny)
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def _c_sqrt(ar, ai):
    """Principal square root on (re, im) pairs."""
    mag = jnp.hypot(ar, ai)
    re = jnp.sqrt(jnp.maximum(0.5 * (mag + ar), 0.0))
    im_abs = jnp.sqrt(jnp.maximum(0.5 * (mag - ar), 0.0))
    im = jnp.where(ai >= 0, im_abs, -im_abs)
    return re, im


def _c_cbrt(ar, ai):
    """Principal cube root via polar form."""
    mag = jnp.hypot(ar, ai)
    ang = jnp.arctan2(ai, ar)
    m = jnp.cbrt(mag)
    a3 = ang / 3.0
    return m * jnp.cos(a3), m * jnp.sin(a3)


def solve_quartic(
    a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray, d: jnp.ndarray, e: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Roots of a x⁴ + b x³ + c x² + d x + e.

    Inputs broadcast elementwise; returns (roots_re, roots_im), each of shape
    (..., 4). Degenerate inputs (a≈0, repeated roots through w≈0) produce
    non-finite entries that downstream scoring masks out.
    """
    a, b, c, d, e = jnp.broadcast_arrays(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d), jnp.asarray(e)
    )
    a2 = a * a
    b2 = b * b
    a3 = a2 * a
    b3 = b2 * b
    a4 = a3 * a
    b4 = b3 * b

    alpha = -3.0 * b2 / (8.0 * a2) + c / a
    beta = b3 / (8.0 * a3) - b * c / (2.0 * a2) + d / a
    gamma = -3.0 * b4 / (256.0 * a4) + b2 * c / (16.0 * a3) - b * d / (4.0 * a2) + e / a

    alpha2 = alpha * alpha
    alpha3 = alpha2 * alpha

    P_re = -alpha2 / 12.0 - gamma
    P_im = jnp.zeros_like(P_re)
    Q_re = -alpha3 / 108.0 + alpha * gamma / 3.0 - beta * beta / 8.0
    Q_im = jnp.zeros_like(Q_re)

    # R = -Q/2 + sqrt(Q²/4 + P³/27)
    Q2_re, Q2_im = _c_mul(Q_re, Q_im, Q_re, Q_im)
    P2_re, P2_im = _c_mul(P_re, P_im, P_re, P_im)
    P3_re, P3_im = _c_mul(P2_re, P2_im, P_re, P_im)
    s_re, s_im = _c_sqrt(Q2_re / 4.0 + P3_re / 27.0, Q2_im / 4.0 + P3_im / 27.0)
    R_re = -Q_re / 2.0 + s_re
    R_im = -Q_im / 2.0 + s_im

    U_re, U_im = _c_cbrt(R_re, R_im)

    # y = -5α/6 + (U≈0 ? −Q^{1/3} : −P/(3U) + U)
    small_U = jnp.abs(U_re) < 1e-8
    negQ_cbrt_re, negQ_cbrt_im = _c_cbrt(Q_re, Q_im)
    U_safe_re = jnp.where(small_U, jnp.ones_like(U_re), U_re)
    U_safe_im = jnp.where(small_U, jnp.zeros_like(U_im), U_im)
    PdU_re, PdU_im = _c_div(P_re, P_im, 3.0 * U_safe_re, 3.0 * U_safe_im)
    y_re = -5.0 * alpha / 6.0 + jnp.where(small_U, -negQ_cbrt_re, -PdU_re + U_re)
    y_im = jnp.where(small_U, -negQ_cbrt_im, -PdU_im + U_im)

    # w = sqrt(α + 2y)
    w_re, w_im = _c_sqrt(alpha + 2.0 * y_re, 2.0 * y_im)

    # 2β/w
    two_beta_w_re, two_beta_w_im = _c_div(
        2.0 * beta, jnp.zeros_like(beta), w_re, w_im
    )

    base = -b / (4.0 * a)
    arg_p_re = -(3.0 * alpha + 2.0 * y_re + two_beta_w_re)
    arg_p_im = -(2.0 * y_im + two_beta_w_im)
    arg_m_re = -(3.0 * alpha + 2.0 * y_re - two_beta_w_re)
    arg_m_im = -(2.0 * y_im - two_beta_w_im)
    sp_re, sp_im = _c_sqrt(arg_p_re, arg_p_im)
    sm_re, sm_im = _c_sqrt(arg_m_re, arg_m_im)

    r0_re = base + 0.5 * (w_re + sp_re)
    r0_im = 0.5 * (w_im + sp_im)
    r1_re = base + 0.5 * (w_re - sp_re)
    r1_im = 0.5 * (w_im - sp_im)
    r2_re = base + 0.5 * (-w_re + sm_re)
    r2_im = 0.5 * (-w_im + sm_im)
    r3_re = base + 0.5 * (-w_re - sm_re)
    r3_im = 0.5 * (-w_im - sm_im)

    roots_re = jnp.stack([r0_re, r1_re, r2_re, r3_re], axis=-1)
    roots_im = jnp.stack([r0_im, r1_im, r2_im, r3_im], axis=-1)
    return roots_re, roots_im
