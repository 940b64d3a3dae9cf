"""Error metrics for solvers, relative poses and reconstructions.

Parity with the reference's metric definitions:
* calc_frob_error / calc_rot_error / calc_trans_error
  (/root/reference/evaluation/problem_generator/problem_generator.h:11-39)
* Racc/Tacc@τ and AUC@τ from the PhoneSweep evaluator
  (/root/reference/scripts/metric.py:14-78) — reimplemented in jnp/numpy
  without the PyTorch3D dependency.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry.so3 import rotation_angle


def frobenius_error(E_est: jnp.ndarray, E_gt: jnp.ndarray) -> jnp.ndarray:
    """Sign-invariant Frobenius distance between normalized essential matrices."""
    def _n(E):
        return E / jnp.linalg.norm(E, axis=(-2, -1), keepdims=True)

    a, b = _n(E_est), _n(E_gt)
    d1 = jnp.linalg.norm(a - b, axis=(-2, -1))
    d2 = jnp.linalg.norm(a + b, axis=(-2, -1))
    return jnp.minimum(d1, d2)


def rotation_error_deg(R_est: jnp.ndarray, R_gt: jnp.ndarray) -> jnp.ndarray:
    """Geodesic rotation error in degrees (elementwise trace form — the
    matmul form is exposed to reduced-precision default matmuls, a degree-level
    error on small angles; see so3.rotation_geodesic)."""
    from ..geometry.so3 import rotation_geodesic

    return jnp.degrees(rotation_geodesic(R_est, R_gt))


def translation_angle_deg(t_est: jnp.ndarray, t_gt: jnp.ndarray) -> jnp.ndarray:
    """Angular error between translation directions, in degrees (sign-invariant)."""
    def _n(t):
        n = jnp.linalg.norm(t, axis=-1, keepdims=True)
        return t / jnp.where(n > 1e-12, n, 1.0)

    cosang = jnp.abs(jnp.sum(_n(t_est) * _n(t_gt), axis=-1))
    return jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))


def accuracy_at(errors_deg: jnp.ndarray, tau: float, mask=None) -> jnp.ndarray:
    """Fraction of errors below tau degrees (Racc/Tacc@tau)."""
    ok = errors_deg < tau
    if mask is not None:
        return jnp.sum(ok & mask) / jnp.maximum(jnp.sum(mask), 1)
    return jnp.mean(ok.astype(jnp.float64))


def auc_at(errors_deg: jnp.ndarray, max_tau: float = 30.0, num_bins: int = 30) -> jnp.ndarray:
    """Area under the accuracy-vs-threshold curve up to max_tau degrees.

    Matches the histogram-cumsum definition of the reference evaluator
    (scripts/metric.py:51-78): bin errors into `num_bins` bins of width
    max_tau/num_bins, cumulative fraction per bin, mean over bins.
    """
    e = errors_deg.reshape(-1)
    bin_w = max_tau / num_bins
    idx = jnp.clip(jnp.floor(e / bin_w), 0, num_bins).astype(jnp.int32)
    hist = jnp.zeros((num_bins + 1,), jnp.float64).at[idx].add(1.0)
    hist = hist[:num_bins] / e.shape[0]
    return jnp.mean(jnp.cumsum(hist))


def ate(centers_est: jnp.ndarray, centers_gt: jnp.ndarray) -> jnp.ndarray:
    """Absolute trajectory error after similarity (Umeyama) alignment.

    centers: (N, 3). Returns RMSE of aligned camera centers.
    """
    mu_e = jnp.mean(centers_est, axis=0)
    mu_g = jnp.mean(centers_gt, axis=0)
    xe = centers_est - mu_e
    xg = centers_gt - mu_g
    cov = xe.T @ xg / centers_est.shape[0]
    U, S, Vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], cov.dtype).at[2].set(d))
    Rot = (U @ D @ Vt).T
    var_e = jnp.mean(jnp.sum(xe * xe, axis=-1))
    scale = jnp.sum(S * jnp.diag(D)) / jnp.where(var_e > 1e-18, var_e, 1.0)
    aligned = scale * xe @ Rot.T + mu_g
    return jnp.sqrt(jnp.mean(jnp.sum((aligned - centers_gt) ** 2, axis=-1)))
