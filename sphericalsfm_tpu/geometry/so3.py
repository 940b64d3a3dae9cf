"""SO(3) utilities: skew, exp, log — batched, branchless, vmappable.

Capability parity with the reference's so3.{h,cpp} (skew3, so3exp, so3ln;
see /root/reference/src/so3.cpp:6-69) but written as pure array functions with
`where` selects instead of data-dependent branches, so they trace cleanly
under jit/vmap as elementwise device work.

The implementations are generic over the array namespace: `so3_exp`/`so3_log`
are the jnp (device) versions; `np_so3_exp`/`np_so3_log` run the same math in
host numpy — for host-side bookkeeping paths (SfMMap transforms, writers)
where an eager device op would cost a dispatch and a fetch per call.

Conventions: rotation matrices are world->camera; axis-angle vectors r satisfy
R = exp([r]_x).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_SQRT1_2 = 0.7071067811865476


def _skew(v, xp):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = xp.zeros_like(x)
    return xp.stack(
        [
            xp.stack([zero, -z, y], axis=-1),
            xp.stack([z, zero, -x], axis=-1),
            xp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def _exp(r, xp):
    theta2 = xp.sum(r * r, axis=-1)
    theta = xp.sqrt(theta2)
    small = theta2 < 1e-16
    # sin(θ)/θ and (1-cos θ)/θ² with guarded θ to avoid 0/0 under autodiff.
    theta_safe = xp.where(small, xp.ones_like(theta), theta)
    a = xp.where(small, 1.0 - theta2 / 6.0, xp.sin(theta_safe) / theta_safe)
    b = xp.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - xp.cos(theta_safe)) / (theta_safe * theta_safe),
    )
    K = _skew(r, xp)
    # K² = r rᵀ − θ² I (closed form for skew matrices): elementwise, no
    # matmul. A K @ K matmul at a backend's DEFAULT precision may round
    # f32 inputs (bf16 on the chip this was first built for, TF32 on the
    # GPU) — every so3_exp rotation picked up ~1e-2
    # absolute error (~0.6°), which silently corrupted all COLMAP/NeRF
    # writer output and the evaluation built on it (found round 5 when the
    # written models scored 4× the in-memory reprojection error).
    K2 = r[..., :, None] * r[..., None, :] - theta2[..., None, None] * (
        xp.eye(3, dtype=r.dtype)
    )
    eye = xp.broadcast_to(xp.eye(3, dtype=r.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def _log(R, xp):
    dtype = R.dtype
    cos_angle = xp.clip(
        (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0
    )
    asym = 0.5 * xp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_abs = xp.linalg.norm(asym, axis=-1)
    sin_safe = xp.where(sin_abs > 1e-12, sin_abs, xp.ones_like(sin_abs))

    # Regime 1: θ in [0, π/4): r = asym * asin(|sin|)/|sin|
    scale1 = xp.where(
        sin_abs > 1e-12, xp.arcsin(xp.clip(sin_abs, -1.0, 1.0)) / sin_safe, 1.0
    )
    r1 = asym * scale1[..., None]

    # Regime 2: θ in [π/4, 3π/4): r = asym * acos(cos)/|sin|
    scale2 = xp.arccos(cos_angle) / sin_safe
    r2 = asym * scale2[..., None]

    # Regime 3: θ near π — antisymmetric part vanishes; recover the axis from
    # the symmetric part. Pick the column with the largest diagonal excess.
    angle3 = xp.pi - xp.arcsin(xp.clip(sin_abs, -1.0, 1.0))
    d = xp.stack(
        [
            R[..., 0, 0] - cos_angle,
            R[..., 1, 1] - cos_angle,
            R[..., 2, 2] - cos_angle,
        ],
        axis=-1,
    )
    cand0 = xp.stack(
        [d[..., 0], 0.5 * (R[..., 1, 0] + R[..., 0, 1]),
         0.5 * (R[..., 0, 2] + R[..., 2, 0])],
        axis=-1,
    )
    cand1 = xp.stack(
        [0.5 * (R[..., 1, 0] + R[..., 0, 1]), d[..., 1],
         0.5 * (R[..., 2, 1] + R[..., 1, 2])],
        axis=-1,
    )
    cand2 = xp.stack(
        [0.5 * (R[..., 0, 2] + R[..., 2, 0]),
         0.5 * (R[..., 2, 1] + R[..., 1, 2]), d[..., 2]],
        axis=-1,
    )
    absd = xp.abs(d)
    use0 = (absd[..., 0] >= absd[..., 1]) & (absd[..., 0] >= absd[..., 2])
    use1 = (~use0) & (absd[..., 1] >= absd[..., 2])
    axis = xp.where(
        use0[..., None], cand0, xp.where(use1[..., None], cand1, cand2)
    )
    # Align with the antisymmetric part's direction (sign disambiguation).
    flip = xp.sum(axis * asym, axis=-1) < 0
    axis = xp.where(flip[..., None], -axis, axis)
    axis_norm = xp.linalg.norm(axis, axis=-1)
    axis_norm = xp.where(axis_norm > 1e-12, axis_norm, xp.ones_like(axis_norm))
    r3 = axis / axis_norm[..., None] * angle3[..., None]

    in1 = cos_angle > _SQRT1_2
    in2 = (~in1) & (cos_angle > -_SQRT1_2)
    out = xp.where(in1[..., None], r1, xp.where(in2[..., None], r2, r3))
    return out.astype(dtype)


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric cross-product matrix. v: (..., 3) -> (..., 3, 3)."""
    return _skew(v, jnp)


def so3_exp(r: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula, r: (..., 3) -> (..., 3, 3).

    Uses the series-safe form R = I + a(θ)[r]_x + b(θ)[r]_x², with
    a = sinθ/θ and b = (1-cosθ)/θ² evaluated via their Taylor limits near 0 so
    the function is smooth and finite everywhere (no data-dependent branch).
    """
    return _exp(r, jnp)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Matrix log of a rotation, R: (..., 3, 3) -> (..., 3).

    Numerically-careful three-regime formulation (asin for small angles, acos
    for mid angles, symmetric part near π), mirroring the regime split of the
    reference implementation (so3.cpp:25-69) but fully branchless: all three
    candidates are computed and blended with `where`.
    """
    return _log(R, jnp)


def np_so3_exp(r) -> np.ndarray:
    """Host-numpy so3_exp — same math, no device dispatch."""
    return _exp(np.asarray(r), np)


def np_so3_log(R) -> np.ndarray:
    """Host-numpy so3_log — same math, no device dispatch."""
    return _log(np.asarray(R), np)


def rotation_angle(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle in radians, (..., 3, 3) -> (...,). Cheap trace formula."""
    cos_angle = jnp.clip(
        (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0
    )
    return jnp.arccos(cos_angle)


def rotation_geodesic(Ra: jnp.ndarray, Rb: jnp.ndarray) -> jnp.ndarray:
    """Geodesic angle between two rotations, (..., 3, 3) x2 -> (...,).

    trace(Ra Rbᵀ) = Σ_ij Ra∘Rb computed elementwise — the Ra @ Rbᵀ matmul
    form runs at the backend's default matmul precision, which may round
    f32 inputs (~1e-2 error on the cosine at bf16, a degree-level error on the
    angle — far above the thresholds the evaluation metrics compare at)."""
    cos_angle = jnp.clip(
        (jnp.sum(Ra * Rb, axis=(-2, -1)) - 1.0) * 0.5, -1.0, 1.0
    )
    return jnp.arccos(cos_angle)
