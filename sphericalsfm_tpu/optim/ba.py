"""Bundle adjustment: Levenberg–Marquardt with Schur-complement elimination.

The device replacement for the reference's Ceres SPARSE_SCHUR solve
(/root/reference/src/sfm.cpp:194-290): reprojection residuals
e = f·π(R(r)X + t) − uv with Cauchy(1.0) robust loss, per-parameter freeze
masks (focal / rotation / translation / point — sfm.h:33-36), trust-region LM
with 2000-iteration cap, and the camera/point Schur structure:

  per-point 3×3 Hessian blocks → batched inverse
  reduced camera system S = Hcc − W Hpp⁻¹ Wᵀ → dense Cholesky
  point back-substitution — all segment-sums and batched einsums.

Static-shape data model: observation table (camera index, point index, uv,
weight) plus a per-point padded track table bucketing observations by point,
so the whole Schur reduction is one fused kernel with no data-dependent
shapes. Camera parameter order per camera is [t(3), r(3)] matching the
reference's Camera = t∥r layout (sfm_types.h:9), with the shared focal as one
trailing parameter.

Works in float64 (CPU, exact parity testing) and float32 (the accelerator
regime, with Jacobi equilibration of the reduced system).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.so3 import so3_exp
from ..ops.linalg import chol3x3, inv3x3
from .lm import cauchy_rho, cauchy_weight


class BAProblem(NamedTuple):
    """Static-shape bundle-adjustment problem.

    C cameras, P points, K observations, Tmax = max track length.

    `cam_ptr` (optional, C+1 int32) gives camera segment boundaries when the
    observation table is sorted by camera index; it enables the matrix-free
    PCG camera solve (scatter-free sorted segment sums). Build it with
    `sort_obs_by_camera`.
    """

    focal: jnp.ndarray        # scalar
    cam_t: jnp.ndarray        # (C, 3)
    cam_r: jnp.ndarray        # (C, 3)
    points: jnp.ndarray       # (P, 3)
    obs_cam: jnp.ndarray      # (K,) int32 camera index per observation
    obs_pt: jnp.ndarray       # (K,) int32 point index per observation
    obs_uv: jnp.ndarray       # (K, 2) principal-point-centered pixels
    obs_w: jnp.ndarray        # (K,) weight (0 = padding / disabled)
    track_obs: jnp.ndarray    # (P, Tmax) int32 obs indices per point (clamped)
    track_mask: jnp.ndarray   # (P, Tmax) validity
    focal_fixed: jnp.ndarray  # scalar bool
    rot_fixed: jnp.ndarray    # (C,) bool
    trans_fixed: jnp.ndarray  # (C,) bool
    point_fixed: jnp.ndarray  # (P,) bool
    cam_ptr: jnp.ndarray | None = None  # (C+1,) int32, obs sorted by camera
    # Point-major view of the (camera-sorted) observation table, for the
    # PCG path's O(K) point-side segment sums (the track table pads every
    # point to the LONGEST track — ruinous when track lengths are skewed).
    pt_order: jnp.ndarray | None = None  # (K,) int32: sorts obs by point
    pt_ptr: jnp.ndarray | None = None    # (P+1,) int32 segment bounds
    # Per-point observation-pair tables for the O(ΣT²) dense Schur assembly
    # (`build_cc_pairs`): ordered pairs (a, b) of same-point observations,
    # sorted by the (cam_a·C + cam_b) block key, with `cc_ptr` the C²+1
    # segment bounds into that sorted pair list.
    cc_pair_a: jnp.ndarray | None = None  # (Npairs,) int32 obs index
    cc_pair_b: jnp.ndarray | None = None  # (Npairs,) int32 obs index
    cc_ptr: jnp.ndarray | None = None     # (C²+1,) int32


class BAResult(NamedTuple):
    focal: jnp.ndarray
    cam_t: jnp.ndarray
    cam_r: jnp.ndarray
    points: jnp.ndarray
    cost: jnp.ndarray
    initial_cost: jnp.ndarray
    iterations: jnp.ndarray
    lam: jnp.ndarray | None = None  # final LM damping (for warm restart)
    dec: jnp.ndarray | None = None  # final λ back-off factor (warm restart)


def _residuals(focal, cam_t, cam_r, points, p: BAProblem):
    """(K, 2) reprojection residuals of the current state."""
    R = so3_exp(cam_r[p.obs_cam])           # (K, 3, 3)
    X = points[p.obs_pt]                     # (K, 3)
    px = jnp.einsum("kij,kj->ki", R, X) + cam_t[p.obs_cam]
    z = px[..., 2]
    z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    proj = focal * px[..., :2] / z[..., None]
    return proj - p.obs_uv


def ba_cost(focal, cam_t, cam_r, points, p: BAProblem, loss_scale=1.0):
    """Robust total cost: Σ w · ½·rho(‖e‖²) with Cauchy loss (sfm.cpp:196)."""
    e = _residuals(focal, cam_t, cam_r, points, p)
    s = jnp.sum(e * e, axis=-1)
    return 0.5 * jnp.sum(p.obs_w * cauchy_rho(s, loss_scale))


def _packed_resid(theta, uv):
    """Residual of one observation from the packed 10-vector
    [f, t(3), r(3), X(3)] — the autodiff seed shared by the obs-major and
    slot-major Jacobian paths (consistent with Ceres's autodiff of the same
    cost, reference sfm.cpp:30-66; raw angle-axis, no local manifold)."""
    f = theta[0]
    t = theta[1:4]
    r = theta[4:7]
    X = theta[7:10]
    Rm = so3_exp(r)
    px = Rm @ X + t
    z = jnp.where(jnp.abs(px[2]) > 1e-12, px[2], 1e-12)
    return f * px[:2] / z - uv


def _per_obs_jacobians(focal, cam_t, cam_r, points, p: BAProblem):
    """Residuals and Jacobian blocks per observation.

    Returns e (K,2), Jf (K,2,1), Jc (K,2,6) [t then r], Jx (K,2,3), computed
    by forward-mode autodiff of the single-observation projection — exactly
    consistent with Ceres's autodiff of the same cost (sfm.cpp:30-66), with
    the raw-angle-axis parameterization (no local manifold), matching the
    reference.
    """
    packed = _packed_resid

    thetas = jnp.concatenate(
        [
            jnp.broadcast_to(focal, (p.obs_cam.shape[0], 1)),
            cam_t[p.obs_cam],
            cam_r[p.obs_cam],
            points[p.obs_pt],
        ],
        axis=-1,
    )  # (K, 10)
    e = jax.vmap(packed)(thetas, p.obs_uv)
    J = jax.vmap(jax.jacfwd(packed))(thetas, p.obs_uv)  # (K, 2, 10)
    Jf = J[:, :, 0:1]
    Jc = J[:, :, 1:7]
    Jx = J[:, :, 7:10]
    return e, Jf, Jc, Jx


def _weight_and_mask(e, Jf, Jc, Jx, p: BAProblem, loss_scale):
    """Apply sqrt robust IRLS weights (Cauchy) × obs weights and zero the
    Jacobian columns of frozen parameters. Shared by both camera solvers."""
    dtype = e.dtype
    s = jnp.sum(e * e, axis=-1)
    w = cauchy_weight(s, loss_scale) * p.obs_w
    sw = jnp.sqrt(w)[:, None]
    e_w = e * sw
    Jf_w = Jf * sw[..., None]
    Jc_w = Jc * sw[..., None]
    Jx_w = Jx * sw[..., None]

    free_f = jnp.where(p.focal_fixed, 0.0, 1.0).astype(dtype)
    free_t = (~p.trans_fixed).astype(dtype)[p.obs_cam]  # (K,)
    free_r = (~p.rot_fixed).astype(dtype)[p.obs_cam]
    free_x = (~p.point_fixed).astype(dtype)[p.obs_pt]
    Jf_w = Jf_w * free_f
    Jc_w = Jc_w * jnp.concatenate(
        [jnp.repeat(free_t[:, None], 3, -1), jnp.repeat(free_r[:, None], 3, -1)],
        axis=-1,
    )[:, None, :]
    Jx_w = Jx_w * free_x[:, None, None]
    return e_w, Jf_w, Jc_w, Jx_w


class _SlotTables(NamedTuple):
    """Loop-invariant point-major (P, Tmax) view of the observation table.

    Built ONCE per bundle_adjust trace, before the LM while_loop: the old
    dense-scan solver re-gathered the per-obs residual/Jacobian arrays
    through `track_obs` EVERY iteration (random gathers were the single
    largest piece of the step at the 64-camera bench shape on the chip this
    was first built for). In slot-major layout those gathers touch only
    static data and hoist out of the loop; per-iteration work is
    elementwise/matmul only. Requires a
    COMPLETE track table (prepare_problem's dense-scan dispatch already
    guarantees one — a truncated table would drop observations).
    """

    uv: jnp.ndarray      # (P, T, 2)
    w: jnp.ndarray       # (P, T) obs weight, 0 on padding
    cam: jnp.ndarray     # (P, T) int32, C on padding
    camc: jnp.ndarray    # (P, T) int32 clamped to [0, C-1] (gather-safe)
    mask: jnp.ndarray    # (P, T) bool
    free_t: jnp.ndarray  # (P, T)
    free_r: jnp.ndarray  # (P, T)


def _build_slot_tables(p: BAProblem, dtype) -> _SlotTables:
    C = p.cam_t.shape[0]
    cam = jnp.where(p.track_mask, p.obs_cam[p.track_obs], C)
    camc = jnp.minimum(cam, C - 1)
    mf = p.track_mask.astype(dtype)
    return _SlotTables(
        uv=p.obs_uv[p.track_obs] * mf[..., None],
        w=p.obs_w[p.track_obs] * mf,
        cam=cam,
        camc=camc,
        mask=p.track_mask,
        free_t=(~p.trans_fixed).astype(dtype)[camc] * mf,
        free_r=(~p.rot_fixed).astype(dtype)[camc] * mf,
    )


def _soa_rodrigues(r0, r1, r2, x0, x1, x2):
    """Structure-of-arrays Rodrigues: p = R(r)·X as component planes.

    Every intermediate is a full (P, T) array — the packed (N, 10)/(N, 3)
    form put tiny minor dims in the vector lanes of the chip this was first
    built for and wasted most of them. Small-angle guards mirror
    geometry/so3.py::_exp exactly. Returns (p0, p1, p2, aux) where aux
    carries (theta_safe, small, a, b, (c0,c1,c2), (d0,d1,d2)) for the
    analytic Jacobian."""
    theta2 = r0 * r0 + r1 * r1 + r2 * r2
    theta = jnp.sqrt(theta2)
    small = theta2 < 1e-16
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    a = jnp.where(
        small, 1.0 - theta2 / 6.0, jnp.sin(theta_safe) / theta_safe
    )
    b = jnp.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - jnp.cos(theta_safe)) / (theta_safe * theta_safe),
    )
    # c = r × X ; d = r × c  (K X and K² X of the Rodrigues form)
    c0 = r1 * x2 - r2 * x1
    c1 = r2 * x0 - r0 * x2
    c2 = r0 * x1 - r1 * x0
    d0 = r1 * c2 - r2 * c1
    d1 = r2 * c0 - r0 * c2
    d2 = r0 * c1 - r1 * c0
    p0 = x0 + a * c0 + b * d0
    p1 = x1 + a * c1 + b * d1
    p2 = x2 + a * c2 + b * d2
    aux = (theta_safe, small, a, b, (c0, c1, c2), (d0, d1, d2))
    return p0, p1, p2, aux


def _slot_params(focal, cam_t, cam_r, points, st: _SlotTables):
    P, T = st.cam.shape
    tg = cam_t[st.camc]
    rg = cam_r[st.camc]
    return (
        tg[..., 0], tg[..., 1], tg[..., 2],
        rg[..., 0], rg[..., 1], rg[..., 2],
        jnp.broadcast_to(points[:, None, 0], (P, T)),
        jnp.broadcast_to(points[:, None, 1], (P, T)),
        jnp.broadcast_to(points[:, None, 2], (P, T)),
    )


def _slot_jacobians(focal, cam_t, cam_r, points, st: _SlotTables):
    """Slot-major twin of `_per_obs_jacobians`: residuals/Jacobians computed
    directly in the (P, T) track layout (padding slots read camera 0 /
    weight 0 and are zeroed by the caller's weighting)."""
    t0, t1, t2, r0, r1, r2, x0, x1, x2 = _slot_params(
        focal, cam_t, cam_r, points, st
    )
    return _soa_jacobians(focal, t0, t1, t2, r0, r1, r2, x0, x1, x2,
                          st.uv[..., 0], st.uv[..., 1])


def _per_obs_jacobians_soa(focal, cam_t, cam_r, points, p: BAProblem):
    """Obs-major analytic SoA twin of `_per_obs_jacobians` (same return
    shapes/values to roundoff). The vmapped-jacfwd path packs parameters
    into (K, 10) vectors whose tiny minor dims wasted most vector lanes on
    the chip this was first built for (what motivated the slot-major dense
    solver); here
    every intermediate is a full (K,) plane. Feeds the PCG and dense_pairs
    camera solvers, whose per-LM-iteration Jacobian recompute was pure
    packed-autodiff before."""
    tg = cam_t[p.obs_cam]
    rg = cam_r[p.obs_cam]
    Xg = points[p.obs_pt]
    return _soa_jacobians(
        focal, tg[:, 0], tg[:, 1], tg[:, 2],
        rg[:, 0], rg[:, 1], rg[:, 2],
        Xg[:, 0], Xg[:, 1], Xg[:, 2],
        p.obs_uv[:, 0], p.obs_uv[:, 1],
    )


def _soa_jacobian_planes(focal, t0, t1, t2, r0, r1, r2, x0, x1, x2,
                         uv0, uv1):
    """Analytic residual + Jacobian blocks as PLANE TUPLES of any shape
    (...,): the stacked-array wrapper `_soa_jacobians` serves the dense
    slot solver; the plane form feeds the plane-major PCG assembly (a
    (K, 2, 6) array tiled at ~1% occupancy on the chip this was first built
    for; whether the plane form still pays on the GPU waits for
    re-measurement, ROADMAP 3.6).

    Returns (e0, e1), (q0, q1), jc, jx where jc is a 6-list and jx a
    3-list of (d0, d1) column tuples (∂e0/∂θ_j, ∂e1/∂θ_j).

    The Jacobian is ANALYTIC in SoA form — the same chain rule jacfwd
    traces through `_packed_resid`, hand-expanded so every term is a full
    plane (exactness vs the autodiff obs-major path is asserted by
    tests/test_ba.py::test_slot_schur_matches_obs_major). Derivative of the
    rotation action, term by term:
        ∂(RX)/∂r_k = α_k c + a (e_k×X) + β_k d + b (e_k×c + r×(e_k×X))
    with c = r×X, d = r×c, α_k = ∂a/∂r_k, β_k = ∂b/∂r_k via the Taylor
    guards of so3_exp."""
    p0, p1, p2, aux = _soa_rodrigues(r0, r1, r2, x0, x1, x2)
    theta_safe, small, a, b, (c0, c1, c2), (d0, d1, d2) = aux
    p0 = p0 + t0
    p1 = p1 + t1
    p2 = p2 + t2
    z = jnp.where(jnp.abs(p2) > 1e-12, p2, 1e-12)
    fz = focal / z
    q0 = p0 / z
    q1 = p1 / z
    e0 = focal * q0 - uv0
    e1 = focal * q1 - uv1

    # ∂a/∂θ / θ and ∂b/∂θ / θ with so3_exp's Taylor limits (the guarded
    # branch derivative jacfwd takes through the `where`s).
    ts2 = theta_safe * theta_safe
    sin_t = jnp.sin(theta_safe)
    cos_t = jnp.cos(theta_safe)
    da_over = jnp.where(
        small, jnp.full_like(a, -1.0 / 3.0),
        (theta_safe * cos_t - sin_t) / (ts2 * theta_safe),
    )
    db_over = jnp.where(
        small, jnp.full_like(b, -1.0 / 12.0),
        (theta_safe * sin_t - 2.0 * (1.0 - cos_t)) / (ts2 * ts2),
    )

    def dp_dr(rk, ekX, ekC, rxekX):
        # ∂p/∂r_k — each operand a 3-tuple of planes.
        al = da_over * rk
        be = db_over * rk
        return tuple(
            al * c + a * eX + be * d + b * (eC + rX)
            for c, d, eX, eC, rX in zip(
                (c0, c1, c2), (d0, d1, d2), ekX, ekC, rxekX
            )
        )

    zero = jnp.zeros_like(p0)
    # e_k × X, e_k × c, r × (e_k × X) for k = 0, 1, 2 (hand-expanded).
    dr_cols = [
        dp_dr(r0, (zero, -x2, x1), (zero, -c2, c1),
              (r1 * x1 + r2 * x2, -r0 * x1, -r0 * x2)),
        dp_dr(r1, (x2, zero, -x0), (c2, zero, -c0),
              (-r1 * x0, r2 * x2 + r0 * x0, -r1 * x2)),
        dp_dr(r2, (-x1, x0, zero), (-c1, c0, zero),
              (-r2 * x0, -r2 * x1, r0 * x0 + r1 * x1)),
    ]

    def proj(dp0, dp1, dp2):
        # chain through the projection: de = fz · (dp_xy − q · dp_z)
        return (fz * (dp0 - q0 * dp2), fz * (dp1 - q1 * dp2))

    # ∂p/∂t = I → columns (fz, 0), (0, fz), (−fz q0, −fz q1).
    one = jnp.ones_like(p0)
    jc = [proj(one, zero, zero), proj(zero, one, zero),
          proj(zero, zero, one)]
    jc += [proj(*cols) for cols in dr_cols]
    # ∂p/∂X = R, reconstructed column-wise from the same primal pieces:
    # R e_k = e_k + a (r × e_k) + b (r × (r × e_k)).
    rr0, rr1, rr2 = r0 * r0, r1 * r1, r2 * r2
    jx = [
        proj(1.0 - b * (rr1 + rr2), a * r2 + b * r0 * r1,
             -a * r1 + b * r0 * r2),
        proj(-a * r2 + b * r0 * r1, 1.0 - b * (rr0 + rr2),
             a * r0 + b * r1 * r2),
        proj(a * r1 + b * r0 * r2, -a * r0 + b * r1 * r2,
             1.0 - b * (rr0 + rr1)),
    ]
    return (e0, e1), (q0, q1), jc, jx


def _soa_jacobians(focal, t0, t1, t2, r0, r1, r2, x0, x1, x2, uv0, uv1):
    """Stacked-array wrapper over `_soa_jacobian_planes` (same shapes as
    `_per_obs_jacobians`)."""
    (e0, e1), (q0, q1), jc, jx = _soa_jacobian_planes(
        focal, t0, t1, t2, r0, r1, r2, x0, x1, x2, uv0, uv1
    )
    e = jnp.stack([e0, e1], axis=-1)
    Jf = jnp.stack([q0, q1], axis=-1)[..., None]
    Jc = jnp.stack(
        [jnp.stack([d0, d1], axis=-1) for (d0, d1) in jc], axis=-1
    )
    Jx = jnp.stack(
        [jnp.stack([d0, d1], axis=-1) for (d0, d1) in jx], axis=-1
    )
    return e, Jf, Jc, Jx


def _ba_cost_obs_soa(focal, cam_t, cam_r, points, p: BAProblem,
                     loss_scale=1.0):
    """Obs-major SoA twin of `ba_cost` (same value to roundoff): component
    planes instead of the (K, 3, 3) so3_exp + einsum chain. Used by the
    PCG/dense_pairs LM loop where the cost re-evaluates every iteration."""
    tg = cam_t[p.obs_cam]
    rg = cam_r[p.obs_cam]
    Xg = points[p.obs_pt]
    p0, p1, p2, _ = _soa_rodrigues(
        rg[:, 0], rg[:, 1], rg[:, 2], Xg[:, 0], Xg[:, 1], Xg[:, 2]
    )
    p2 = p2 + tg[:, 2]
    z = jnp.where(jnp.abs(p2) > 1e-12, p2, 1e-12)
    e0 = focal * (p0 + tg[:, 0]) / z - p.obs_uv[:, 0]
    e1 = focal * (p1 + tg[:, 1]) / z - p.obs_uv[:, 1]
    s = e0 * e0 + e1 * e1
    return 0.5 * jnp.sum(p.obs_w * cauchy_rho(s, loss_scale))


def _ba_cost_slots(focal, cam_t, cam_r, points, st: _SlotTables, p,
                   loss_scale=1.0):
    """Robust cost over the slot table — identical to `ba_cost` when the
    track table is complete (the dense-scan dispatch requirement). SoA
    primal only (full-lane elementwise, no (N, 10) packing)."""
    t0, t1, t2, r0, r1, r2, x0, x1, x2 = _slot_params(
        focal, cam_t, cam_r, points, st
    )
    p0, p1, p2, _ = _soa_rodrigues(r0, r1, r2, x0, x1, x2)
    p2 = p2 + t2
    z = jnp.where(jnp.abs(p2) > 1e-12, p2, 1e-12)
    e0 = focal * (p0 + t0) / z - st.uv[..., 0]
    e1 = focal * (p1 + t1) / z - st.uv[..., 1]
    s = e0 * e0 + e1 * e1
    return 0.5 * jnp.sum(st.w * cauchy_rho(s, loss_scale))


def _schur_solve(
    e, Jf, Jc, Jx, p: BAProblem, lam, loss_scale, solve_dtype
):
    """One damped Schur-complement Gauss-Newton step (dense camera solve).

    Returns (d_focal, d_cam (C,6), d_points (P,3)).
    """
    C = p.cam_t.shape[0]
    P = p.points.shape[0]
    dtype = e.dtype

    e_w, Jf_w, Jc_w, Jx_w = _weight_and_mask(e, Jf, Jc, Jx, p, loss_scale)

    # --- Hessian blocks (Gauss-Newton), scatter-free ---
    # Scatter-free (chosen where scatters were slow; ROADMAP 3.6): every
    # segment reduction below is either a gather through the per-point
    # track table or a one-hot contraction.
    Tmax = p.track_obs.shape[1]
    tmaskf = p.track_mask.astype(dtype)
    tJx = Jx_w[p.track_obs] * tmaskf[..., None, None]    # (P, T, 2, 3)
    tJc = Jc_w[p.track_obs] * tmaskf[..., None, None]    # (P, T, 2, 6)
    tJf = Jf_w[p.track_obs][..., 0] * tmaskf[..., None]  # (P, T, 2)
    te = e_w[p.track_obs] * tmaskf[..., None]            # (P, T, 2)
    tcam = jnp.where(p.track_mask, p.obs_cam[p.track_obs], C)  # (P, T)

    # Point blocks Hpp (P, 3, 3) and rhs b_p (P, 3) via track gathers.
    Hpp = jnp.einsum("ptdi,ptdj->pij", tJx, tJx)
    b_p = jnp.einsum("ptdi,ptd->pi", tJx, te)

    # Camera-side reductions via a one-hot (K, C) contraction.
    oh_cam = (p.obs_cam[:, None] == jnp.arange(C)[None, :]).astype(dtype)
    oh_cam = oh_cam * (p.obs_w > 0)[:, None]
    Hcc = jnp.einsum("kc,kdi,kdj->cij", oh_cam, Jc_w, Jc_w)
    b_c = jnp.einsum("kc,kdi,kd->ci", oh_cam, Jc_w, e_w)
    Hfc = jnp.einsum("kc,kd,kdj->cj", oh_cam, Jf_w[..., 0], Jc_w)
    Hff = jnp.sum(Jf_w * Jf_w)
    b_f = jnp.sum(Jf_w[..., 0] * e_w)

    # Camera-point coupling per track slot: U (P, T, 6, 3), focal-pt (P, T, 3).
    tU = jnp.einsum("ptdi,ptdj->ptij", tJc, tJx)
    tF_slot = jnp.einsum("ptd,ptdj->ptj", tJf, tJx)

    # --- damping (LM): add lam·diag(H) to each diagonal ---
    Hpp_d = Hpp + jnp.eye(3, dtype=dtype) * (
        lam * jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-12)
    )[..., None, :] * jnp.eye(3, dtype=dtype)
    Hpp_inv = inv3x3(
        Hpp_d + 1e-18 * jnp.eye(3, dtype=dtype)
    )  # (P, 3, 3); zero-track points → ~0 after masking below
    # (closed-form adjugate: batched LU inv was slow to compile AND to run
    # on thousands of 3×3 blocks on the chip this was first built for)
    Hpp_inv = jnp.where(
        (jnp.sum(p.track_mask, axis=-1) > 0)[:, None, None], Hpp_inv, 0.0
    )

    # --- assemble the reduced camera system, scatter-free ---
    # S = Hcc − W Hpp⁻¹ Wᵀ factorizes through per-point camera aggregates:
    # A[p, c, i, x] = Σ_a 1[cam(p,a)=c]·(U_a Hpp⁻¹)[i, x] and
    # B[p, c, j, x] = Σ_b 1[cam(p,b)=c]·U_b[j, x], so the Schur term is the
    # single contraction Σ_p A·Bᵀ. The per-point camera one-hot is built
    # in point chunks to bound memory (chunk × T × C floats).
    tU_inv = jnp.einsum("ptij,pjk->ptik", tU, Hpp_inv)         # U·Hpp⁻¹
    tF_sum = jnp.sum(tF_slot, axis=1)                          # (P, 3)
    tF_inv = jnp.einsum("pi,pij->pj", tF_sum, Hpp_inv)         # (P, 3)

    # Chunk size bounded by the (chunk, T, C) one-hot's footprint — a video
    # map can pair T≈256-long tracks with hundreds of cameras, and a fixed
    # 4096-point chunk would materialize gigabytes. ~64M f32 (256 MB) per
    # scan step keeps the matmuls large without the blowup.
    chunk = max(128, min(P, (64 << 20) // max(Tmax * C, 1), 4096))
    n_chunks = -(-P // chunk)
    Ppad = n_chunks * chunk

    def pad0(x):
        return jnp.zeros((Ppad,) + x.shape[1:], x.dtype).at[:P].set(x)

    tU_inv_c = pad0(tU_inv).reshape(n_chunks, chunk, Tmax, 6, 3)
    tU_c = pad0(tU).reshape(n_chunks, chunk, Tmax, 6, 3)
    tcam_c = pad0(jnp.where(p.track_mask, tcam, C)).reshape(n_chunks, chunk, Tmax)
    tF_inv_c = pad0(tF_inv).reshape(n_chunks, chunk, 3)
    tF_sum_c = pad0(tF_sum).reshape(n_chunks, chunk, 3)
    b_p_c = pad0(b_p).reshape(n_chunks, chunk, 3)

    def chunk_body(carry, xs):
        S_cc, S_fc, S_ff, rc_red, rf_red = carry
        tUi, tUo, tc, tFi, tFs, bp = xs
        oh = (tc[..., None] == jnp.arange(C)[None, None, :]).astype(dtype)
        A = jnp.einsum("ptc,ptix->pcix", oh, tUi)   # (chunk, C, 6, 3)
        B = jnp.einsum("ptc,ptjx->pcjx", oh, tUo)
        S_cc = S_cc - jnp.einsum("pcix,pejx->ceij", A, B)
        S_fc = S_fc - jnp.einsum("px,pejx->ej", tFi, B)
        S_ff = S_ff - jnp.sum(tFi * tFs)
        rc_red = rc_red + jnp.einsum("pcix,px->ci", A, bp)
        rf_red = rf_red + jnp.sum(tFi * bp)
        return (S_cc, S_fc, S_ff, rc_red, rf_red), None

    init = (
        jnp.zeros((C, C, 6, 6), dtype),
        jnp.zeros((C, 6), dtype),
        jnp.zeros((), dtype),
        jnp.zeros((C, 6), dtype),
        jnp.zeros((), dtype),
    )
    (S_cc, S_fc, S_ff, rc_red, rf_red), _ = jax.lax.scan(
        chunk_body, init,
        (tU_inv_c, tU_c, tcam_c, tF_inv_c, tF_sum_c, b_p_c),
    )

    # add the (damped) non-reduced parts
    diagC = jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-12)
    Hcc_d = Hcc + jnp.eye(6, dtype=dtype) * (lam * diagC)[..., None, :] * jnp.eye(
        6, dtype=dtype
    )
    S_cc = S_cc.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
    S_fc = S_fc + Hfc
    S_ff = S_ff + Hff * (1.0 + lam) + 1e-12

    # reduced rhs
    r_c = b_c - rc_red
    r_f = b_f - rf_red

    # --- dense solve of the (6C+1) system with Jacobi equilibration ---
    D = 6 * C + 1
    S = jnp.zeros((D, D), solve_dtype)
    S = S.at[: 6 * C, : 6 * C].set(
        S_cc.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C).astype(solve_dtype)
    )
    S = S.at[6 * C, : 6 * C].set(S_fc.reshape(-1).astype(solve_dtype))
    S = S.at[: 6 * C, 6 * C].set(S_fc.reshape(-1).astype(solve_dtype))
    S = S.at[6 * C, 6 * C].set(S_ff.astype(solve_dtype))
    rhs = jnp.concatenate([r_c.reshape(-1), r_f[None]]).astype(solve_dtype)

    dscale = jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
    S_eq = S / dscale[:, None] / dscale[None, :]
    S_eq = S_eq + 1e-10 * jnp.eye(D, dtype=solve_dtype)
    L = jnp.linalg.cholesky(S_eq)
    y = jax.scipy.linalg.solve_triangular(L, -(rhs / dscale), lower=True)
    dx = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    dx = (dx / dscale).astype(dtype)

    d_cam = dx[: 6 * C].reshape(C, 6)
    d_f = dx[6 * C]

    # --- back-substitute points: dx_p = Hpp⁻¹ (−b_p − Wᵀ dx_c − F d_f) ---
    # Gather-based: Σ_a U_aᵀ dx_c[cam(p, a)] through the track table (the
    # dump column C reads a zero row).
    d_cam_pad = jnp.concatenate([d_cam, jnp.zeros((1, 6), dtype)], axis=0)
    dc_track = d_cam_pad[tcam]  # (P, T, 6)
    Wt_dx = jnp.einsum("ptij,pti->pj", tU, dc_track)
    Ft_dx = tF_sum * d_f
    d_pts = jnp.einsum("pij,pj->pi", Hpp_inv, -b_p - Wt_dx - Ft_dx)
    md = _model_decrease(
        lam, d_f, d_cam, d_pts, b_f, b_c, b_p, Hff, diagC,
        jnp.diagonal(Hpp, axis1=-2, axis2=-1),
    )
    return d_f, d_cam, d_pts, md


def _schur_solve_slots(
    focal, cam_t, cam_r, points, st: _SlotTables, p: BAProblem, lam,
    loss_scale, solve_dtype,
):
    """Slot-major dense Schur step — the speed-of-light rewrite of
    `_schur_solve` (same math, same damping, same dense camera solve).

    Three structural changes, each targeting a sink measured at the
    64-cam / 40.8k-obs bench shape on another chip (the layout waits for
    re-measurement on the GPU, ROADMAP 3.3/3.6):
      * residuals/Jacobians are computed directly in the (P, T) track
        layout from loop-invariant slot tables — no per-iteration
        track-table gathers;
      * every tiny-contraction einsum (d=2 / x=3 inner dims, which XLA
        lowers to pad-wasted batched micro-matmuls) is a broadcast
        multiply-sum;
      * ALL camera-indexed reductions ride ONE chunked one-hot scan whose
        payloads concatenate into a single (C, chunkT)×(chunkT, 60)
        matmul, and the Schur correction uses the symmetric (U·L)(U·L)ᵀ
        form (Hpp⁻¹ = LLᵀ via chol3x3) so one aggregated operand feeds a
        syrk-shaped contraction.
    """
    C = p.cam_t.shape[0]
    P, Tmax = st.cam.shape
    dtype = points.dtype

    e, Jf, Jc, Jx = _slot_jacobians(focal, cam_t, cam_r, points, st)

    # --- weights + freeze masks (slot-major twin of _weight_and_mask) ---
    s = jnp.sum(e * e, axis=-1)
    w = cauchy_weight(s, loss_scale) * st.w
    sw = jnp.sqrt(w)[..., None]
    e_w = e * sw
    free_f = jnp.where(p.focal_fixed, 0.0, 1.0).astype(dtype)
    free_x = (~p.point_fixed).astype(dtype)
    Jf_w = Jf[..., 0] * sw * free_f                      # (P, T, 2)
    free_c = jnp.concatenate(
        [
            jnp.repeat(st.free_t[..., None], 3, -1),
            jnp.repeat(st.free_r[..., None], 3, -1),
        ],
        axis=-1,
    )                                                     # (P, T, 6)
    Jc_w = Jc * sw[..., None] * free_c[..., None, :]      # (P, T, 2, 6)
    Jx_w = Jx * sw[..., None] * free_x[:, None, None, None]

    # --- point blocks as broadcast multiply-sums ---
    Hpp = jnp.sum(Jx_w[..., :, None] * Jx_w[..., None, :], axis=(1, 2))
    b_p = jnp.sum(Jx_w * e_w[..., None], axis=(1, 2))     # (P, 3)
    # Camera-point coupling U = Jcᵀ Jx per slot and the focal column.
    tU = jnp.sum(Jc_w[..., :, None] * Jx_w[..., None, :], axis=2)  # (P,T,6,3)
    tF_slot = jnp.sum(Jf_w[..., None] * Jx_w, axis=2)     # (P, T, 3)
    tF_sum = jnp.sum(tF_slot, axis=1)                     # (P, 3)
    Hff = jnp.sum(Jf_w * Jf_w)
    b_f = jnp.sum(Jf_w * e_w)

    # --- damping + closed-form point inverses (identical to _schur_solve) ---
    Hpp_d = Hpp + jnp.eye(3, dtype=dtype) * (
        lam * jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-12)
    )[..., None, :] * jnp.eye(3, dtype=dtype)
    Hpp_inv = inv3x3(Hpp_d + 1e-18 * jnp.eye(3, dtype=dtype))
    Hpp_inv = jnp.where(
        (jnp.sum(st.mask, axis=-1) > 0)[:, None, None], Hpp_inv, 0.0
    )
    # Split Hpp⁻¹ = L Lᵀ so the Schur correction is the symmetric
    # (U L)(U L)ᵀ — one aggregated operand instead of (U Hpp⁻¹, U).
    Lp = chol3x3(Hpp_inv)                                 # (P, 3, 3)
    q1 = jnp.sum(Hpp_inv * b_p[:, None, :], axis=-1)      # Hpp⁻¹ b_p
    hF = jnp.sum(Hpp_inv * tF_sum[:, None, :], axis=-1)   # Hpp⁻¹ F

    # Per-slot payloads (x = 3 contractions unrolled as broadcast sums):
    W = sum(
        tU[..., x, None] * Lp[:, None, None, x, :] for x in range(3)
    )                                                     # (P, T, 6, 3) = U·L
    g_a = sum(tU[..., x] * q1[:, None, None, x] for x in range(3))  # U·q1
    g_f = sum(tU[..., x] * hF[:, None, None, x] for x in range(3))  # U·hF
    # Camera-diagonal payloads: Jcᵀ Jc (36), Jcᵀ e (6), Jf·Jc (6).
    Y_cc = jnp.sum(Jc_w[..., :, None] * Jc_w[..., None, :], axis=2)
    y_bc = jnp.sum(Jc_w * e_w[..., None], axis=2)         # (P, T, 6)
    y_fc = jnp.sum(Jf_w[..., None] * Jc_w, axis=2)        # (P, T, 6)

    # Point-level focal reductions (no camera index involved).
    S_ff_corr = jnp.sum(hF * tF_sum)
    rf_red = jnp.sum(hF * b_p)

    # --- ONE chunked one-hot scan for every camera-indexed reduction ---
    chunk = max(128, min(P, (64 << 20) // max(Tmax * C, 1), 4096))
    n_chunks = -(-P // chunk)
    Ppad = n_chunks * chunk

    def pad0(x):
        return jnp.zeros((Ppad,) + x.shape[1:], x.dtype).at[:P].set(x)

    payload = jnp.concatenate(
        [Y_cc.reshape(P, Tmax, 36), y_bc, y_fc, g_a, g_f], axis=-1
    )                                                     # (P, T, 60)
    pay_c = pad0(payload).reshape(n_chunks, chunk, Tmax, 60)
    W_c = pad0(W.reshape(P, Tmax, 18)).reshape(n_chunks, chunk, Tmax, 18)
    cam_c = pad0(st.cam).reshape(n_chunks, chunk, Tmax)

    def chunk_body(carry, xs):
        S_corr, red = carry
        pay, Wk, tc = xs
        oh = (tc[..., None] == jnp.arange(C)[None, None, :]).astype(dtype)
        # All per-camera row reductions in one (C, chunkT)@(chunkT, 60):
        red = red + jnp.einsum(
            "qc,qf->cf", oh.reshape(-1, C), pay.reshape(-1, 60)
        )
        # Per-point camera aggregate of U·L, then the symmetric fill.
        A = jnp.einsum("ptc,ptf->pcf", oh, Wk)            # (chunk, C, 18)
        A = A.reshape(chunk, C, 6, 3)
        S_corr = S_corr + jnp.einsum("pcix,pejx->ceij", A, A)
        return (S_corr, red), None

    (S_corr, red), _ = jax.lax.scan(
        chunk_body,
        (
            jnp.zeros((C, C, 6, 6), dtype),
            jnp.zeros((C, 60), dtype),
        ),
        (pay_c, W_c, cam_c),
    )
    Hcc = red[:, :36].reshape(C, 6, 6)
    b_c = red[:, 36:42]
    Hfc = red[:, 42:48]
    rc_red = red[:, 48:54]
    S_fc_corr = red[:, 54:60]

    # --- assemble + dense solve (same damping/equilibration as before) ---
    diagC = jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-12)
    Hcc_d = Hcc + jnp.eye(6, dtype=dtype) * (lam * diagC)[..., None, :] * (
        jnp.eye(6, dtype=dtype)
    )
    S_cc = (-S_corr).at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
    S_fc = Hfc - S_fc_corr
    S_ff = Hff * (1.0 + lam) + 1e-12 - S_ff_corr
    r_c = b_c - rc_red
    r_f = b_f - rf_red
    d_cam, d_f = _dense_schur_factor_solve(
        S_cc, S_fc, S_ff, r_c, r_f, solve_dtype, dtype, C
    )

    # --- point back-substitution: broadcast the camera step to slots, then
    # contract against the ALREADY computed per-slot coupling tU —
    # Wᵀ dx_c per point = Σ_{t,i} U·dx. Two broadcast forms: a one-hot
    # matmul when the (P·T, C+1) operand is small (faster than the gather
    # at the 64-cam bench shape on another chip), a row gather when
    # materializing it would cost GBs of HBM traffic (video maps: C≈264 ×
    # 1.8M slots ≈ 2 GB).
    d_cam_pad = jnp.concatenate([d_cam, jnp.zeros((1, 6), dtype)], axis=0)
    if P * Tmax * (C + 1) <= (64 << 20):
        oh_bs = (
            st.cam.reshape(P * Tmax, 1) == jnp.arange(C + 1)[None, :]
        ).astype(dtype)
        dc_s = (oh_bs @ d_cam_pad).reshape(P, Tmax, 6)
    else:
        dc_s = d_cam_pad[st.cam]
    Wt_dx = jnp.sum(tU * dc_s[..., None], axis=(1, 2))    # (P, 3)
    Ft_dx = tF_sum * d_f
    rhs_p = -b_p - Wt_dx - Ft_dx
    d_pts = jnp.sum(Hpp_inv * rhs_p[:, None, :], axis=-1)
    md = _model_decrease(
        lam, d_f, d_cam, d_pts, b_f, b_c, b_p, Hff, diagC,
        jnp.diagonal(Hpp, axis1=-2, axis2=-1),
    )
    return d_f, d_cam, d_pts, md


def _model_decrease(lam, d_f, d_cam, d_pts, b_f, b_c, b_p, Hff, diagC, diagP):
    """Predicted cost decrease of the damped GN step — the denominator of
    Ceres's step quality ρ (trust_region_minimizer.cc). With
    (H + λD)d = −g it reduces to −½·gᵀd + ½·λ·dᵀDd, so no extra H·d
    product is needed; D is the per-block damping diagonal used above."""
    gTd = (b_f * d_f + jnp.sum(b_c * d_cam) + jnp.sum(b_p * d_pts))
    dDd = (
        Hff * d_f * d_f
        + jnp.sum(diagC * d_cam * d_cam)
        + jnp.sum(jnp.maximum(diagP, 1e-12) * d_pts * d_pts)
    )
    return -0.5 * gTd + 0.5 * lam * dDd


def _sorted_segment_sum(x, ptr):
    """Segment sums of rows of `x` (K, d) grouped contiguously by segment.

    `ptr` (S+1,) holds segment boundaries (ptr[s] ≤ k < ptr[s+1] ⇒ row k is in
    segment s; empty segments and rows outside [ptr[0], ptr[S]) allowed).
    A segmented inclusive scan (log-depth, deterministic) whose running sum
    restarts at every segment's first row, read at every segment's last row:
    each sum adds only its own segment's rows, so the f32 rounding is
    relative to that segment. A difference of global prefix sums is not: its
    error scales with the whole table, and on a 2000-camera ring (1.04M
    observations) it left the f32 PCG solve at 3.6x the f64 cost.
    """
    K = x.shape[0]
    nonempty = ptr[1:] > ptr[:-1]
    first = jnp.zeros((K,), jnp.int32).at[ptr[:-1]].max(
        nonempty.astype(jnp.int32), mode="drop") > 0

    def combine(a, b):
        (va, fa), (vb, fb) = a, b
        return jnp.where(fb, vb, va + vb), fa | fb

    run, _ = jax.lax.associative_scan(combine, (x, first[:, None]))
    last = jnp.clip(ptr[1:] - 1, 0, K - 1)
    return jnp.where(nonempty[:, None], run[last], 0).astype(x.dtype)


class _ReducedSystem(NamedTuple):
    """O(K)-assembled Schur pieces shared by the PCG and pairs-dense camera
    solvers (everything except the off-diagonal S_cc fill)."""

    e_w: jnp.ndarray
    Jf_w: jnp.ndarray
    Jc_w: jnp.ndarray
    Jx_w: jnp.ndarray
    U: jnp.ndarray          # (K, 6, 3) camera-point coupling per obs
    Hpp: jnp.ndarray        # (P, 3, 3)
    Hpp_inv: jnp.ndarray    # (P, 3, 3) damped inverse (0 for dead points)
    b_p: jnp.ndarray        # (P, 3)
    tF_sum: jnp.ndarray     # (P, 3) Σ_k Jf·Jx per point
    FHpi: jnp.ndarray       # (P, 3) tF_sum · Hpp⁻¹
    free_c: jnp.ndarray     # (C, 6) 1.0 on free camera dims
    Hcc_d: jnp.ndarray      # (C, 6, 6) damped camera blocks
    Mcc: jnp.ndarray        # (C, 6, 6) diagonal Schur correction
    Hfc: jnp.ndarray        # (C, 6)
    Sfc_red: jnp.ndarray    # (C, 6)
    b_c: jnp.ndarray        # (C, 6)
    rc_red: jnp.ndarray     # (C, 6)
    Hff: jnp.ndarray        # scalar
    b_f: jnp.ndarray        # scalar
    diagC: jnp.ndarray      # (C, 6)
    S_ff: jnp.ndarray       # scalar (solve_dtype)
    r_c: jnp.ndarray        # (C, 6) reduced rhs (solve_dtype)
    r_f: jnp.ndarray        # scalar (solve_dtype)


def _assemble_reduced(e, Jf, Jc, Jx, p: BAProblem, lam, loss_scale,
                      solve_dtype) -> _ReducedSystem:
    """Scatter-free O(K) assembly of every Schur piece except the
    off-diagonal camera-camera fill. Requires `p.cam_ptr`/`p.pt_ptr`."""
    C = p.cam_t.shape[0]
    Pn = p.points.shape[0]
    dtype = e.dtype

    e_w, Jf_w, Jc_w, Jx_w = _weight_and_mask(e, Jf, Jc, Jx, p, loss_scale)

    def segsum_pt(x):
        return _sorted_segment_sum(x[p.pt_order], p.pt_ptr)

    # --- point-side blocks: one fused point-major segment sum ---
    JxJx = jnp.einsum("kdi,kdj->kij", Jx_w, Jx_w).reshape(-1, 9)
    bpk = jnp.einsum("kdi,kd->ki", Jx_w, e_w)            # (K, 3)
    fxk = jnp.einsum("kd,kdj->kj", Jf_w[..., 0], Jx_w)   # (K, 3)
    wk_live = (p.obs_w > 0).astype(dtype)[:, None]       # exact int counts
    seg_p = segsum_pt(
        jnp.concatenate([JxJx, bpk, fxk, wk_live], axis=-1))  # (P, 16)
    Hpp = seg_p[:, :9].reshape(Pn, 3, 3)
    b_p = seg_p[:, 9:12]
    tF_sum = seg_p[:, 12:15]                             # Σ_k Jf·Jx per point

    Hpp_d = Hpp + jnp.eye(3, dtype=dtype) * (
        lam * jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-12)
    )[..., None, :] * jnp.eye(3, dtype=dtype)
    Hpp_inv = inv3x3(Hpp_d + 1e-18 * jnp.eye(3, dtype=dtype))
    # Live-obs count, NOT pt_ptr segment width: a point whose obs all have
    # w=0 must get Hpp_inv = 0, or its ~1/(λ·1e-12) pseudo-inverse amplifies
    # segment-sum roundoff into the matvec. The 0/1 counts are exact in f32.
    has_obs = seg_p[:, 15] > 0.5
    Hpp_inv = jnp.where(has_obs[:, None, None], Hpp_inv, 0.0)

    # --- camera-side blocks: one fused sorted segment sum ---
    Hk = jnp.einsum("kdi,kdj->kij", Jc_w, Jc_w).reshape(-1, 36)
    bk = jnp.einsum("kdi,kd->ki", Jc_w, e_w)             # (K, 6)
    fk = jnp.einsum("kd,kdj->kj", Jf_w[..., 0], Jc_w)    # (K, 6)
    U = jnp.einsum("kdi,kdj->kij", Jc_w, Jx_w)           # (K, 6, 3)
    Hpi_k = Hpp_inv[p.obs_pt]                            # (K, 3, 3)
    UHpi = jnp.einsum("kij,kjl->kil", U, Hpi_k)          # (K, 6, 3)
    Mk = jnp.einsum("kil,kjl->kij", UHpi, U).reshape(-1, 36)  # U·Hpp⁻¹·Uᵀ
    gk = jnp.einsum("kil,kl->ki", UHpi, b_p[p.obs_pt])   # U·Hpp⁻¹·b_p
    FHpi = jnp.einsum("pi,pij->pj", tF_sum, Hpp_inv)     # (P, 3)
    fck = jnp.einsum("kx,kjx->kj", FHpi[p.obs_pt], U)    # (K, 6)

    seg = _sorted_segment_sum(
        jnp.concatenate([Hk, bk, fk, Mk, gk, fck], axis=-1), p.cam_ptr
    )  # (C, 96)
    # Frozen parameter dims must be EXACT zeros: an all-frozen gauge block
    # that came back as ±roundoff was indefinite, its block-Jacobi Cholesky
    # went NaN, and PCG silently returned a zero step. The masks are known
    # statics of the problem; apply them everywhere the camera system is
    # touched (blocks, rhs, matvec, preconditioner).
    free_c = jnp.concatenate(
        [
            jnp.repeat((~p.trans_fixed).astype(dtype)[:, None], 3, -1),
            jnp.repeat((~p.rot_fixed).astype(dtype)[:, None], 3, -1),
        ],
        axis=-1,
    )  # (C, 6)
    pair_c = free_c[:, :, None] * free_c[:, None, :]
    Hcc = seg[:, :36].reshape(C, 6, 6) * pair_c
    b_c = seg[:, 36:42] * free_c
    Hfc = seg[:, 42:48] * free_c
    Mcc = seg[:, 48:84].reshape(C, 6, 6) * pair_c
    rc_red = seg[:, 84:90] * free_c
    Sfc_red = seg[:, 90:96] * free_c
    Hff = jnp.sum(Jf_w * Jf_w)
    b_f = jnp.sum(Jf_w[..., 0] * e_w)

    diagC = jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-12)
    Hcc_d = Hcc + jnp.eye(6, dtype=dtype) * (lam * diagC)[..., None, :] * jnp.eye(
        6, dtype=dtype
    )
    y0 = jnp.einsum("pij,pj->pi", Hpp_inv, b_p)
    S_ff = (Hff * (1.0 + lam) + 1e-12 - jnp.sum(FHpi * tF_sum)).astype(solve_dtype)
    r_c = ((b_c - rc_red) * free_c).astype(solve_dtype)
    r_f = (b_f - jnp.sum(tF_sum * y0)).astype(solve_dtype)

    return _ReducedSystem(
        e_w=e_w, Jf_w=Jf_w, Jc_w=Jc_w, Jx_w=Jx_w, U=U, Hpp=Hpp,
        Hpp_inv=Hpp_inv, b_p=b_p, tF_sum=tF_sum, FHpi=FHpi, free_c=free_c,
        Hcc_d=Hcc_d, Mcc=Mcc, Hfc=Hfc, Sfc_red=Sfc_red, b_c=b_c,
        rc_red=rc_red, Hff=Hff, b_f=b_f, diagC=diagC, S_ff=S_ff,
        r_c=r_c, r_f=r_f,
    )


def _assemble_reduced_planes(focal, cam_t, cam_r, points, p: BAProblem,
                             lam, loss_scale, solve_dtype) -> _ReducedSystem:
    """Plane-major `_assemble_reduced`: Jacobians, robust weighting, and
    every per-obs product stay (K,) component planes until the one stacked
    (d, K) segment-sum input — no (K, 2, 6)/(K, 6, 3) intermediates (whose
    low tile occupancy made the row-major assembly the dominant cost of the
    2000-camera PCG LM step on the chip this was first built for; waits
    for re-measurement on the GPU, ROADMAP 1.3). Produces the identical _ReducedSystem (same column
    order; symmetric entries share plane objects, so the decode matches
    `_assemble_reduced` exactly)."""
    C = p.cam_t.shape[0]
    Pn = p.points.shape[0]
    tg = cam_t[p.obs_cam]
    rg = cam_r[p.obs_cam]
    Xg = points[p.obs_pt]
    (e0, e1), (q0, q1), jc, jx = _soa_jacobian_planes(
        focal, tg[:, 0], tg[:, 1], tg[:, 2],
        rg[:, 0], rg[:, 1], rg[:, 2],
        Xg[:, 0], Xg[:, 1], Xg[:, 2],
        p.obs_uv[:, 0], p.obs_uv[:, 1],
    )
    dtype = e0.dtype

    # --- robust weights + frozen-parameter masks (plane form of
    # _weight_and_mask: sw into every block, masks zero frozen columns) ---
    s = e0 * e0 + e1 * e1
    w = cauchy_weight(s, loss_scale) * p.obs_w
    sw = jnp.sqrt(w)
    e0w = e0 * sw
    e1w = e1 * sw
    free_f = jnp.where(p.focal_fixed, 0.0, 1.0).astype(dtype)
    f0 = q0 * sw * free_f
    f1 = q1 * sw * free_f
    sw_t = (~p.trans_fixed).astype(dtype)[p.obs_cam] * sw
    sw_r = (~p.rot_fixed).astype(dtype)[p.obs_cam] * sw
    sw_x = (~p.point_fixed).astype(dtype)[p.obs_pt] * sw
    jcw = [(d0 * m, d1 * m) for (d0, d1), m in
           zip(jc, [sw_t] * 3 + [sw_r] * 3)]
    jxw = [(d0 * sw_x, d1 * sw_x) for (d0, d1) in jx]

    def dot2(a, b):
        return a[0] * b[0] + a[1] * b[1]

    # --- point-side: 16 columns in _assemble_reduced's exact order
    # [JxJx (3x3 row-major), bpk (3), fxk (3), wk_live (1)]; the symmetric
    # JxJx entries reuse one plane per unordered pair. The pt_order
    # permutation applies to the STACKED (K, 16) table as ONE row gather —
    # per-plane (K,) gathers were each several times dearer than one
    # 16-column row gather on the chip this was first built for.
    jxjx = {}
    for i in range(3):
        for j in range(i, 3):
            jxjx[(i, j)] = dot2(jxw[i], jxw[j])
    ew = (e0w, e1w)
    fw = (f0, f1)
    pt_planes = [jxjx[(min(i, j), max(i, j))]
                 for i in range(3) for j in range(3)]
    pt_planes += [dot2(jxw[i], ew) for i in range(3)]
    pt_planes += [dot2(fw, jxw[j]) for j in range(3)]
    pt_planes.append((p.obs_w > 0).astype(dtype))
    pt_tab = jnp.stack(pt_planes, axis=-1)[p.pt_order]    # (K, 16) rows
    seg_p = _sorted_segment_sum(pt_tab, p.pt_ptr)         # (P, 16)
    Hpp = seg_p[:, :9].reshape(Pn, 3, 3)
    b_p = seg_p[:, 9:12]
    tF_sum = seg_p[:, 12:15]

    Hpp_d = Hpp + jnp.eye(3, dtype=dtype) * (
        lam * jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-12)
    )[..., None, :] * jnp.eye(3, dtype=dtype)
    Hpp_inv = inv3x3(Hpp_d + 1e-18 * jnp.eye(3, dtype=dtype))
    has_obs = seg_p[:, 15] > 0.5
    Hpp_inv = jnp.where(has_obs[:, None, None], Hpp_inv, 0.0)

    # --- camera-side: 96 columns in the exact order
    # [Hk (6x6), bk (6), fk (6), Mk (6x6), gk (6), fck (6)].
    # All point-table reads ride ONE (K, 15) row gather (Hpp_inv 9, b_p 3,
    # FHpi 3) — see the scalar-gather note above.
    U = [[dot2(jcw[i], jxw[l]) for l in range(3)] for i in range(6)]
    FHpi = jnp.einsum("pi,pij->pj", tF_sum, Hpp_inv)      # (P, 3)
    pt_src = jnp.concatenate(
        [Hpp_inv.reshape(Pn, 9), b_p, FHpi], axis=-1)      # (P, 15)
    pt_rows = pt_src[p.obs_pt]                             # (K, 15)
    Hpi_g = [[pt_rows[:, 3 * i + j] for j in range(3)] for i in range(3)]
    bp_g = [pt_rows[:, 9 + l] for l in range(3)]
    FHpi_g = [pt_rows[:, 12 + x] for x in range(3)]
    UHpi = [[sum(U[i][m] * Hpi_g[m][l] for m in range(3)) for l in range(3)]
            for i in range(6)]
    mk = {}
    for i in range(6):
        for j in range(i, 6):
            mk[(i, j)] = sum(UHpi[i][l] * U[j][l] for l in range(3))
    hk = {}
    for i in range(6):
        for j in range(i, 6):
            hk[(i, j)] = dot2(jcw[i], jcw[j])
    cam_planes = [hk[(min(i, j), max(i, j))]
                  for i in range(6) for j in range(6)]
    cam_planes += [dot2(jcw[i], ew) for i in range(6)]
    cam_planes += [dot2(fw, jcw[j]) for j in range(6)]
    cam_planes += [mk[(min(i, j), max(i, j))]
                   for i in range(6) for j in range(6)]
    cam_planes += [sum(UHpi[i][l] * bp_g[l] for l in range(3))
                   for i in range(6)]
    cam_planes += [sum(FHpi_g[x] * U[j][x] for x in range(3))
                   for j in range(6)]
    seg = _sorted_segment_sum(jnp.stack(cam_planes, axis=-1), p.cam_ptr)

    free_c = jnp.concatenate(
        [
            jnp.repeat((~p.trans_fixed).astype(dtype)[:, None], 3, -1),
            jnp.repeat((~p.rot_fixed).astype(dtype)[:, None], 3, -1),
        ],
        axis=-1,
    )  # (C, 6)
    pair_c = free_c[:, :, None] * free_c[:, None, :]
    Hcc = seg[:, :36].reshape(C, 6, 6) * pair_c
    b_c = seg[:, 36:42] * free_c
    Hfc = seg[:, 42:48] * free_c
    Mcc = seg[:, 48:84].reshape(C, 6, 6) * pair_c
    rc_red = seg[:, 84:90] * free_c
    Sfc_red = seg[:, 90:96] * free_c
    Hff = jnp.sum(f0 * f0 + f1 * f1)
    b_f = jnp.sum(f0 * e0w + f1 * e1w)

    diagC = jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-12)
    Hcc_d = Hcc + jnp.eye(6, dtype=dtype) * (lam * diagC)[..., None, :] * (
        jnp.eye(6, dtype=dtype)
    )
    y0 = jnp.einsum("pij,pj->pi", Hpp_inv, b_p)
    S_ff = (
        Hff * (1.0 + lam) + 1e-12 - jnp.sum(FHpi * tF_sum)
    ).astype(solve_dtype)
    r_c = ((b_c - rc_red) * free_c).astype(solve_dtype)
    r_f = (b_f - jnp.sum(tF_sum * y0)).astype(solve_dtype)

    # stacked forms for matvec / back-substitution (contiguous per-plane
    # writes; the downstream per-LM-iteration einsums run once, not per
    # CG iteration)
    U_st = jnp.stack(
        [jnp.stack([U[i][l] for l in range(3)], axis=-1) for i in range(6)],
        axis=-2,
    )  # (K, 6, 3)
    e_w = jnp.stack([e0w, e1w], axis=-1)
    Jf_w = jnp.stack([f0, f1], axis=-1)[..., None]
    Jc_w = jnp.stack(
        [jnp.stack([d0, d1], axis=-1) for (d0, d1) in jcw], axis=-1
    )
    Jx_w = jnp.stack(
        [jnp.stack([d0, d1], axis=-1) for (d0, d1) in jxw], axis=-1
    )

    return _ReducedSystem(
        e_w=e_w, Jf_w=Jf_w, Jc_w=Jc_w, Jx_w=Jx_w, U=U_st, Hpp=Hpp,
        Hpp_inv=Hpp_inv, b_p=b_p, tF_sum=tF_sum, FHpi=FHpi, free_c=free_c,
        Hcc_d=Hcc_d, Mcc=Mcc, Hfc=Hfc, Sfc_red=Sfc_red, b_c=b_c,
        rc_red=rc_red, Hff=Hff, b_f=b_f, diagC=diagC, S_ff=S_ff,
        r_c=r_c, r_f=r_f,
    )


def _backsub_and_md(rs: _ReducedSystem, p: BAProblem, d_cam, d_f):
    """Point back-substitution (O(K) point-major) + exact model decrease
    −gᵀd − ½‖Jd‖² (Ceres model_cost_change, trust_region_minimizer.cc) —
    valid for ANY camera step, exact or inexact."""
    wk = jnp.einsum("kij,ki->kj", rs.U, d_cam[p.obs_cam])
    Wt_dx = _sorted_segment_sum(wk[p.pt_order], p.pt_ptr)
    Ft_dx = rs.tF_sum * d_f
    d_pts = jnp.einsum("pij,pj->pi", rs.Hpp_inv, -rs.b_p - Wt_dx - Ft_dx)
    Jd = (
        rs.Jf_w[..., 0] * d_f
        + jnp.einsum("kdi,ki->kd", rs.Jc_w, d_cam[p.obs_cam])
        + jnp.einsum("kdi,ki->kd", rs.Jx_w, d_pts[p.obs_pt])
    )  # (K, 2)
    gTd = (rs.b_f * d_f + jnp.sum(rs.b_c * d_cam)
           + jnp.sum(rs.b_p * d_pts))
    md = -gTd - 0.5 * jnp.sum(Jd * Jd)
    return d_pts, md


def _schur_solve_dense_pairs(
    e, Jf, Jc, Jx, p: BAProblem, lam, loss_scale, solve_dtype
):
    """Exact dense Schur camera solve with O(K + ΣT²) assembly.

    The off-diagonal blocks of S = Hcc − W Hpp⁻¹ Wᵀ are filled from the
    per-point observation-PAIR table (`cc_pair_a/b`, `cc_ptr` — built by
    `build_cc_pairs`): each pair (a, b) of observations of the same point
    contributes −U_a Hpp⁻¹ U_bᵀ to block (cam_a, cam_b), reduced by one
    sorted segment sum over the C² block keys. Unlike the track-table
    one-hot scan this costs nothing extra for long tracks paired with many
    cameras (the scan's (chunk, T, C) one-hot made dense assembly far
    slower than the Cholesky itself on 256-camera video maps), so the
    exact solver stayed the fastest choice through ~512 cameras on the chip
    this was first built for (scripts/bench_ba_forcing.py; ROADMAP 3.3). Same role as Ceres DENSE_SCHUR
    (sfm.cpp:200-212).
    """
    rs = _assemble_reduced(e, Jf, Jc, Jx, p, lam, loss_scale, solve_dtype)
    return _dense_pairs_from_rs(rs, p, lam, solve_dtype)


def _schur_solve_dense_pairs_planes(
    focal, cam_t, cam_r, points, p: BAProblem, lam, loss_scale, solve_dtype
):
    """dense_pairs step with plane-major Jacobians + assembly (see
    _assemble_reduced_planes)."""
    rs = _assemble_reduced_planes(focal, cam_t, cam_r, points, p, lam,
                                  loss_scale, solve_dtype)
    return _dense_pairs_from_rs(rs, p, lam, solve_dtype)


def _dense_pairs_from_rs(rs: _ReducedSystem, p: BAProblem, lam, solve_dtype):
    C = p.cam_t.shape[0]
    dtype = rs.b_p.dtype

    # --- off-diagonal fill from observation pairs ---
    # Chunked over pairs, with the contraction written as fusable
    # broadcast-multiply-sums. Both choices bound memory: a single
    # dot_general producing (Np, 6, 6) can get a padded tile layout on its
    # trailing dims (on the chip this was first built for it multiplied a
    # pair table's footprint ~28×). The broadcast form fuses into
    # the chunk's segment sum with no materialized (·, 6, 6) tensor, and the
    # scan bounds peak memory to one chunk regardless of fusion decisions.
    Np_total = p.cc_pair_a.shape[0]
    chunk = min(Np_total, 1 << 18)
    n_chunks = -(-Np_total // chunk)  # pair table is padded to a power of 2
    pa = p.cc_pair_a.reshape(n_chunks, chunk)
    pb = p.cc_pair_b.reshape(n_chunks, chunk)
    U = rs.U
    Hpi = rs.Hpp_inv
    obs_pt = p.obs_pt

    def pair_chunk(acc, xs):
        ia, ib, k = xs
        Ua = U[ia]                                        # (chunk, 6, 3)
        Ub = U[ib]
        Hpi_ab = Hpi[obs_pt[ia]]                          # (chunk, 3, 3)
        tmp = jnp.sum(Ua[:, :, :, None] * Hpi_ab[:, None, :, :], axis=2)
        Mab = jnp.sum(
            tmp[:, :, None, :] * Ub[:, None, :, :], axis=3
        ).reshape(chunk, 36)
        # segment-sum only this chunk's span of the C² block keys: clipped
        # pointers make each chunk's partial exact, and partials add.
        ptr_c = jnp.clip(p.cc_ptr, k * chunk, (k + 1) * chunk) - k * chunk
        return acc + _sorted_segment_sum(Mab, ptr_c), None

    off_flat, _ = jax.lax.scan(
        pair_chunk,
        jnp.zeros((C * C, 36), dtype),
        (pa, pb, jnp.arange(n_chunks)),
    )
    off = off_flat.reshape(C, C, 6, 6)
    # frozen dims: exact zeros (same masking rationale as the diagonal)
    off = off * (rs.free_c[:, None, :, None] * rs.free_c[None, :, None, :])
    S_cc = -(off + jnp.transpose(off, (1, 0, 3, 2)))
    S_cc = S_cc.at[jnp.arange(C), jnp.arange(C)].add(rs.Hcc_d - rs.Mcc)
    S_fc = rs.Hfc - rs.Sfc_red

    d_cam, d_f = _dense_schur_factor_solve(
        S_cc, S_fc, rs.S_ff, rs.r_c, rs.r_f, solve_dtype, dtype, C
    )
    d_pts, md = _backsub_and_md(rs, p, d_cam, d_f)
    return d_f, d_cam, d_pts, md


def _dense_schur_factor_solve(S_cc, S_fc, S_ff, r_c, r_f, solve_dtype,
                              dtype, C):
    """Equilibrated Cholesky solve of the assembled (6C+1)² reduced system."""
    D = 6 * C + 1
    S = jnp.zeros((D, D), solve_dtype)
    S = S.at[: 6 * C, : 6 * C].set(
        S_cc.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C).astype(solve_dtype)
    )
    S = S.at[6 * C, : 6 * C].set(S_fc.reshape(-1).astype(solve_dtype))
    S = S.at[: 6 * C, 6 * C].set(S_fc.reshape(-1).astype(solve_dtype))
    S = S.at[6 * C, 6 * C].set(jnp.asarray(S_ff, solve_dtype))
    rhs = jnp.concatenate(
        [r_c.reshape(-1), jnp.asarray(r_f, solve_dtype)[None]]
    )
    dscale = jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
    S_eq = S / dscale[:, None] / dscale[None, :]
    S_eq = S_eq + 1e-10 * jnp.eye(D, dtype=solve_dtype)
    # XLA cholesky + triangular solves: inside the fused LM body the
    # blocked-scan alternative (ops/linalg.py::block_chol_solve) was
    # SLOWER on the chip this was first built for (its 2·D/b sequential
    # scan steps don't overlap with anything); not re-measured on the GPU.
    L = jnp.linalg.cholesky(S_eq)
    y = jax.scipy.linalg.solve_triangular(L, -(rhs / dscale), lower=True)
    dx = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    dx = (dx / dscale).astype(dtype)
    return dx[: 6 * C].reshape(C, 6), dx[6 * C]


def _schur_solve_pcg(
    e, Jf, Jc, Jx, p: BAProblem, lam, loss_scale, solve_dtype,
    pcg_iters, pcg_rtol, coarse_group=16, x0_c=None, x0_f=None,
):
    """Matrix-free Schur step: block-Jacobi preconditioned CG camera solve.

    Never materializes the (C, C, 6, 6) reduced system — the matrix-free
    answer to Ceres SPARSE_SCHUR (sfm.cpp:200-212) at the reference's
    every-frame-is-a-keyframe scale (thousands of cameras). Requires
    `p.cam_ptr`/`p.pt_ptr` (the observation table sorted by camera, plus the
    point-major permutation of it): every reduction — camera side AND point
    side — is an O(K) sorted segment sum, so the cost per CG iteration is
    O(K·18) with no C² term and no dependence on the LONGEST track (the
    track table pads every point to max track length, which is ruinous on
    real video maps where a few tracks span hundreds of frames while the
    mean is ~3). The track table is used only to build the coarse-grid
    preconditioner, with track length capped (truncation only weakens the
    preconditioner — the subtracted Galerkin term shrinks, so it stays SPD).
    """
    rs = _assemble_reduced(e, Jf, Jc, Jx, p, lam, loss_scale, solve_dtype)
    return _pcg_from_rs(rs, p, lam, solve_dtype, pcg_iters, pcg_rtol,
                        coarse_group, x0_c, x0_f)


def _schur_solve_pcg_planes(
    focal, cam_t, cam_r, points, p: BAProblem, lam, loss_scale, solve_dtype,
    pcg_iters, pcg_rtol, coarse_group=16, x0_c=None, x0_f=None,
):
    """PCG Schur step with plane-major Jacobians + assembly (the fast path;
    see _assemble_reduced_planes). Same result as `_schur_solve_pcg` on
    `_per_obs_jacobians_soa` output, to roundoff."""
    rs = _assemble_reduced_planes(focal, cam_t, cam_r, points, p, lam,
                                  loss_scale, solve_dtype)
    return _pcg_from_rs(rs, p, lam, solve_dtype, pcg_iters, pcg_rtol,
                        coarse_group, x0_c, x0_f)


def _pcg_from_rs(rs: _ReducedSystem, p: BAProblem, lam, solve_dtype,
                 pcg_iters, pcg_rtol, coarse_group=16, x0_c=None, x0_f=None):
    C = p.cam_t.shape[0]
    dtype = rs.b_p.dtype
    U, Hpp_inv, tF_sum, FHpi = rs.U, rs.Hpp_inv, rs.tF_sum, rs.FHpi
    b_p, free_c = rs.b_p, rs.free_c
    Hcc_d, Mcc, Hfc = rs.Hcc_d, rs.Mcc, rs.Hfc
    Hff, S_ff, r_c, r_f = rs.Hff, rs.S_ff, rs.r_c, rs.r_f
    Hff_d = (Hff * (1.0 + lam) + 1e-12).astype(solve_dtype)
    Hfc_s = Hfc.astype(solve_dtype)                       # (C, 6)

    # --- block-Jacobi preconditioner from the exact Schur diagonal blocks
    # (each (camera, point) pair observed once ⇒ Σ_k U_k Hpp⁻¹ U_kᵀ is the
    # true diagonal correction). Clamped to stay SPD under f32 rounding and
    # frozen-parameter zero rows.
    Pc = (Hcc_d - Mcc.reshape(C, 6, 6)).astype(solve_dtype)
    eps = 1e-6 * jnp.maximum(
        jnp.trace(Pc, axis1=-2, axis2=-1) / 6.0, 1e-12
    )[:, None, None] * jnp.eye(6, dtype=solve_dtype) + 1e-30 * jnp.eye(
        6, dtype=solve_dtype
    )
    Lp = jnp.linalg.cholesky(Pc + eps)
    bad = ~jnp.all(jnp.isfinite(Lp), axis=(-2, -1))
    Lp_fallback = jnp.linalg.cholesky(Hcc_d.astype(solve_dtype) + eps)
    Lp = jnp.where(bad[:, None, None], Lp_fallback, Lp)
    Pf = jnp.maximum(S_ff, 1e-30)

    # --- coarse-grid level: aggregate groups of `coarse_group` consecutive
    # cameras and solve the Galerkin-restricted Schur system densely. On the
    # near-banded co-visibility graph of a spherical capture the block-Jacobi
    # level only propagates information one camera per CG iteration; the
    # coarse solve carries the smooth long-range (ring) modes in one shot —
    # two-level additive Schwarz, M⁻¹ = J⁻¹ + R S_G⁻¹ Rᵀ.
    use_coarse = bool(coarse_group) and C > 2 * int(coarse_group)
    if use_coarse:
        g = int(coarse_group)
        G = -(-C // g)
        Cp = G * g

        def padC(x):
            return jnp.zeros((Cp,) + x.shape[1:], x.dtype).at[: x.shape[0]].set(x)

        # per-point per-group aggregates V[p, G, 6, 3] = Σ_{a: grp(cam)=G} U_a,
        # chunked over points to bound one-hot memory (chunk × T × G). The
        # track table is used ONLY here, with track length capped: a
        # truncated V only shrinks the subtracted Galerkin term, so the
        # coarse system stays SPD — it is a preconditioner, not the operator.
        Tc = min(p.track_obs.shape[1], 32)
        tob = p.track_obs[:, :Tc]
        tmk = p.track_mask[:, :Tc]
        tU = U[tob] * tmk.astype(dtype)[..., None, None]     # (P, Tc, 6, 3)
        tcam = jnp.where(tmk, p.obs_cam[tob], C)             # (P, Tc)
        P_pts = p.points.shape[0]
        chunkc = max(1, min(P_pts, 2048))
        nch = -(-P_pts // chunkc)

        def padP(x):
            return jnp.zeros((nch * chunkc,) + x.shape[1:], x.dtype).at[
                : x.shape[0]
            ].set(x)

        tgrp = jnp.where(tmk, jnp.minimum(tcam // g, G), G)
        tU_ch = padP(tU).reshape(nch, chunkc, Tc, 6, 3)
        tg_ch = padP(tgrp).reshape(nch, chunkc, Tc)
        Hpi_ch = padP(Hpp_inv).reshape(nch, chunkc, 3, 3)

        def coarse_body(acc, xs):
            tUc, tg, Hic = xs
            oh = (tg[..., None] == jnp.arange(G)[None, None, :]).astype(dtype)
            V = jnp.einsum("ptg,ptix->pgix", oh, tUc)       # (chunk, G, 6, 3)
            VH = jnp.einsum("pgix,pxy->pgiy", V, Hic)
            return acc + jnp.einsum("pgiy,phjy->ghij", VH, V), None

        Sg_red, _ = jax.lax.scan(
            coarse_body,
            jnp.zeros((G, G, 6, 6), dtype),
            (tU_ch, tg_ch, Hpi_ch),
        )
        Hg = padC(Hcc_d).reshape(G, g, 6, 6).sum(1)         # Rᵀ Hcc_d R
        Sg = -Sg_red.at[jnp.arange(G), jnp.arange(G)].add(-Hg)
        Sfc_g = padC(Hfc - rs.Sfc_red).reshape(G, g, 6).sum(1)  # (G, 6)

        Dg = 6 * G + 1
        Sg_full = jnp.zeros((Dg, Dg), solve_dtype)
        Sg_full = Sg_full.at[: 6 * G, : 6 * G].set(
            Sg.transpose(0, 2, 1, 3).reshape(6 * G, 6 * G).astype(solve_dtype)
        )
        Sg_full = Sg_full.at[6 * G, : 6 * G].set(
            Sfc_g.reshape(-1).astype(solve_dtype)
        )
        Sg_full = Sg_full.at[: 6 * G, 6 * G].set(
            Sfc_g.reshape(-1).astype(solve_dtype)
        )
        Sg_full = Sg_full.at[6 * G, 6 * G].set(S_ff)
        gscale = jnp.sqrt(jnp.maximum(jnp.diagonal(Sg_full), 1e-12))
        Sg_eq = Sg_full / gscale[:, None] / gscale[None, :]
        # 1e-4 ridge on the unit-equilibrated diagonal: the Galerkin coarse
        # system is SPD in exact arithmetic but only barely at small λ, and
        # f32 rounding (eps ≈ 1.2e-7) tips it indefinite. A failed factor
        # must NOT poison the preconditioner — a NaN Lg made every precond
        # output NaN, the PCG loop's isfinite guard then never ran a single
        # iteration, and the silent zero step stalled LM at small λ (2× worse
        # final cost than the dense solver at C=256).
        Lg = jnp.linalg.cholesky(
            Sg_eq + 1e-4 * jnp.eye(Dg, dtype=solve_dtype)
        )
        coarse_ok = jnp.all(jnp.isfinite(Lg))
        Lg = jnp.where(coarse_ok, Lg, jnp.eye(Dg, dtype=solve_dtype))

    U_s = U.astype(solve_dtype)
    Hpi_s = Hpp_inv.astype(solve_dtype)
    Hcc_ds = Hcc_d.astype(solve_dtype)
    tF_s = tF_sum.astype(solve_dtype)
    free_cs = free_c.astype(solve_dtype)
    obs_pt = p.obs_pt
    obs_cam = p.obs_cam

    def matvec(vc, vf):
        # point side: y_p = Wᵀ vc + F vf, z_p = Hpp⁻¹ y_p — all per-obs +
        # point-major segment sum, O(K) regardless of track-length skew. The
        # point reduction of BOTH the camera and the focal coupling rides
        # through z, so the camera/focal terms use the RAW couplings:
        #   out_c = Hcc_d vc + Hfc vf − W z  = S_cc vc + S_cf vf
        #   out_f = Hfc·vc + Hff_d vf − F·z  = S_fc·vc + S_ff vf
        yk = jnp.einsum("kij,ki->kj", U_s, vc[obs_cam])     # Uᵀ vc per obs
        y = _sorted_segment_sum(yk[p.pt_order], p.pt_ptr) + tF_s * vf
        z = jnp.einsum("pij,pj->pi", Hpi_s, y)
        # camera side: (W z)[c] via camera-major segment sum
        wk = jnp.einsum("kij,kj->ki", U_s, z[obs_pt])
        Wz = _sorted_segment_sum(wk, p.cam_ptr)
        # free_cs mask: Wz's segment-sum roundoff must not re-inject
        # components into frozen dims (see the assembly masking above).
        out_c = (
            jnp.einsum("cij,cj->ci", Hcc_ds, vc) - Wz + Hfc_s * vf
        ) * free_cs
        out_f = jnp.sum(Hfc_s * vc) + Hff_d * vf - jnp.sum(tF_s * z)
        return out_c, out_f

    def precond(rc, rf):
        yv = jax.scipy.linalg.solve_triangular(
            Lp, rc[..., None], lower=True
        )
        zc = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(Lp, -1, -2), yv, lower=False
        )[..., 0]
        zf = rf / Pf
        if use_coarse:
            rG = padC(rc).reshape(G, g, 6).sum(1)
            rhs = jnp.concatenate([rG.reshape(-1), rf[None]]) / gscale
            yg = jax.scipy.linalg.solve_triangular(Lg, rhs, lower=True)
            xg = jax.scipy.linalg.solve_triangular(
                Lg.T, yg, lower=False
            ) / gscale
            xg = jnp.where(coarse_ok, xg, 0.0)  # drop level, keep Jacobi
            zc = zc + jnp.repeat(xg[: 6 * G].reshape(G, 6), g, axis=0)[:C]
            zf = zf + xg[6 * G]
        return zc * free_cs, zf

    b_cs = -r_c
    b_fs = -r_f
    bnorm2 = jnp.sum(b_cs * b_cs) + b_fs * b_fs

    # Warm start from the previous LM iteration's camera step: consecutive
    # Schur systems differ only in λ and the relinearization, so the old
    # step is a far better initial iterate than 0 once LM settles — the
    # same inner cap then reaches a smaller residual.
    if x0_c is None:
        xc0 = jnp.zeros((C, 6), solve_dtype)
        xf0 = jnp.zeros((), solve_dtype)
        r0c, r0f = b_cs, b_fs
    else:
        xc0 = (x0_c * free_c).astype(solve_dtype)
        xf0 = jnp.asarray(x0_f, solve_dtype)
        Ax_c, Ax_f = matvec(xc0, xf0)
        r0c = b_cs - Ax_c
        r0f = b_fs - Ax_f
        # fall back to the zero start if the warm iterate is worse/non-finite
        ok0 = jnp.isfinite(jnp.sum(r0c * r0c) + r0f * r0f) & (
            jnp.sum(r0c * r0c) + r0f * r0f <= bnorm2
        )
        xc0 = jnp.where(ok0, xc0, 0.0)
        xf0 = jnp.where(ok0, xf0, 0.0)
        r0c = jnp.where(ok0, r0c, b_cs)
        r0f = jnp.where(ok0, r0f, b_fs)

    z0c, z0f = precond(r0c, r0f)
    state0 = (
        xc0, xf0,                                                    # x
        r0c, r0f,                                                    # r
        z0c, z0f,                                                    # p dir
        jnp.sum(r0c * z0c) + r0f * z0f,                              # rz
        jnp.asarray(0),
    )

    def pcg_cond(st):
        _, _, rc, rf, _, _, rz, it = st
        rnorm2 = jnp.sum(rc * rc) + rf * rf
        return (
            (it < pcg_iters)
            & (rnorm2 > pcg_rtol * pcg_rtol * jnp.maximum(bnorm2, 1e-30))
            & jnp.isfinite(rz)
        )

    def pcg_body(st):
        xc, xf, rc, rf, pc, pf, rz, it = st
        Apc, Apf = matvec(pc, pf)
        denom = jnp.sum(pc * Apc) + pf * Apf
        # Non-positive curvature means f32 rounding has made the operator
        # indefinite along pc: stop with the current iterate, as Ceres's CG
        # does ("matrix is indefinite"), instead of stepping along it.
        curved = denom > 1e-30
        alpha = jnp.where(curved, rz / jnp.where(curved, denom, 1.0), 0.0)
        xc = xc + alpha * pc
        xf = xf + alpha * pf
        rc = rc - alpha * Apc
        rf = rf - alpha * Apf
        zc, zf = precond(rc, rf)
        rz_new = jnp.sum(rc * zc) + rf * zf
        beta = rz_new / jnp.where(jnp.abs(rz) > 1e-30, rz, 1e-30)
        pc = zc + beta * pc
        pf = zf + beta * pf
        return (xc, xf, rc, rf, pc, pf, rz_new,
                jnp.where(curved, it + 1, pcg_iters))

    xc, xf, *_ = jax.lax.while_loop(pcg_cond, pcg_body, state0)
    d_cam = xc.astype(dtype)
    d_f = xf.astype(dtype)
    d_pts, md = _backsub_and_md(rs, p, d_cam, d_f)
    return d_f, d_cam, d_pts, md


def sort_obs_by_camera(p: BAProblem) -> BAProblem:
    """Host-side: sort the observation table by camera and attach `cam_ptr`.

    Required by the PCG camera solve. The track table is remapped through the
    permutation; outputs (cameras/points) are unaffected.
    """
    import numpy as np

    obs_cam = np.asarray(p.obs_cam)
    order = np.argsort(obs_cam, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    C = p.cam_t.shape[0]
    counts = np.bincount(obs_cam, minlength=C)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    # point-major permutation of the camera-sorted table
    obs_pt_sorted = np.asarray(p.obs_pt)[order]
    P = p.points.shape[0]
    pt_order = np.argsort(obs_pt_sorted, kind="stable").astype(np.int32)
    pt_counts = np.bincount(obs_pt_sorted, minlength=P)
    pt_ptr = np.concatenate([[0], np.cumsum(pt_counts)]).astype(np.int32)
    return p._replace(
        obs_cam=jnp.asarray(obs_cam[order]),
        obs_pt=jnp.asarray(obs_pt_sorted),
        obs_uv=jnp.asarray(np.asarray(p.obs_uv)[order]),
        obs_w=jnp.asarray(np.asarray(p.obs_w)[order]),
        track_obs=jnp.asarray(inv[np.asarray(p.track_obs)].astype(np.int32)),
        cam_ptr=jnp.asarray(ptr),
        pt_order=jnp.asarray(pt_order),
        pt_ptr=jnp.asarray(pt_ptr),
    )


def _live_point_runs(p: BAProblem):
    """Host-side: point-major obs indices restricted to LIVE (w>0) rows,
    with their per-point run lengths. Padding observations (w=0) must not
    enter the pair tables: they contribute zero but would inflate a padded
    point's track length quadratically."""
    import numpy as np

    pt_order = np.asarray(p.pt_order).astype(np.int64)
    w = np.asarray(p.obs_w)
    live = pt_order[w[pt_order] > 0]          # camera-ascending within point
    obs_pt = np.asarray(p.obs_pt).astype(np.int64)
    L = np.bincount(obs_pt[live], minlength=p.points.shape[0])
    return live, L


def count_cc_pairs(p: BAProblem) -> int:
    """Host-side: ΣT(T−1)/2 over points' LIVE observations — the pair-table
    size the pairs-dense assembly would need (cheap solver-choice probe)."""
    _, L = _live_point_runs(p)
    return int((L * (L - 1) // 2).sum())


def build_cc_pairs(p: BAProblem) -> BAProblem:
    """Host-side: per-point observation-pair tables for the pairs-dense
    Schur assembly (`_schur_solve_dense_pairs`). Requires
    `sort_obs_by_camera` first.

    Within a point's point-major run the observations are camera-ascending
    (stable sort over the camera-sorted table), so ordered pairs (a < b)
    land strictly in the upper triangle of the (C, C) block grid — the
    lower triangle is filled by transposition on device. The pair count is
    padded to the next power of two (padding pairs sit past the last
    `cc_ptr` bound, so they are never summed) to bound shape churn.
    """
    import numpy as np

    C = p.cam_t.shape[0]
    obs_cam = np.asarray(p.obs_cam).astype(np.int64)
    live, L = _live_point_runs(p)
    K = len(live)
    starts = np.concatenate([[0], np.cumsum(L)[:-1]])
    grp = np.repeat(np.arange(len(L)), L)               # point of each slot
    pos = np.arange(K) - np.repeat(starts, L)           # index within run
    cnt = L[grp] - 1 - pos                              # pairs led by slot
    total = int(cnt.sum())
    a_slot = np.repeat(np.arange(K), cnt)
    off = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    b_slot = a_slot + 1 + off
    pair_a = live[a_slot]
    pair_b = live[b_slot]
    key = obs_cam[pair_a] * C + obs_cam[pair_b]
    order = np.argsort(key, kind="stable")
    pair_a, pair_b, key = pair_a[order], pair_b[order], key[order]
    cc_ptr = np.zeros(C * C + 1, np.int64)
    cc_ptr[1:] = np.cumsum(np.bincount(key, minlength=C * C))
    npad = 1 << max(int(np.ceil(np.log2(max(total, 1)))), 6)
    pair_a = np.pad(pair_a, (0, npad - total))
    pair_b = np.pad(pair_b, (0, npad - total))
    return p._replace(
        cc_pair_a=jnp.asarray(pair_a.astype(np.int32)),
        cc_pair_b=jnp.asarray(pair_b.astype(np.int32)),
        cc_ptr=jnp.asarray(cc_ptr.astype(np.int32)),
    )


# HBM bound on the observation-pair table (see prepare_problem)
_DENSE_PAIRS_CAP = 5_000_000


def bundle_adjust(
    p: BAProblem,
    max_iters: int = 50,
    loss_scale: float = 1.0,
    init_lambda: float = 1e-4,
    init_dec: float = 2.0,
    ftol: float = 1e-9,
    solve_dtype_name: str = "float64",
    camera_solver: str = "auto",
    pcg_iters: int = 200,
    pcg_rtol: float = 1e-8,
    pcg_coarse: int = 0,
    matmul_precision: str = "highest",
) -> BAResult:
    """Robust LM bundle adjustment; returns the optimized state.

    Semantics match SfM::Optimize (sfm.cpp:228-290): Cauchy(1.0) loss,
    frozen-parameter masks, trust-region LM. `camera_solver` picks the Schur
    camera solve: "dense" (exact (6C+1)² Cholesky, one-hot-scan assembly),
    "dense_pairs" (same exact solve, O(ΣT²) observation-pair assembly for
    long-track maps), "pcg" (matrix-free block-Jacobi CG — scales past the
    dense wall, the Ceres SPARSE_SCHUR analogue), or "auto" (pcg above 512
    cameras; below that the faster of the two exact assemblies by predicted
    cost — scan ∝ P·Tmax·C matmul work vs pairs ∝ ΣT² gather-bound).
    `pcg_coarse` > 0 adds an aggregated coarse-grid level to the
    preconditioner (off by default: with the 25-iteration inexact-Newton
    cap its Galerkin setup cost per LM iteration outweighed the CG
    iterations it saved on the 2000-camera ring, measured on another chip).
    The dispatch constants were all chosen on another chip and wait for
    re-derivation on the H100 (ROADMAP 3.3).
    """
    p, camera_solver = prepare_problem(p, camera_solver, pcg_coarse)
    return _bundle_adjust_jit(
        p, max_iters=max_iters, loss_scale=loss_scale,
        init_lambda=init_lambda, init_dec=init_dec, ftol=ftol,
        solve_dtype_name=solve_dtype_name, camera_solver=camera_solver,
        pcg_iters=pcg_iters, pcg_rtol=pcg_rtol, pcg_coarse=pcg_coarse,
        matmul_precision=matmul_precision,
    )


def prepare_problem(
    p: BAProblem, camera_solver: str = "auto", pcg_coarse: int = 0
) -> tuple[BAProblem, str]:
    """Host-side problem prep shared by the single-chip and distributed
    entry points: resolve the "auto" camera solver, sort/index the
    observation table, build pair tables, and drop the track table when the
    chosen solver never reads it. Must run BEFORE any mesh layout
    (`parallel.sharded.shard_ba_problem`) — it fetches arrays to the host.
    """
    C = p.cam_t.shape[0]
    pick_dense_flavor = False
    if camera_solver == "auto":
        # The 512-camera switch to the matrix-free PCG was chosen on
        # another chip (scripts/bench_ba_forcing.py: the exact dense solve
        # was faster per LM iteration and reached a lower cost below it;
        # past it the (C,C,6,6) reduced system's memory and O(C³)
        # factorization take over). It waits for re-derivation on the
        # H100 (ROADMAP 3.3). Which
        # dense ASSEMBLY wins is workload-dependent and decided below once
        # the pair count is known.
        if C > 512:
            camera_solver = "pcg"
        elif C > 32:
            pick_dense_flavor = True
        else:
            camera_solver = "dense"
    if (camera_solver in ("pcg", "dense_pairs") or pick_dense_flavor) and (
        p.cam_ptr is None or p.pt_ptr is None
    ):
        p = sort_obs_by_camera(p)
    if pick_dense_flavor:
        # Two exact dense assemblies with opposite scaling: the one-hot
        # track-table scan is matmul work ∝ P·Tmax·C (ruinous when a video
        # map pairs 256-long tracks with hundreds of cameras), while the
        # observation-pair fill is GATHER-bound work ∝ ΣT² (three random
        # 18/9-float gathers per pair). Pick by predicted cost; the scan additionally
        # requires a COMPLETE track table (a truncated one silently drops
        # observations from the point blocks only).
        import numpy as np

        n_live = int(np.count_nonzero(np.asarray(p.obs_w) > 0))
        tracked = (
            np.asarray(p.track_mask)
            & (np.asarray(p.obs_w)[np.asarray(p.track_obs)] > 0)
        )
        track_complete = int(np.count_nonzero(tracked)) >= n_live
        scan_elems = p.points.shape[0] * p.track_obs.shape[1] * C
        slots = p.points.shape[0] * p.track_obs.shape[1]
        npairs = count_cc_pairs(p)
        # The 500× scan-element/pair ratio and the 8M-slot guard (~5 GB
        # peak of (P,T,·) payloads) were chosen on another chip with less
        # memory (scripts/bench_ba_video.py) and wait for re-derivation on
        # the 80 GB H100 (ROADMAP 3.3).
        if track_complete and slots <= 8_000_000 and (
            scan_elems < 500 * max(npairs, 1)
        ):
            camera_solver = "dense"
        else:
            camera_solver = "dense_pairs"
    if camera_solver == "dense_pairs" and p.cc_ptr is None:
        # Pair-table memory bound: the fill materializes ~400 B/pair of
        # gathers + contractions on device (Ua/Ub/Hpi/Mab), so a long-track
        # video map's ΣT² can exhaust device memory. _DENSE_PAIRS_CAP was
        # sized for a chip with less memory and waits for re-derivation on
        # the 80 GB H100 (ROADMAP 3.3); above it the matrix-free PCG runs
        # instead.
        if count_cc_pairs(p) > _DENSE_PAIRS_CAP:
            camera_solver = "pcg"
        else:
            p = build_cc_pairs(p)
    if camera_solver == "dense_pairs" or (
        camera_solver == "pcg" and pcg_coarse == 0
    ):
        # These solvers never read the track table; its max-track-length
        # axis is data-dependent and would needlessly fragment the jit
        # cache (one ~30 s XLA compile per distinct longest track).
        if p.track_obs.shape[1] > 1:
            Pn = p.points.shape[0]
            p = p._replace(
                track_obs=jnp.zeros((Pn, 1), jnp.int32),
                track_mask=jnp.zeros((Pn, 1), bool),
            )
    return p, camera_solver


def bundle_adjust_checkpointed(
    p: BAProblem,
    checkpoint_path: str,
    max_iters: int = 50,
    segment: int = 10,
    **kw,
) -> BAResult:
    """LM bundle adjustment in segments with atomic on-disk checkpoints
    (SURVEY §5.3/§5.4: failure recovery for long BA runs — the reference has
    none; a killed Ceres solve restarts from scratch).

    Runs `segment` LM iterations per device call; after each segment the full
    optimizer state (focal, poses, points, damping, iteration count, cost
    trace) is written to `checkpoint_path` via a same-directory rename, so a
    crash can never leave a torn file. Re-invoking with the same arguments
    resumes from the last completed segment; the trajectory is identical to
    an uninterrupted segmented run because the LM damping is persisted and
    re-seeded (the loop carries no other cross-iteration state).
    """
    import os

    import numpy as np

    it0 = 0
    c0 = None
    if os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            it0 = int(ck["iterations"])
            c0 = float(ck["initial_cost"])
            p = p._replace(
                focal=jnp.asarray(ck["focal"], p.points.dtype),
                cam_t=jnp.asarray(ck["cam_t"], p.points.dtype),
                cam_r=jnp.asarray(ck["cam_r"], p.points.dtype),
                points=jnp.asarray(ck["points"], p.points.dtype),
            )
            kw = dict(kw, init_lambda=float(ck["lam"]),
                      init_dec=float(ck["dec"]) if "dec" in ck else 2.0)

    res = None
    while it0 < max_iters:
        n = min(segment, max_iters - it0)
        res = bundle_adjust(p, max_iters=n, **kw)
        if c0 is None:
            c0 = float(res.initial_cost)
        it0 += int(res.iterations)
        p = p._replace(focal=res.focal, cam_t=res.cam_t, cam_r=res.cam_r,
                       points=res.points)
        kw = dict(kw, init_lambda=res.lam, init_dec=res.dec)
        tmp = checkpoint_path + ".tmp.npz"
        np.savez(
            tmp, focal=np.asarray(res.focal), cam_t=np.asarray(res.cam_t),
            cam_r=np.asarray(res.cam_r), points=np.asarray(res.points),
            lam=np.asarray(res.lam), dec=np.asarray(res.dec),
            iterations=it0, initial_cost=c0,
            cost=np.asarray(res.cost),
        )
        os.replace(tmp, checkpoint_path)
        if int(res.iterations) < n:  # converged inside the segment
            break
    if res is None:  # checkpoint already at/after max_iters
        res = bundle_adjust(p, max_iters=0, **kw)
    return res._replace(iterations=jnp.asarray(it0),
                        initial_cost=jnp.asarray(c0, res.points.dtype))


@partial(
    jax.jit,
    static_argnames=(
        "max_iters", "loss_scale", "solve_dtype_name", "camera_solver",
        "pcg_iters", "pcg_rtol", "pcg_coarse", "matmul_precision",
    ),
)
def _bundle_adjust_jit(
    p: BAProblem,
    max_iters: int = 50,
    loss_scale: float = 1.0,
    init_lambda: float = 1e-4,
    init_dec: float = 2.0,
    ftol: float = 1e-9,
    solve_dtype_name: str = "float64",
    camera_solver: str = "dense",
    pcg_iters: int = 200,
    pcg_rtol: float = 1e-8,
    pcg_coarse: int = 0,
    matmul_precision: str = "highest",
) -> BAResult:
    solve_dtype = jnp.dtype(solve_dtype_name)
    dtype = p.points.dtype

    # A backend's default matmul precision may round f32 INPUTS (bf16 on
    # the chip this was first built for, TF32 on the GPU) — a ~1e-3..1e-2
    # relative error in every Hessian contraction and PCG matvec. Harmless
    # early on, but near convergence the true step shrinks below that
    # noise floor and LM stalls far above the real optimum (with bf16
    # inputs the 256-camera ring ended at 2.5× the f32 cost). Whether these
    # contractions hold under TF32 is ROADMAP 1.6. The
    # context applies at trace time, so it covers the while_loop body too.
    # `matmul_precision` exists so the 3-pass "high" mode can be measured
    # against the 6-pass default on real workloads (scripts/bench_ba_precision.py).
    with jax.default_matmul_precision(matmul_precision):
        return _ba_lm_loop(
            p, max_iters, loss_scale, init_lambda, init_dec, ftol,
            solve_dtype, dtype, camera_solver, pcg_iters, pcg_rtol,
            pcg_coarse,
        )


def _ba_lm_loop(
    p, max_iters, loss_scale, init_lambda, init_dec, ftol,
    solve_dtype, dtype, camera_solver, pcg_iters, pcg_rtol, pcg_coarse,
) -> BAResult:
    # Slot-major tables for the dense-scan solver: loop-invariant gathers
    # hoisted out of the while_loop (see _SlotTables).
    st = _build_slot_tables(p, dtype) if camera_solver == "dense" else None

    def cost_of(state):
        f, ct, cr, pts = state
        if camera_solver == "dense":
            # Same value as ba_cost on a complete track table (the
            # dense-scan dispatch requirement), with no per-obs gathers.
            return _ba_cost_slots(f, ct, cr, pts, st, p, loss_scale)
        return _ba_cost_obs_soa(f, ct, cr, pts, p, loss_scale)

    def body(carry):
        f, ct, cr, pts, lam, dec, cost, it, done, dc_prev, df_prev = carry
        if camera_solver == "pcg":
            d_f, d_cam, d_pts, md = _schur_solve_pcg_planes(
                f, ct, cr, pts, p, lam, loss_scale, solve_dtype,
                pcg_iters, pcg_rtol, pcg_coarse,
                x0_c=dc_prev, x0_f=df_prev,
            )
        elif camera_solver == "dense_pairs":
            d_f, d_cam, d_pts, md = _schur_solve_dense_pairs_planes(
                f, ct, cr, pts, p, lam, loss_scale, solve_dtype
            )
        else:
            d_f, d_cam, d_pts, md = _schur_solve_slots(
                f, ct, cr, pts, st, p, lam, loss_scale, solve_dtype
            )
        f_n = f + d_f
        ct_n = ct + d_cam[:, :3]
        cr_n = cr + d_cam[:, 3:]
        pts_n = pts + d_pts
        new_cost = cost_of((f_n, ct_n, cr_n, pts_n))
        # Ceres trust-region step control (levenberg_marquardt_strategy.cc /
        # trust_region_minimizer.cc): accept when step quality
        # ρ = actual/model decrease exceeds min_relative_decrease (1e-3);
        # radius (1/λ) grows by the (2ρ−1)³ rule on success and halves with a
        # doubling back-off on failure.
        rho = (cost - new_cost) / jnp.maximum(md, 1e-30)
        ok = jnp.isfinite(new_cost) & (md > 0) & (rho > 1e-3)
        grow = jnp.maximum(
            jnp.asarray(1.0 / 3.0, dtype),
            1.0 - (2.0 * rho.astype(dtype) - 1.0) ** 3,
        )
        lam = jnp.where(ok, jnp.maximum(lam * grow, 1e-16), lam * dec)
        dec = jnp.where(ok, jnp.asarray(2.0, dtype), dec * 2.0)
        f = jnp.where(ok, f_n, f)
        ct = jnp.where(ok, ct_n, ct)
        cr = jnp.where(ok, cr_n, cr)
        pts = jnp.where(ok, pts_n, pts)
        rel = (cost - new_cost) / jnp.maximum(cost, 1e-30)
        cost2 = jnp.where(ok, new_cost, cost)
        done = (ok & (rel < ftol)) | (lam > 1e12)
        return (f, ct, cr, pts, lam, dec, cost2, it + 1, done,
                d_cam, d_f)

    def cond(carry):
        it, done = carry[7], carry[8]
        return (it < max_iters) & (~done)

    c0 = cost_of((p.focal, p.cam_t, p.cam_r, p.points))
    C = p.cam_t.shape[0]
    f, ct, cr, pts, lam, dec, cost, it, _, _, _ = jax.lax.while_loop(
        cond,
        body,
        (
            p.focal,
            p.cam_t,
            p.cam_r,
            p.points,
            jnp.asarray(init_lambda, dtype),
            jnp.asarray(init_dec, dtype),
            c0,
            jnp.asarray(0),
            jnp.asarray(False),
            jnp.zeros((C, 6), dtype),
            jnp.zeros((), dtype),
        ),
    )
    return BAResult(
        focal=f, cam_t=ct, cam_r=cr, points=pts, cost=cost,
        initial_cost=c0, iterations=it, lam=lam, dec=dec,
    )


def build_tracks(obs_pt, num_points: int, max_track: int | None = None):
    """Host-side helper: bucket observation indices by point.

    Returns (track_obs (P, Tmax) int32, track_mask (P, Tmax) bool). Numpy,
    runs between BA rounds when the observation table changes.
    """
    import numpy as np

    obs_pt = np.asarray(obs_pt)
    counts = np.bincount(obs_pt, minlength=num_points)
    T = int(counts.max()) if max_track is None else max_track
    T = max(T, 1)
    # Vectorized bucketing: slot of each observation within its point's group
    # is its rank in the stable point-sorted order minus the group start.
    order = np.argsort(obs_pt, kind="stable")
    sorted_pt = obs_pt[order]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(obs_pt.shape[0]) - start[sorted_pt]
    keep = slot < T
    track_obs = np.zeros((num_points, T), np.int32)
    track_mask = np.zeros((num_points, T), bool)
    track_obs[sorted_pt[keep], slot[keep]] = order[keep].astype(np.int32)
    track_mask[sorted_pt[keep], slot[keep]] = True
    return track_obs, track_mask
