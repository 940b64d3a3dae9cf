"""Rotation averaging and the uncalibrated spherical pose graph.

Capability parity with the reference's
* rotation_averaging.{h,cpp} (/root/reference/src/rotation_averaging.cpp:15-91):
  robust pose-graph optimization over per-camera axis-angle rotations with
  cycle residual log(R₁R₀ᵀ·R_measᵀ) scaled by 1/max‖log R_meas‖, SoftL1(0.03)
  loss, first camera fixed;
* uncalibrated_pose_graph.{h,cpp} (…/uncalibrated_pose_graph.cpp:16-203), the
  ICCV 2025 core: each measured relative rotation is decomposed into an
  in-plane axis rotation Rxy(θxy) and a roll Rz(θz); a focal multiplier f
  warps θxy via θ' = atan2(2f·sinθxy, (1+f²)cosθxy + (1−f²)), and rotations
  and f are optimized jointly (f bound-constrained).

Device design: the graph is an edge list (i, j, r_meas); residual
Jacobians (two 3×3 blocks per edge + optional focal column) are computed by
vmapped forward-mode autodiff and scattered into dense block normal equations
— one fused kernel per LM iteration, no per-edge host work. The 1024-trial
focal search (spherical_sfm_tools.cpp:1418-1496) becomes a single vmap over
focal hypotheses with an associative-scan sequential rotation init.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.essential import (
    conjugate_essential_by_focal,
    decompose_spherical_essential,
)
from ..geometry.so3 import so3_exp, so3_log
from .ba import _sorted_segment_sum
from .lm import soft_l1_rho, soft_l1_weight

SOFT_L1_SCALE = 0.03  # reference: SoftLOneLoss(0.03)


class RotationGraph(NamedTuple):
    """Edge list of relative-rotation measurements i -> j (i < j)."""

    edge_i: jnp.ndarray   # (E,) int32
    edge_j: jnp.ndarray   # (E,) int32
    r_meas: jnp.ndarray   # (E, 3) axis-angle of measured R_ij (x_j = R_ij x_i)
    edge_w: jnp.ndarray   # (E,) weight (0 = padding)


def _edge_scale(g: RotationGraph) -> jnp.ndarray:
    """1 / max ‖log R_meas‖ — the reference's residual normalization
    (rotation_averaging.cpp:50-55)."""
    norms = jnp.linalg.norm(g.r_meas, axis=-1)
    norms = jnp.where(g.edge_w > 0, norms, 0.0)
    return 1.0 / jnp.maximum(jnp.max(norms), 1e-12)


def _cycle_residual(r0, r1, r_meas, scale):
    """scale · log(R₁ R₀ᵀ R_measᵀ)."""
    R0 = so3_exp(r0)
    R1 = so3_exp(r1)
    Rm = so3_exp(r_meas)
    return scale * so3_log((R1 @ R0.T) @ Rm.T)


def decompose_rotation_xy_z(R: jnp.ndarray):
    """Split R = Rxy ∘ Rz: axis-in-xy-plane rotation times a roll about z.

    Returns (rx, ry, thetaxy, thetaz) per the reference's decompose_rotation
    (uncalibrated_pose_graph.cpp:16-31). Batched over leading axes.
    """
    Z = R[..., :, 2]
    Z = Z / jnp.linalg.norm(Z, axis=-1, keepdims=True)
    e3 = jnp.zeros_like(Z).at[..., 2].set(1.0)
    axis = jnp.cross(e3, Z)
    axis_n = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.where(axis_n > 1e-12, axis_n, 1.0)
    thetaxy = jnp.arccos(jnp.clip(Z[..., 2], -1.0, 1.0))
    Rxy = so3_exp(thetaxy[..., None] * axis)
    Rz = jnp.swapaxes(Rxy, -1, -2) @ R
    thetaz = so3_log(Rz)[..., 2]
    return axis[..., 0], axis[..., 1], thetaxy, thetaz


def warp_thetaxy(thetaxy, focal_mult):
    """θ'xy(f): how a spherical in-plane rotation angle transforms when the
    focal is rescaled by f (uncalibrated_pose_graph.cpp:49-52)."""
    f2 = focal_mult * focal_mult
    num = 2.0 * focal_mult * jnp.sin(thetaxy)
    den = (1.0 + f2) * jnp.cos(thetaxy) + (1.0 - f2)
    return jnp.arctan2(num, den)


def _warped_measurement(rx, ry, thetaxy, thetaz, focal_mult):
    """R_meas(f) = Rxy(θ'xy(f)) · Rz(θz), batched."""
    txy = warp_thetaxy(thetaxy, focal_mult)
    zeros = jnp.zeros_like(rx)
    rxy = jnp.stack([txy * rx, txy * ry, zeros], axis=-1)
    rz = jnp.stack([zeros, zeros, thetaz], axis=-1)
    return so3_exp(rxy) @ so3_exp(rz)


def pose_graph_cost(rotations_r: jnp.ndarray, g: RotationGraph) -> jnp.ndarray:
    """Robust total cost at fixed rotations (reference get_cost,
    uncalibrated_pose_graph.cpp:116-145): 0.5·Σ ρ_softL1(‖res‖²)."""
    scale = _edge_scale(g)
    res = jax.vmap(_cycle_residual, in_axes=(0, 0, 0, None))(
        rotations_r[g.edge_i], rotations_r[g.edge_j], g.r_meas, scale
    )
    s = jnp.sum(res * res, axis=-1)
    return 0.5 * jnp.sum(jnp.where(g.edge_w > 0, soft_l1_rho(s, SOFT_L1_SCALE), 0.0))


def _robust_block_lm(
    residual_edge,       # (r0, r1, extra, edge_data) -> (3,) residual
    rotations_r,         # (N, 3) initial
    extra0,              # scalar extra parameter (focal mult) or None
    edge_i, edge_j, edge_data, edge_w,
    fixed_mask,          # (N,) bool — rotations to freeze (gauge)
    extra_bounds=None,   # (lo, hi) for the extra parameter
    max_iters: int = 64,
    ftol: float = 1e-12,
    solver: str = "auto",
    pcg_iters: int = 128,
    pcg_rtol: float = 1e-8,
):
    """Sparse-block robust LM shared by calibrated/uncalibrated pose graphs.

    solver="dense": normal equations assembled by scattering per-edge 3×3
    blocks into a dense (3N [+1])² system — fine while N is hundreds.
    solver="pcg": matrix-free block-Jacobi CG on the same system — every
    node reduction is a sorted segment sum over the edge list (no scatters,
    no O(N²) memory; CLAUDE.md hot-path rule), the pose-graph mirror of the
    BA camera solve. "auto" switches to pcg above 400 frames.
    """
    N = rotations_r.shape[0]
    dtype = rotations_r.dtype
    has_extra = extra0 is not None
    D = 3 * N + (1 if has_extra else 0)
    if solver == "auto":
        solver = "pcg" if N > 400 else "dense"

    # A backend's default matmul precision may round f32 inputs (TF32 on
    # the GPU); the normal-equation contractions here need true f32 or LM
    # stalls above the
    # real optimum near convergence (see _bundle_adjust_jit).
    with jax.default_matmul_precision("highest"):
        return _robust_block_lm_body(
            residual_edge, rotations_r, extra0, edge_i, edge_j, edge_data,
            edge_w, fixed_mask, extra_bounds, max_iters, ftol, solver,
            pcg_iters, pcg_rtol,
        )


def _robust_block_lm_body(
    residual_edge, rotations_r, extra0, edge_i, edge_j, edge_data, edge_w,
    fixed_mask, extra_bounds, max_iters, ftol, solver, pcg_iters, pcg_rtol,
):
    N = rotations_r.shape[0]
    dtype = rotations_r.dtype
    has_extra = extra0 is not None
    D = 3 * N + (1 if has_extra else 0)

    def edge_res(r0, r1, extra, data):
        return residual_edge(r0, r1, extra, data)

    def total_cost(rots, extra):
        res = jax.vmap(edge_res, in_axes=(0, 0, None, 0))(
            rots[edge_i], rots[edge_j], extra, edge_data
        )
        s = jnp.sum(res * res, axis=-1)
        return 0.5 * jnp.sum(
            jnp.where(edge_w > 0, soft_l1_rho(s, SOFT_L1_SCALE), 0.0)
        )

    free = (~fixed_mask).astype(dtype)

    def edge_terms(rots, extra):
        """Per-edge residuals, Jacobian blocks and robust weights."""

        def res_and_jac(i, j, data):
            def f(packed):
                r0 = packed[:3]
                r1 = packed[3:6]
                ex = packed[6] if has_extra else extra
                return edge_res(r0, r1, ex, data)

            packed = jnp.concatenate(
                [rots[i], rots[j]] + ([jnp.atleast_1d(extra)] if has_extra else [])
            )
            r = f(packed)
            J = jax.jacfwd(f)(packed)  # (3, 6[+1])
            return r, J

        res, J = jax.vmap(res_and_jac)(edge_i, edge_j, edge_data)
        s = jnp.sum(res * res, axis=-1)
        w = soft_l1_weight(s, SOFT_L1_SCALE) * (edge_w > 0)
        J0 = J[:, :, 0:3] * free[edge_i][:, None, None]
        J1 = J[:, :, 3:6] * free[edge_j][:, None, None]
        return res, J, J0, J1, w

    # Sorted edge orders for scatter-free node reductions (both solvers;
    # chosen where scatters were slow, CLAUDE.md). Topology is constant through
    # the LM loop, so the sorts happen once per trace.
    order_i = jnp.argsort(edge_i)
    ptr_i = jnp.searchsorted(edge_i[order_i], jnp.arange(N + 1))
    order_j = jnp.argsort(edge_j)
    ptr_j = jnp.searchsorted(edge_j[order_j], jnp.arange(N + 1))

    def seg_i(x):
        return _sorted_segment_sum(x[order_i], ptr_i)

    def seg_j(x):
        return _sorted_segment_sum(x[order_j], ptr_j)

    if solver == "dense":
        # (i, j) block keys for the scatter-free off-diagonal fill — each
        # edge IS one upper-triangle block of the (N, N, 3, 3) system.
        key_ij = edge_i.astype(jnp.int32) * N + edge_j  # N ≤ 400: fits i32
        order_ij = jnp.argsort(key_ij)
        ptr_ij = jnp.searchsorted(key_ij[order_ij], jnp.arange(N * N + 1))

    def pcg_step(rots, extra, lam):
        """Matrix-free damped GN step: block-Jacobi CG over the edge list."""
        res, J, J0, J1, w = edge_terms(rots, extra)
        wj = w[:, None, None]
        E = res.shape[0]
        A0 = jnp.einsum("edi,edj->eij", J0 * wj, J0)
        A1 = jnp.einsum("edi,edj->eij", J1 * wj, J1)
        C01 = jnp.einsum("edi,edj->eij", J0 * wj, J1)
        g0 = jnp.einsum("edi,ed->ei", J0 * wj, res)
        g1 = jnp.einsum("edi,ed->ei", J1 * wj, res)
        if has_extra:
            Jf = J[:, :, 6]
            f0 = jnp.einsum("edi,ed->ei", J0 * wj, Jf)
            f1 = jnp.einsum("edi,ed->ei", J1 * wj, Jf)
            Hff = jnp.sum(w * jnp.sum(Jf * Jf, axis=-1))
            gf = jnp.sum(w * jnp.sum(Jf * res, axis=-1))
        else:
            f0 = f1 = jnp.zeros((E, 3), dtype)
            Hff = jnp.zeros((), dtype)
            gf = jnp.zeros((), dtype)

        seg = seg_i(jnp.concatenate(
            [A0.reshape(E, 9), g0, f0], axis=-1
        )) + seg_j(jnp.concatenate([A1.reshape(E, 9), g1, f1], axis=-1))
        # Gauge-frozen nodes must be EXACT zeros: a frozen node's Jacobi
        # block at roundoff level can be indefinite (NaN Cholesky → silent
        # zero CG steps; same failure mode as the BA camera solve).
        Hnn = seg[:, :9].reshape(N, 3, 3) * free[:, None, None]
        gnode = seg[:, 9:12] * free[:, None]
        fnode = seg[:, 12:15] * free[:, None]
        dvec = jnp.maximum(jnp.diagonal(Hnn, axis1=-2, axis2=-1), 1e-12)
        Hff_d = Hff * (1.0 + lam) + 1e-12

        def matvec(x, xf):
            xi = x[edge_i]
            xj = x[edge_j]
            y0 = (
                jnp.einsum("eij,ej->ei", A0, xi)
                + jnp.einsum("eij,ej->ei", C01, xj)
                + f0 * xf
            )
            y1 = (
                jnp.einsum("eij,ei->ej", C01, xi)
                + jnp.einsum("eij,ej->ei", A1, xj)
                + f1 * xf
            )
            out = (seg_i(y0) + seg_j(y1)) * free[:, None] + lam * dvec * x
            out_f = (
                jnp.sum(f0 * xi) + jnp.sum(f1 * xj) + Hff_d * xf
            )
            return out, out_f

        # block-Jacobi preconditioner (damped node blocks, eps-clamped for
        # gauge-frozen rows)
        Pn = Hnn + (lam * dvec)[..., None] * jnp.eye(3, dtype=dtype)
        eps = 1e-8 * jnp.maximum(
            jnp.trace(Pn, axis1=-2, axis2=-1) / 3.0, 1e-12
        )[:, None, None] * jnp.eye(3, dtype=dtype) + 1e-30 * jnp.eye(
            3, dtype=dtype
        )
        Lp = jnp.linalg.cholesky(Pn + eps)
        Pf = jnp.maximum(Hff_d, 1e-30)

        def precond(r, rf):
            y = jax.scipy.linalg.solve_triangular(Lp, r[..., None], lower=True)
            z = jax.scipy.linalg.solve_triangular(
                jnp.swapaxes(Lp, -1, -2), y, lower=False
            )[..., 0]
            return z * free[:, None], rf / Pf

        b = -gnode
        bf = -gf
        bnorm2 = jnp.sum(b * b) + bf * bf
        z0, z0f = precond(b, bf)
        state0 = (
            jnp.zeros((N, 3), dtype), jnp.zeros((), dtype),
            b, bf, z0, z0f, jnp.sum(b * z0) + bf * z0f, jnp.asarray(0),
        )

        def pcg_cond(st):
            _, _, r, rf, _, _, rz, it = st
            rn2 = jnp.sum(r * r) + rf * rf
            return (
                (it < pcg_iters)
                & (rn2 > pcg_rtol * pcg_rtol * jnp.maximum(bnorm2, 1e-30))
                & jnp.isfinite(rz)
            )

        def pcg_body(st):
            x, xf, r, rf, p, pf, rz, it = st
            Ap, Apf = matvec(p, pf)
            denom = jnp.sum(p * Ap) + pf * Apf
            alpha = rz / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
            x = x + alpha * p
            xf = xf + alpha * pf
            r = r - alpha * Ap
            rf = rf - alpha * Apf
            z, zf = precond(r, rf)
            rz_new = jnp.sum(r * z) + rf * zf
            beta = rz_new / jnp.where(jnp.abs(rz) > 1e-30, rz, 1e-30)
            return x, xf, r, rf, z + beta * p, zf + beta * pf, rz_new, it + 1

        x, xf, *_ = jax.lax.while_loop(pcg_cond, pcg_body, state0)
        # fnode couples rotations↔focal only through matvec; the off-diagonal
        # focal column is already handled there — nothing extra to do.
        del fnode
        return x, xf

    def build_system(rots, extra):
        """Scatter-free normal equations: node blocks and gradients via the
        sorted segment sums, off-diagonal blocks via the (i, j)-keyed
        segment sum (one edge = one upper-triangle block). Frozen (gauge /
        padded) nodes are masked to exact zeros."""
        res, J, J0, J1, w = edge_terms(rots, extra)
        wj = w[:, None, None]
        E = res.shape[0]
        A0 = jnp.einsum("edi,edj->eij", J0 * wj, J0).reshape(E, 9)
        A1 = jnp.einsum("edi,edj->eij", J1 * wj, J1).reshape(E, 9)
        C01 = jnp.einsum("edi,edj->eij", J0 * wj, J1).reshape(E, 9)
        g0 = jnp.einsum("edi,ed->ei", J0 * wj, res)
        g1 = jnp.einsum("edi,ed->ei", J1 * wj, res)
        if has_extra:
            Jf_w = J[:, :, 6]  # focal column (E, 3)
            f0 = jnp.einsum("edi,ed->ei", J0 * wj, Jf_w)
            f1 = jnp.einsum("edi,ed->ei", J1 * wj, Jf_w)
        else:
            f0 = f1 = jnp.zeros((E, 3), dtype)
        seg = seg_i(jnp.concatenate([A0, g0, f0], axis=-1)) + seg_j(
            jnp.concatenate([A1, g1, f1], axis=-1)
        )
        Hnn = seg[:, :9].reshape(N, 3, 3) * free[:, None, None]
        gvec = seg[:, 9:12] * free[:, None]
        fcol3 = seg[:, 12:15] * free[:, None]

        off = _sorted_segment_sum(C01[order_ij], ptr_ij).reshape(N, N, 3, 3)
        off = off * free[:, None, None, None] * free[None, :, None, None]
        H = off + jnp.transpose(off, (1, 0, 3, 2))
        H = H.at[jnp.arange(N), jnp.arange(N)].add(Hnn)

        Hd = H.transpose(0, 2, 1, 3).reshape(3 * N, 3 * N)
        gd = gvec.reshape(3 * N)
        if has_extra:
            Hff = jnp.sum(w * jnp.sum(Jf_w * Jf_w, axis=-1))
            gf = jnp.sum(w * jnp.sum(Jf_w * res, axis=-1))
            Hfull = jnp.zeros((D, D), dtype)
            Hfull = Hfull.at[: 3 * N, : 3 * N].set(Hd)
            fcol = fcol3.reshape(-1)
            Hfull = Hfull.at[: 3 * N, 3 * N].set(fcol)
            Hfull = Hfull.at[3 * N, : 3 * N].set(fcol)
            Hfull = Hfull.at[3 * N, 3 * N].set(Hff)
            gfull = jnp.concatenate([gd, jnp.atleast_1d(gf)])
            return Hfull, gfull
        return Hd, gd

    def body(carry):
        rots, extra, lam, cost, it, done = carry
        if solver == "pcg":
            dxn, dxf = pcg_step(rots, extra, lam)
            rots_n = rots + dxn * free[:, None]
            if has_extra:
                extra_n = extra + dxf
                if extra_bounds is not None:
                    extra_n = jnp.clip(
                        extra_n, extra_bounds[0], extra_bounds[1]
                    )
            else:
                extra_n = extra
        else:
            H, gvec = build_system(rots, extra)
            diag = jnp.maximum(jnp.diagonal(H), 1e-12)
            A = H + jnp.diag(lam * diag)
            # gauge: frozen rotations get identity rows via the free-mask
            # zeroing (their H rows are zero; the damped diagonal keeps A
            # nonsingular).
            dscale = jnp.sqrt(jnp.maximum(jnp.diagonal(A), 1e-15))
            A_eq = A / dscale[:, None] / dscale[None, :]
            L = jnp.linalg.cholesky(A_eq + 1e-12 * jnp.eye(D, dtype=dtype))
            y = jax.scipy.linalg.solve_triangular(
                L, -(gvec / dscale), lower=True
            )
            dx = jax.scipy.linalg.solve_triangular(
                L.T, y, lower=False
            ) / dscale

            rots_n = rots + dx[: 3 * N].reshape(N, 3) * free[:, None]
            if has_extra:
                extra_n = extra + dx[3 * N]
                if extra_bounds is not None:
                    extra_n = jnp.clip(
                        extra_n, extra_bounds[0], extra_bounds[1]
                    )
            else:
                extra_n = extra
        cost_n = total_cost(rots_n, extra_n)
        ok = jnp.isfinite(cost_n) & (cost_n < cost)
        lam = jnp.where(ok, jnp.maximum(lam * 0.33, 1e-12), lam * 4.0)
        rots = jnp.where(ok, rots_n, rots)
        extra = jnp.where(ok, extra_n, extra) if has_extra else extra
        rel = (cost - cost_n) / jnp.maximum(cost, 1e-30)
        cost = jnp.where(ok, cost_n, cost)
        done = (ok & (rel < ftol)) | (lam > 1e10)
        return rots, extra, lam, cost, it + 1, done

    def cond(carry):
        *_, it, done = carry
        return (it < max_iters) & (~done)

    extra_init = jnp.asarray(extra0, dtype) if has_extra else jnp.zeros((), dtype)
    c0 = total_cost(rotations_r, extra_init)
    rots, extra, lam, cost, it, _ = jax.lax.while_loop(
        cond,
        body,
        (rotations_r, extra_init, jnp.asarray(1e-4, dtype), c0,
         jnp.asarray(0), jnp.asarray(False)),
    )
    return rots, extra, cost


def _pad_graph(rotations_r, g: RotationGraph):
    """Host-side shape bucketing for the pose-graph LM: nodes to 1.25×-step
    buckets (multiples of 8), edges to powers of two, so captures of
    different length reuse the compiled LM while_loop (~1 min of XLA
    compile per distinct shape). Padded nodes are gauge-frozen identity
    rotations; padded edges carry w = 0 (masked everywhere, including the
    residual normalization's max over real edge norms).

    Returns (rotations_padded, graph_padded, fixed_mask, N_real).
    """
    import numpy as np

    N = rotations_r.shape[0]
    E = g.edge_i.shape[0]
    Np = 8
    while Np < N:
        Np = max(Np + 8, int(Np * 1.25) // 8 * 8)
    Ep = 64
    while Ep < E:
        Ep *= 2

    def padn(x, n, fill=0):
        x = np.asarray(x)
        widths = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths, constant_values=fill)

    rot_p = jnp.asarray(padn(rotations_r, Np))
    gp = RotationGraph(
        edge_i=jnp.asarray(padn(g.edge_i, Ep)),
        edge_j=jnp.asarray(padn(g.edge_j, Ep)),
        r_meas=jnp.asarray(padn(g.r_meas, Ep)),
        edge_w=jnp.asarray(padn(g.edge_w, Ep)),
    )
    fixed = np.zeros(Np, bool)
    fixed[0] = True
    fixed[N:] = True
    return rot_p, gp, jnp.asarray(fixed), N


def optimize_rotations(
    rotations_r: jnp.ndarray, g: RotationGraph, max_iters: int = 64,
    solver: str = "auto",
):
    """Robust rotation averaging (reference optimize_rotations,
    rotation_averaging.cpp:44-91). First camera is the gauge anchor.

    Returns (rotations_r (N, 3), final_cost). `solver`: "dense" |
    "pcg" (scatter-free segment-sum CG, scales past hundreds of frames) |
    "auto". Shapes are bucket-padded so different capture lengths share
    compiled programs.
    """
    if solver == "auto":  # resolve on the REAL size, not the padded one
        solver = "pcg" if rotations_r.shape[0] > 400 else "dense"
    rot_p, gp, fixed, N = _pad_graph(rotations_r, g)
    rots, cost = _optimize_rotations_jit(
        rot_p, gp, fixed, max_iters=max_iters, solver=solver
    )
    return rots[:N], cost


@partial(jax.jit, static_argnames=("max_iters", "solver"))
def _optimize_rotations_jit(
    rotations_r: jnp.ndarray, g: RotationGraph, fixed: jnp.ndarray,
    max_iters: int = 64, solver: str = "auto",
):
    scale = _edge_scale(g)

    def residual(r0, r1, _extra, r_meas):
        return _cycle_residual(r0, r1, r_meas, scale)

    rots, _, cost = _robust_block_lm(
        residual, rotations_r, None, g.edge_i, g.edge_j, g.r_meas, g.edge_w,
        fixed, max_iters=max_iters, solver=solver,
    )
    return rots, cost


def optimize_rotations_and_focal(
    rotations_r: jnp.ndarray,
    g: RotationGraph,
    focal_mult0,
    mult_lo,
    mult_hi,
    max_iters: int = 64,
    solver: str = "auto",
):
    """Joint rotations + focal-multiplier optimization (reference
    optimize_rotations_and_focal_length, uncalibrated_pose_graph.cpp:147-203).

    Returns (rotations_r, focal_mult, final_cost). The caller multiplies its
    focal guess by focal_mult. Shape-bucketed like `optimize_rotations`.
    """
    if solver == "auto":
        solver = "pcg" if rotations_r.shape[0] > 400 else "dense"
    rot_p, gp, fixed, N = _pad_graph(rotations_r, g)
    rots, fmult, cost = _optimize_rotations_and_focal_jit(
        rot_p, gp, fixed, jnp.asarray(focal_mult0), jnp.asarray(mult_lo),
        jnp.asarray(mult_hi), max_iters=max_iters, solver=solver,
    )
    return rots[:N], fmult, cost


@partial(jax.jit, static_argnames=("max_iters", "solver"))
def _optimize_rotations_and_focal_jit(
    rotations_r: jnp.ndarray,
    g: RotationGraph,
    fixed: jnp.ndarray,
    focal_mult0: jnp.ndarray,
    mult_lo: jnp.ndarray,
    mult_hi: jnp.ndarray,
    max_iters: int = 64,
    solver: str = "auto",
):
    """Joint rotations + focal-multiplier optimization (reference
    optimize_rotations_and_focal_length, uncalibrated_pose_graph.cpp:147-203).

    Returns (rotations_r, focal_mult, final_cost). The caller multiplies its
    focal guess by focal_mult.
    """
    scale = _edge_scale(g)
    rx, ry, txy, tz = decompose_rotation_xy_z(so3_exp(g.r_meas))
    edge_data = jnp.stack([rx, ry, txy, tz], axis=-1)

    def residual(r0, r1, fmult, data):
        Rm = _warped_measurement(data[0], data[1], data[2], data[3], fmult)
        R0 = so3_exp(r0)
        R1 = so3_exp(r1)
        return scale * so3_log((R1 @ R0.T) @ Rm.T)

    rots, fmult, cost = _robust_block_lm(
        residual, rotations_r, focal_mult0, g.edge_i, g.edge_j, edge_data,
        g.edge_w, fixed, extra_bounds=(mult_lo, mult_hi), max_iters=max_iters,
        solver=solver,
    )
    return rots, fmult, cost


def initialize_rotations_sequential(
    num_frames: int, g: RotationGraph
) -> jnp.ndarray:
    """Chain adjacent relative rotations (reference
    initialize_rotations_sequential, spherical_sfm_tools.cpp:794-813).

    Uses the edges with j = i+1; missing links default to identity. Prefix
    rotation products via associative scan: R_global_j = R_{j-1,j}·R_global_{j-1}.
    """
    dtype = g.r_meas.dtype
    # Scatter adjacent-edge rotations into slot j (slot 0 = identity).
    adj = (g.edge_j == g.edge_i + 1) & (g.edge_w > 0)
    links = jnp.tile(jnp.eye(3, dtype=dtype), (num_frames, 1, 1))
    Rm = so3_exp(g.r_meas)
    target = jnp.where(adj, g.edge_j, num_frames)
    links = (
        jnp.concatenate([links, jnp.eye(3, dtype=dtype)[None]], axis=0)
        .at[target]
        .set(jnp.where(adj[:, None, None], Rm, jnp.eye(3, dtype=dtype)))[:num_frames]
    )
    # Prefix product with composition Rg_j = link_j @ Rg_{j-1}: scan with
    # combine(a, b) = b @ a applied left-to-right.
    Rg = jax.lax.associative_scan(lambda a, b: jnp.matmul(b, a), links, axis=0)
    return so3_log(Rg)


def build_spanning_tree(num_frames: int, edge_i, edge_j, edge_w):
    """Host-side maximum-weight spanning forest of the measurement graph.

    The global-initialization analogue of the reference's GraphOptim dispatch
    (initialize_rotations_gopt, spherical_sfm_tools.cpp:815-849, dispatcher
    :1133-1140): instead of chaining only adjacent pairs — which breaks the
    moment one adjacent RANSAC fails — root every component at its smallest
    frame and chain along the heaviest (most-inlier) edges.

    Returns numpy (parent (N,), edge_idx (N,), sign (N,) int32): sign +1 if
    the tree edge is stored i=parent→j=child, −1 if reversed, 0 at roots /
    isolated frames.
    """
    import numpy as np
    from collections import deque

    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    w = np.asarray(edge_w, float)
    order = np.argsort(-w, kind="stable")

    uf = np.arange(num_frames)

    def find(x):
        while uf[x] != x:
            uf[x] = uf[uf[x]]
            x = uf[x]
        return x

    adj = [[] for _ in range(num_frames)]
    for e in order:
        if w[e] <= 0:
            continue
        a, b = find(ei[e]), find(ej[e])
        if a != b:
            uf[a] = b
            adj[ei[e]].append((int(ej[e]), int(e)))
            adj[ej[e]].append((int(ei[e]), int(e)))

    parent = np.arange(num_frames, dtype=np.int32)
    eidx = np.zeros(num_frames, np.int32)
    sign = np.zeros(num_frames, np.int32)
    seen = np.zeros(num_frames, bool)
    for root in range(num_frames):
        if seen[root]:
            continue
        seen[root] = True
        dq = deque([root])
        while dq:
            u = dq.popleft()
            for v, e in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    parent[v] = u
                    eidx[v] = e
                    sign[v] = 1 if ei[e] == u else -1
                    dq.append(v)
    return parent, eidx, sign


@partial(jax.jit, static_argnames=("num_frames",))
def initialize_rotations_tree(
    num_frames: int,
    g: RotationGraph,
    parent: jnp.ndarray,
    edge_idx: jnp.ndarray,
    sign: jnp.ndarray,
) -> jnp.ndarray:
    """Compose global rotations along a spanning tree by pointer doubling.

    R_global[v] = A[v]·A[parent]·…·I with A[v] the parent→v relative rotation
    (x_child = A x_parent, world→camera chaining as in the sequential init).
    ⌈log₂N⌉ batched gather+matmul rounds — no sequential chain.
    """
    dtype = g.r_meas.dtype
    Rm = so3_exp(g.r_meas)
    Re = Rm[edge_idx]
    eye = jnp.eye(3, dtype=dtype)
    A = jnp.where(sign[:, None, None] > 0, Re, jnp.swapaxes(Re, -1, -2))
    A = jnp.where(sign[:, None, None] == 0, eye, A)

    import math

    iters = max(1, math.ceil(math.log2(max(num_frames, 2))) + 1)

    def body(_, carry):
        par, M = carry
        M = jnp.einsum("nij,njk->nik", M, M[par])
        return par[par], M

    _, M = jax.lax.fori_loop(0, iters, body, (parent, A))
    return so3_log(M)


def initialize_rotations_global(
    num_frames: int, g: RotationGraph, weights=None
) -> jnp.ndarray:
    """Global rotation init (gopt-parity path, `sequential=False`): heaviest
    spanning tree + pointer-doubling composition. Robust refinement is the
    caller's `optimize_rotations` (reference refine_rotations,
    spherical_sfm_tools.cpp:851-860)."""
    import numpy as np

    w = np.asarray(g.edge_w) if weights is None else np.asarray(weights)
    parent, eidx, sign = build_spanning_tree(
        num_frames, np.asarray(g.edge_i), np.asarray(g.edge_j), w
    )
    return initialize_rotations_tree(
        num_frames, g, jnp.asarray(parent), jnp.asarray(eidx),
        jnp.asarray(sign),
    )


def rotations_at_focal(
    E_mats: jnp.ndarray, focal_ratio, inward: bool = False
) -> jnp.ndarray:
    """Re-decompose each pairwise essential matrix under a focal rescale.

    E' = diag(s,s,1)·E·diag(s,s,1), s = f/f₀, then closed-form spherical
    decomposition → R(f) (reference transform_image_matches,
    spherical_sfm_tools.cpp:1118-1131). E_mats (E,3,3) -> r (E,3).
    """
    Ep = conjugate_essential_by_focal(E_mats, focal_ratio)
    r, _ = decompose_spherical_essential(Ep, inward=inward)
    return r


@partial(jax.jit, static_argnames=("num_frames", "inward"))
def loop_constraint_costs(
    focals: jnp.ndarray,       # (F,) candidate focal lengths
    focal_guess: jnp.ndarray,  # scalar f₀ the E matrices were estimated at
    E_mats: jnp.ndarray,       # (E, 3, 3) pairwise essential matrices
    edge_i: jnp.ndarray,
    edge_j: jnp.ndarray,
    edge_w: jnp.ndarray,
    num_frames: int,
    inward: bool = False,
    tree=None,
) -> jnp.ndarray:
    """Pose-graph cost of each focal hypothesis — the vectorized form of the
    reference's 1024-trial OpenMP focal search (loop_constraint_cost_fn +
    find_best_focal_length_random, spherical_sfm_tools.cpp:1142-1159,
    1418-1496): conjugate E by f/f₀, re-decompose, chain a rotation init
    (sequential, or spanning-`tree` (parent, edge_idx, sign) for the global
    path — topology is focal-independent), evaluate the robust loop-closure
    cost. One vmap over F.
    """

    def cost_of(f):
        r_f = rotations_at_focal(E_mats, f / focal_guess, inward)
        g = RotationGraph(edge_i=edge_i, edge_j=edge_j, r_meas=r_f, edge_w=edge_w)
        if tree is None:
            rots = initialize_rotations_sequential(num_frames, g)
        else:
            rots = initialize_rotations_tree(num_frames, g, *tree)
        return pose_graph_cost(rots, g)

    return jax.vmap(cost_of)(focals)


@partial(jax.jit, static_argnames=("num_frames", "inward"))
def total_rotation_costs(
    focals: jnp.ndarray,
    focal_guess: jnp.ndarray,
    E_mats: jnp.ndarray,
    edge_i: jnp.ndarray,
    edge_j: jnp.ndarray,
    edge_w: jnp.ndarray,
    num_frames: int,
    inward: bool = False,
    tree=None,
) -> jnp.ndarray:
    """|2π − Σ‖log(R_iᵀR_{i−1})‖| of each focal hypothesis — the reference's
    alternative focal cost (total_rotation_cost_fn,
    spherical_sfm_tools.cpp:1084-1116): a closed circular capture should
    accumulate exactly one full turn over consecutive keyframes."""

    def cost_of(f):
        r_f = rotations_at_focal(E_mats, f / focal_guess, inward)
        g = RotationGraph(edge_i=edge_i, edge_j=edge_j, r_meas=r_f, edge_w=edge_w)
        if tree is None:
            rots = initialize_rotations_sequential(num_frames, g)
        else:
            rots = initialize_rotations_tree(num_frames, g, *tree)
        R = so3_exp(rots)
        rel = jnp.einsum("nji,njk->nik", R[1:], R[:-1])  # R_iᵀ R_{i−1}
        total = jnp.sum(jnp.linalg.norm(so3_log(rel), axis=-1))
        return jnp.abs(2.0 * jnp.pi - total)

    return jax.vmap(cost_of)(focals)


def _focal_costs(cost: str):
    if cost == "total_rotation":
        return total_rotation_costs
    return loop_constraint_costs


def _make_tree(sequential, num_frames, edge_i, edge_j, edge_w):
    if sequential:
        return None
    import numpy as np

    parent, eidx, sign = build_spanning_tree(
        num_frames, np.asarray(edge_i), np.asarray(edge_j), np.asarray(edge_w)
    )
    return (jnp.asarray(parent), jnp.asarray(eidx), jnp.asarray(sign))


def find_best_focal_grid(
    focal_guess,
    E_mats: jnp.ndarray,
    edge_i: jnp.ndarray,
    edge_j: jnp.ndarray,
    edge_w: jnp.ndarray,
    num_frames: int,
    min_focal,
    max_focal,
    num_steps: int = 64,
    inward: bool = False,
    sequential: bool = True,
    cost: str = "loop",
):
    """Uniform-grid focal search (reference find_best_focal_length_grid,
    spherical_sfm_tools.cpp:1321-1416): `num_steps` evenly spaced
    hypotheses, one vmapped sweep. Returns (best_focal, costs, focals)."""
    dtype = E_mats.dtype
    focals = jnp.linspace(
        jnp.asarray(min_focal, dtype), jnp.asarray(max_focal, dtype), num_steps
    )
    tree = _make_tree(sequential, num_frames, edge_i, edge_j, edge_w)
    costs = _focal_costs(cost)(
        focals, jnp.asarray(focal_guess, dtype), E_mats, edge_i, edge_j,
        edge_w, num_frames, inward, tree,
    )
    best = jnp.argmin(jnp.where(jnp.isfinite(costs), costs, jnp.inf))
    return focals[best], costs, focals


def find_best_focal_bracketed(
    key: jax.Array,
    focal_guess,
    E_mats: jnp.ndarray,
    edge_i: jnp.ndarray,
    edge_j: jnp.ndarray,
    edge_w: jnp.ndarray,
    num_frames: int,
    min_focal,
    max_focal,
    rounds: int = 6,
    points_per_round: int = 16,
    inward: bool = False,
    sequential: bool = True,
    cost: str = "loop",
    max_restarts: int = 100,
):
    """Bracketed 1-D focal minimization (reference
    find_best_focal_length_opt, spherical_sfm_tools.cpp:1191-1319: GSL Brent
    with a random-restart bracketing precondition). Batched variant:
    instead of one point per sequential Brent step, each round evaluates a
    vmapped sub-grid inside the bracket and shrinks around its argmin —
    same O(log) convergence, `rounds` device calls total.

    Returns (best_focal, ok) — ok False when no valid bracket was found
    (mirrors the reference's error return).
    """
    import numpy as np

    dtype = E_mats.dtype
    fg = jnp.asarray(focal_guess, dtype)
    tree = _make_tree(sequential, num_frames, edge_i, edge_j, edge_w)
    costs_fn = _focal_costs(cost)

    def eval_costs(fs):
        return np.asarray(
            costs_fn(
                jnp.asarray(fs, dtype), fg, E_mats, edge_i, edge_j, edge_w,
                num_frames, inward, tree,
            )
        )

    lo, hi = float(min_focal), float(max_focal)
    # bracketing precondition: the interior point must beat both ends
    # (random restarts like the reference's 100-retry loop)
    mid = float(focal_guess)
    end_costs = eval_costs([lo, hi])
    mid_cost = eval_costs([mid])[0]
    tries = 0
    key = jax.random.fold_in(key, 0)
    while mid_cost >= min(end_costs):
        if tries >= max_restarts:
            return jnp.asarray(mid, dtype), False
        key, sub = jax.random.split(key)
        mid = float(
            lo + (hi - lo) * float(jax.random.uniform(sub, (), jnp.float32))
        )
        mid_cost = eval_costs([mid])[0]
        tries += 1

    a, b = lo, hi
    for _ in range(rounds):
        # keep the certified mid in the candidate set so the search stays
        # attached to its bracketed basin (the reference's Brent does this
        # implicitly through its (a, m, b) triple)
        fs = np.sort(np.append(np.linspace(a, b, points_per_round), mid))
        cs = eval_costs(fs)
        i = int(np.nanargmin(cs))
        a = fs[max(i - 1, 0)]
        b = fs[min(i + 1, len(fs) - 1)]
        mid = float(fs[i])
    return jnp.asarray(mid, dtype), True


def find_best_focal_random(
    key: jax.Array,
    focal_guess,
    E_mats: jnp.ndarray,
    edge_i: jnp.ndarray,
    edge_j: jnp.ndarray,
    edge_w: jnp.ndarray,
    num_frames: int,
    min_focal,
    max_focal,
    num_trials: int = 1024,
    inward: bool = False,
    sequential: bool = True,
):
    """Random-search the focal length, then return (best_focal, costs, focals).

    The caller typically follows with `optimize_rotations_and_focal` (the
    reference's run_optimization, spherical_sfm_tools.cpp:1161-1189).
    `sequential=False` initializes each trial's rotations along the heaviest
    spanning tree instead of the adjacent-pair chain (the gopt-parity path).
    """
    dtype = E_mats.dtype
    focals = min_focal + (max_focal - min_focal) * jax.random.uniform(
        key, (num_trials,), dtype
    )
    focals = jnp.concatenate([focals, jnp.atleast_1d(jnp.asarray(focal_guess, dtype))])
    tree = None
    if not sequential:
        import numpy as np

        parent, eidx, sign = build_spanning_tree(
            num_frames, np.asarray(edge_i), np.asarray(edge_j),
            np.asarray(edge_w),
        )
        tree = (jnp.asarray(parent), jnp.asarray(eidx), jnp.asarray(sign))
    costs = loop_constraint_costs(
        focals, jnp.asarray(focal_guess, dtype), E_mats, edge_i, edge_j,
        edge_w, num_frames, inward, tree,
    )
    best = jnp.argmin(jnp.where(jnp.isfinite(costs), costs, jnp.inf))
    return focals[best], costs, focals
