"""Stereo panorama synthesis from a reconstructed circular trajectory.

Capability parity with the reference's stitcher (T13/D4,
/root/reference/examples/stereo_panorama_tools.cpp:404-851 +
make_stereo_panorama.cpp): load poses.txt, fit the trajectory plane (RANSAC
on camera centers) and rotate its normal to +y, flip/scale normalization,
per-keyframe azimuth ordering with loop de-duplication, then for each
consecutive keyframe pair synthesize the panorama columns whose synthetic
rays fall between the two cameras — plane-induced homography maps corrected
by dense optical flow, alpha-blended — and finally the cylindrical→spherical
remap and over/under stereo export.

Device redesign: the reference synthesizes one column at a time on the host
with CUDA flow; here all columns assigned to a pair are synthesized as one batched
gather/lerp kernel, the flow is the jitted pyramidal Horn–Schunck solver
(ops/optical_flow.py), and the column→pair assignment is vectorized host
numpy (pure trigonometry).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry.so3 import np_so3_exp, so3_exp, so3_log
from ..ops.optical_flow import horn_schunck_flow
from ..ransac.plane import plane_ransac
from ..io.nerf import read_poses
from ..io.png import write_png

DEPTH = 10.0               # plane depth (stereo_panorama_tools.cpp:30)
SYNTH_RADIUS = 0.5         # synthetic view circle radius (:31)
SYNTH_FOCAL_FACTOR = 1.2   # synthetic focal factor (:32)
NPHI = 9                   # stereo view count (:485)


class PanoKeyframes(NamedTuple):
    index: np.ndarray   # (F,) original frame indices
    r: np.ndarray       # (F, 3)
    t: np.ndarray       # (F, 3)
    theta: np.ndarray   # (F,) azimuth


def _rotmats(r):
    # host-numpy: no device dispatch for a host-side pose transform
    return np_so3_exp(np.asarray(r, np.float64))


def _rotation_from_to(a, b):
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * ((1 - c) / (s * s))


def normalize_trajectory(index, r, t, key=None):
    """Plane fit on camera centers → up correction → flip → min-radius scale
    (reference estimate_plane, stereo_panorama_tools.cpp:276-358)."""
    R = _rotmats(r)
    centers = -np.einsum("cji,cj->ci", R, t)
    key = jax.random.PRNGKey(0) if key is None else key
    res = plane_ransac(
        key, jnp.asarray(centers), jnp.ones(len(centers), bool),
        sq_thresh=0.01**2, num_hypotheses=128,
    )
    up = np.asarray(res.normal)
    if up[1] < 0:
        up = -up
    correction = _rotation_from_to(up, np.array([0.0, 1.0, 0.0]))
    R = R @ correction.T

    # flip upside-down if most cameras ended up inverted
    if np.sum(R[:, 1, 1] < 0) > len(R) / 2:
        R = R @ np.diag([1.0, -1.0, -1.0])

    centers = -np.einsum("cji,cj->ci", R, t)
    min_dist = np.linalg.norm(centers, axis=-1).min()
    t = t / max(min_dist, 1e-12)
    r_out = np.asarray(so3_log(jnp.asarray(R)))
    return index, r_out, t


def compute_thetas(r, t):
    """Azimuth of each camera center about +y (reference compute_thetas)."""
    R = _rotmats(r)
    c = -np.einsum("cji,cj->ci", R, t)
    up = np.array([0.0, 1.0, 0.0])
    cproj = c - np.outer(c @ up, up)
    x = np.array([1.0, 0.0, 0.0])
    cross = np.cross(np.broadcast_to(x, cproj.shape), cproj)
    return np.arctan2(cross @ up, cproj @ x) + np.pi


def order_keyframes(kf: PanoKeyframes, is_loop: bool) -> PanoKeyframes:
    """Direction detection + end-overlap removal (reference
    make_stereo_panoramas:434-460)."""
    idx, r, t, th = kf
    reverse = th[1] < th[0]
    keep_until = len(th)
    if is_loop:
        while keep_until > 2 and (
            (reverse and th[keep_until - 1] < th[0])
            or ((not reverse) and th[keep_until - 1] > th[0])
        ):
            keep_until -= 1
    return PanoKeyframes(idx[:keep_until], r[:keep_until], t[:keep_until],
                         th[:keep_until])


def assign_columns(
    kf: PanoKeyframes, ntheta: int, nphi: int = NPHI,
):
    """For each (theta, phi) panorama column, find the consecutive keyframe
    pair that brackets its synthetic ray, and the blend weight alpha.

    Vectorized host trigonometry (reference inner gating loop :544-600).
    Returns dict (pair -> list of (thetanum, phinum, theta, phi, alpha)).
    """
    F = len(kf.index)
    up = np.array([0.0, 1.0, 0.0])
    R = _rotmats(kf.r)
    centers = -np.einsum("cji,cj->ci", R, kf.t)

    thetas = -np.pi + np.arange(ntheta) * (2 * np.pi / (ntheta - 1))
    if nphi == 1:
        phis = np.array([0.0])
    else:
        half = (nphi - 1) / 2.0
        phis = np.deg2rad(np.linspace(-half, half, nphi))

    # synthetic camera centers and rays
    synth_R = _rotmats(
        np.stack([np.zeros(ntheta), -thetas, np.zeros(ntheta)], -1)
    )
    synth_t = np.array([0.0, 0.0, -SYNTH_RADIUS])
    C_D = -np.einsum("tji,j->ti", synth_R, synth_t)  # (T, 3)

    # r_D per (theta, phi): world ray direction of the synthetic column
    rD_cam = np.stack(
        [np.tan(phis), np.zeros(nphi), np.ones(nphi)], -1
    )  # (P, 3)
    r_D = np.einsum("tji,pj->tpi", synth_R, rD_cam - synth_t)  # (T, P, 3)

    def proj(v):
        return v - np.tensordot(v @ up, up, axes=0)

    rs_D = proj(r_D.reshape(-1, 3)).reshape(ntheta, nphi, 3)

    out = {}
    for k in range(F):
        left = k
        right = (k + 1) % F  # wrap pair used only when the caller is a loop
        r_L = centers[left][None, :] - C_D   # (T, 3)
        r_R = centers[right][None, :] - C_D
        rs_L = proj(r_L)
        rs_R = proj(r_R)

        def signed_angle(a, b):
            crossdot = np.einsum(
                "...i,i->...", np.cross(a, b), up
            )
            return np.arctan2(crossdot, np.einsum("...i,...i->...", a, b))

        a_LD = signed_angle(rs_L[:, None, :], rs_D)     # (T, P)
        a_RD = signed_angle(rs_R[:, None, :], rs_D)
        a_LR = signed_angle(rs_L, rs_R)[:, None]

        ok = (a_LD * a_RD < 0) & (np.abs(a_LD) < np.pi / 2) & (
            np.abs(a_RD) < np.pi / 2
        )
        alpha = np.abs(a_LD) / np.maximum(np.abs(a_LR), 1e-12)
        tt, pp = np.nonzero(ok)
        if len(tt):
            out[(left, right)] = (
                tt.astype(np.int32), pp.astype(np.int32),
                thetas[tt], phis[pp], alpha[tt, pp],
            )
    return out, thetas, phis


def synth_column_maps(focal, cx, cy, height, theta, phi, r_cam, t_cam):
    """Plane-induced projection maps of one synthetic column into a camera.

    theta, phi: (B,) column angles; r_cam/t_cam: the camera pose. Returns
    (B, height, 2) pixel coords and a validity mask (cheirality).
    Mirrors get_synthetic_column_maps (stereo_panorama_tools.cpp:69-106).
    """
    dtype = jnp.asarray(theta).dtype
    synth_t = jnp.asarray([0.0, 0.0, -SYNTH_RADIUS], dtype)
    synth_focal = focal * SYNTH_FOCAL_FACTOR
    zeros = jnp.zeros_like(theta)
    synth_R = so3_exp(jnp.stack([zeros, -theta, zeros], -1))  # (B, 3, 3)

    ys = (jnp.arange(height, dtype=dtype) - cy) / synth_focal  # (H,)
    col = jnp.tan(phi)  # (B,)
    synth_x = jnp.stack(
        [
            jnp.broadcast_to(col[:, None], (col.shape[0], height)),
            jnp.broadcast_to(ys[None, :], (col.shape[0], height)),
            jnp.ones((col.shape[0], height), dtype),
        ],
        -1,
    )  # (B, H, 3)
    world_X = jnp.einsum(
        "bji,bhj->bhi", synth_R, synth_x * DEPTH - synth_t
    )  # (B, H, 3)
    Rc = so3_exp(jnp.asarray(r_cam))
    Xc = jnp.einsum("ij,bhj->bhi", Rc, world_X) + jnp.asarray(t_cam)
    z = Xc[..., 2]
    valid = z > 0
    zs = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    px = jnp.stack(
        [focal * Xc[..., 0] / zs + cx, focal * Xc[..., 1] / zs + cy], -1
    )
    return px, valid


def _bilinear_rgb(img, x, y):
    H, W = img.shape[:2]
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def synthesize_pair_columns(
    focal, cx, cy,
    theta, phi, alpha,          # (B,) assigned columns
    left_pose, right_pose,       # (r, t) tuples
    left_img, right_img,         # (H, W, 3) float
    flow_lr, flow_rl,            # (H, W, 2) dense flows
):
    """Flow-corrected column synthesis, batched over all columns of a pair
    (reference synthesize_column_flowbased, stereo_panorama_tools.cpp:135-188).

    Returns (B, H, 3) columns and (B,) validity.
    """
    H = left_img.shape[0]
    theta = jnp.asarray(theta)
    phi = jnp.asarray(phi)
    alpha = jnp.asarray(alpha)[:, None, None]

    xL, vL = synth_column_maps(focal, cx, cy, H, theta, phi, *left_pose)
    xR, vR = synth_column_maps(focal, cx, cy, H, theta, phi, *right_pose)
    valid = jnp.all(vL, axis=-1) & jnp.all(vR, axis=-1)

    v_LR = xR - xL
    F_LR = _bilinear_rgb(flow_lr, xL[..., 0], xL[..., 1])
    F_RL = _bilinear_rgb(flow_rl, xR[..., 0], xR[..., 1])
    Fs_LR = v_LR - F_LR
    Fs_RL = -v_LR - F_RL
    xs_L = xL + alpha * Fs_LR
    xs_R = xR + (1.0 - alpha) * Fs_RL

    I_L = _bilinear_rgb(left_img, xs_L[..., 0], xs_L[..., 1])
    I_R = _bilinear_rgb(right_img, xs_R[..., 0], xs_R[..., 1])
    cols = (1.0 - alpha) * I_L + alpha * I_R
    return cols, valid


def cylindrical_to_spherical(pano: np.ndarray, focal: float, cy: float):
    """Vertical tan-remap of a cylindrical panorama to equirectangular
    (reference convert_to_spherical, stereo_panorama_tools.cpp:360-402)."""
    H, W = pano.shape[:2]
    height = W // 2
    phis = np.linspace(-np.pi / 2, np.pi / 2, height)
    rows = focal * np.tan(phis) + cy
    out = np.zeros((height, W, pano.shape[2]), pano.dtype)
    ok = (rows >= 0) & (rows <= H - 1)
    r0 = np.clip(np.floor(rows).astype(int), 0, H - 1)
    r1 = np.clip(r0 + 1, 0, H - 1)
    frac = (rows - r0)[:, None, None]
    vals = pano[r0] * (1 - frac) + pano[r1] * frac
    out[ok] = vals[ok]
    return out


def make_stereo_panoramas(
    poses_path: str,
    frames: np.ndarray,          # (F_total, H, W, 3) uint8, indexed by pose idx
    intrinsics,                  # (focal, cx, cy)
    output_dir: str,
    pano_width: int = 1024,
    nphi: int = NPHI,
    is_loop: bool = True,
    flow_levels: int = 4,
):
    """Full stitcher driver. Returns the list of spherical panoramas
    (one per phi)."""
    focal, cx, cy = intrinsics
    os.makedirs(output_dir, exist_ok=True)
    idx, ts, rs = read_poses(poses_path)
    idx, rs, ts = normalize_trajectory(idx, rs, ts)
    th = compute_thetas(rs, ts)
    kf = order_keyframes(PanoKeyframes(idx, rs, ts, th), is_loop)
    F = len(kf.index)

    assignments, thetas, phis = assign_columns(kf, pano_width, nphi)

    H, W = frames.shape[1:3]
    panos = np.zeros((nphi, H, pano_width, 3), np.uint8)
    theta_step = 2 * np.pi / (pano_width - 1)

    flow_fn = jax.jit(
        lambda a, b: horn_schunck_flow(a, b, num_levels=flow_levels)
    )
    synth_fn = jax.jit(synthesize_pair_columns, static_argnums=())

    for k in range(F if is_loop else F - 1):
        left = k
        right = (k + 1) % F
        if (left, right) not in assignments:
            continue
        tt, pp, th_cols, phi_cols, alpha = assignments[(left, right)]
        li = frames[kf.index[left] if kf.index[left] < len(frames) else left]
        ri = frames[kf.index[right] if kf.index[right] < len(frames) else right]
        lg = jnp.asarray(li.mean(-1) / 255.0, jnp.float32)
        rg = jnp.asarray(ri.mean(-1) / 255.0, jnp.float32)
        u_f, v_f = flow_fn(lg, rg)
        u_b, v_b = flow_fn(rg, lg)
        flow_lr = jnp.stack([u_f, v_f], -1)
        flow_rl = jnp.stack([u_b, v_b], -1)

        cols, valid = synth_fn(
            jnp.float32(focal), jnp.float32(cx), jnp.float32(cy),
            jnp.asarray(th_cols, jnp.float32), jnp.asarray(phi_cols, jnp.float32),
            jnp.asarray(alpha, jnp.float32),
            (jnp.asarray(kf.r[left], jnp.float32), jnp.asarray(kf.t[left], jnp.float32)),
            (jnp.asarray(kf.r[right], jnp.float32), jnp.asarray(kf.t[right], jnp.float32)),
            jnp.asarray(li, jnp.float32), jnp.asarray(ri, jnp.float32),
            flow_lr, flow_rl,
        )
        cols = np.asarray(cols)
        valid = np.asarray(valid)
        for b in range(len(tt)):
            if not valid[b]:
                continue
            shift = int(round(phi_cols[b] / theta_step))
            colout = (int(tt[b]) + shift) % pano_width
            panos[pp[b], :, colout] = np.clip(cols[b], 0, 255).astype(np.uint8)

    sphericals = []
    for p in range(nphi):
        write_png(os.path.join(output_dir, f"cylindrical{p}.png"), panos[p])
        sph = cylindrical_to_spherical(panos[p], focal, cy)
        sphericals.append(sph)
        write_png(os.path.join(output_dir, f"spherical{p}.png"), sph)
    for p in range(nphi // 2):
        over = np.concatenate([sphericals[nphi - p - 1], sphericals[p]], axis=0)
        write_png(os.path.join(output_dir, f"overunder{nphi - p - 1}{p}.png"),
                  over)
    return sphericals


def synthesize_view(
    focal, cx, cy, height, width,
    theta,                       # synthetic camera azimuth
    left_pose, right_pose, alpha,
    left_img, right_img,
    flow_lr, flow_rl,
):
    """Synthesize one full view from a circle camera at azimuth theta —
    whole-image analogue of the column synthesis (reference make_circle_views,
    stereo_panorama_tools.cpp:639-851): plane-induced maps into both
    keyframes, flow correction, alpha blend."""
    dtype = jnp.float32
    synth_t = jnp.asarray([0.0, 0.0, -SYNTH_RADIUS], dtype)
    theta = jnp.asarray(theta, dtype)
    zero = jnp.zeros_like(theta)
    synth_R = so3_exp(jnp.stack([zero, -theta, zero]))
    synth_focal = focal * SYNTH_FOCAL_FACTOR

    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=dtype), jnp.arange(width, dtype=dtype),
        indexing="ij",
    )
    synth_x = jnp.stack(
        [(xs - cx) / synth_focal, (ys - cy) / synth_focal, jnp.ones_like(xs)],
        -1,
    )
    world_X = jnp.einsum("ji,hwj->hwi", synth_R, synth_x * DEPTH - synth_t)

    def project(pose):
        Rc = so3_exp(jnp.asarray(pose[0], dtype))
        Xc = jnp.einsum("ij,hwj->hwi", Rc, world_X) + jnp.asarray(pose[1], dtype)
        z = jnp.where(jnp.abs(Xc[..., 2]) > 1e-9, Xc[..., 2], 1e-9)
        return jnp.stack(
            [focal * Xc[..., 0] / z + cx, focal * Xc[..., 1] / z + cy], -1
        ), Xc[..., 2] > 0

    xL, vL = project(left_pose)
    xR, vR = project(right_pose)
    v_LR = xR - xL
    F_LR = _bilinear_rgb(flow_lr, xL[..., 0], xL[..., 1])
    F_RL = _bilinear_rgb(flow_rl, xR[..., 0], xR[..., 1])
    xs_L = xL + alpha * (v_LR - F_LR)
    xs_R = xR + (1.0 - alpha) * (-v_LR - F_RL)
    I_L = _bilinear_rgb(left_img, xs_L[..., 0], xs_L[..., 1])
    I_R = _bilinear_rgb(right_img, xs_R[..., 0], xs_R[..., 1])
    out = (1.0 - alpha) * I_L + alpha * I_R
    return out, vL & vR


def make_circle_views(
    poses_path: str,
    frames: np.ndarray,
    intrinsics,
    output_dir: str,
    num_views: int = 64,
    is_loop: bool = True,
    flow_levels: int = 4,
):
    """Render `num_views` synthetic whole views on the synthesis circle
    (reference make_circle_views / D4's second mode)."""
    focal, cx, cy = intrinsics
    os.makedirs(output_dir, exist_ok=True)
    idx, ts, rs = read_poses(poses_path)
    idx, rs, ts = normalize_trajectory(idx, rs, ts)
    th = compute_thetas(rs, ts)
    kf = order_keyframes(PanoKeyframes(idx, rs, ts, th), is_loop)
    F = len(kf.index)
    H, W = frames.shape[1:3]

    up = np.array([0.0, 1.0, 0.0])
    R = _rotmats(kf.r)
    centers = -np.einsum("cji,cj->ci", R, kf.t)

    flow_fn = jax.jit(lambda a, b: horn_schunck_flow(a, b, num_levels=flow_levels))
    view_fn = jax.jit(synthesize_view, static_argnums=(3, 4))

    thetas = -np.pi + np.arange(num_views) * (2 * np.pi / num_views)

    written = 0
    for vi, theta in enumerate(thetas):
        synth_R = _rotmats(np.array([[0.0, -theta, 0.0]]))[0]
        C_D = -synth_R.T @ np.array([0.0, 0.0, -SYNTH_RADIUS])

        def pr(vec):
            return vec - up * np.dot(vec, up)

        def signed_angle(a, b):
            return np.arctan2(np.dot(np.cross(a, b), up), np.dot(a, b))

        best = None
        rs_D = pr(synth_R.T @ (np.array([0.0, 0.0, 1.0]) - np.array([0, 0, -SYNTH_RADIUS])))
        for k in range(F if is_loop else F - 1):
            left, right = k, (k + 1) % F
            a_LD = signed_angle(pr(centers[left] - C_D), rs_D)
            a_RD = signed_angle(pr(centers[right] - C_D), rs_D)
            a_LR = signed_angle(pr(centers[left] - C_D), pr(centers[right] - C_D))
            if a_LD * a_RD < 0 and abs(a_LD) < np.pi / 2 and abs(a_RD) < np.pi / 2:
                best = (left, right, abs(a_LD) / max(abs(a_LR), 1e-12))
                break
        if best is None:
            continue
        left, right, alpha = best
        li = frames[kf.index[left] if kf.index[left] < len(frames) else left]
        ri = frames[kf.index[right] if kf.index[right] < len(frames) else right]
        lg = jnp.asarray(li.mean(-1) / 255.0, jnp.float32)
        rg = jnp.asarray(ri.mean(-1) / 255.0, jnp.float32)
        uf, vf = flow_fn(lg, rg)
        ub, vb = flow_fn(rg, lg)
        img, valid = view_fn(
            jnp.float32(focal), jnp.float32(cx), jnp.float32(cy), H, W,
            jnp.float32(theta),
            (kf.r[left], kf.t[left]), (kf.r[right], kf.t[right]),
            jnp.float32(alpha),
            jnp.asarray(li, jnp.float32), jnp.asarray(ri, jnp.float32),
            jnp.stack([uf, vf], -1), jnp.stack([ub, vb], -1),
        )
        out = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        out[~np.asarray(valid)] = 0
        write_png(os.path.join(output_dir, f"view{vi:04d}.png"), out)
        written += 1
    return written
