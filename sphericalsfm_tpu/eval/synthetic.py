"""Synthetic spherical relative-pose problem generator — PRNG-keyed, batched.

Capability parity with the reference's evaluation problem generator
(/root/reference/evaluation/problem_generator/problem_generator.cpp:14-65):
random spherical relative pose (axis-angle with random or fixed rotation
magnitude), translation t = R·e₃ − e₃ (negated when inward), normal image
points in the first view with depths 6±2 (outward) or 0.5–0.75 (inward),
projection into the second view, and Gaussian pixel noise.

Differences by design: fully vectorized over a batch of problems via
`jax.random` (deterministic keys instead of the reference's global `rand()`),
and cheirality rejection (the reference regenerates until all points have
positive depth in view 2) is replaced by a per-correspondence validity mask
plus depth-positive resampling logic at the caller's discretion — fixed
shapes, no data-dependent looping.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry.so3 import skew, so3_exp


class RelativePoseProblem(NamedTuple):
    u: jnp.ndarray  # (..., N, 3) rays in view 1 (z=1)
    v: jnp.ndarray  # (..., N, 3) rays in view 2 (z=1)
    E: jnp.ndarray  # (..., 3, 3) ground-truth essential
    R: jnp.ndarray  # (..., 3, 3) ground-truth rotation
    t: jnp.ndarray  # (..., 3) ground-truth (unnormalized) translation
    r: jnp.ndarray  # (..., 3) ground-truth axis-angle
    valid: jnp.ndarray  # (..., N) cheirality mask (depth > 0 in view 2)


def make_random_problems(
    key: jax.Array,
    batch: int,
    num_corr: int,
    inward: bool = False,
    rotation_deg: float = -1.0,
    point_noise: float = 0.0,
    dtype=jnp.float64,
) -> RelativePoseProblem:
    """Generate `batch` independent spherical relative-pose problems.

    rotation_deg < 0 draws the rotation magnitude uniformly from [0, π)
    (matching the reference's `rotation < 0` mode); otherwise it is fixed.
    point_noise is the image-plane noise sigma *in normalized units* — to
    model pixel noise σ_px at focal f, pass σ_px / f.
    """
    k_axis, k_angle, k_pts, k_depth, k_n1, k_n2 = jax.random.split(key, 6)

    axis = jax.random.normal(k_axis, (batch, 3), dtype)
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    if rotation_deg < 0:
        angle = jax.random.uniform(k_angle, (batch,), dtype) * jnp.pi
    else:
        angle = jnp.full((batch,), rotation_deg * jnp.pi / 180.0, dtype)
    r = axis * angle[..., None]
    R = so3_exp(r)
    e3 = jnp.array([0.0, 0.0, 1.0], dtype)
    t = R[..., :, 2] - e3
    if inward:
        t = -t
    E = skew(t) @ R

    # First-view rays: unit-z homogeneous with N(0,1) image coordinates.
    xy = jax.random.normal(k_pts, (batch, num_corr, 2), dtype)
    u = jnp.concatenate([xy, jnp.ones((batch, num_corr, 1), dtype)], axis=-1)

    # Depths along the first-view ray.
    d01 = jax.random.uniform(k_depth, (batch, num_corr), dtype)
    depth = (d01 * 0.25 + 0.5) if inward else (d01 * 2.0 + 6.0)
    X = u * depth[..., None]

    # Project into the second view.
    P2X = jnp.einsum("bij,bnj->bni", R, X) + t[:, None, :]
    valid = P2X[..., 2] > 0
    z = jnp.where(jnp.abs(P2X[..., 2]) > 1e-12, P2X[..., 2], 1e-12)
    v_xy = P2X[..., :2] / z[..., None]
    v = jnp.concatenate([v_xy, jnp.ones((batch, num_corr, 1), dtype)], axis=-1)

    if point_noise > 0:
        u = u.at[..., :2].add(point_noise * jax.random.normal(k_n1, (batch, num_corr, 2), dtype))
        v = v.at[..., :2].add(point_noise * jax.random.normal(k_n2, (batch, num_corr, 2), dtype))

    return RelativePoseProblem(u=u, v=v, E=E, R=R, t=t, r=r, valid=valid)


def make_circular_scene(
    key: jax.Array,
    num_cameras: int,
    num_points: int,
    inward: bool = False,
    point_radius_range=(4.0, 10.0),
    dtype=jnp.float64,
):
    """A full synthetic circular spherical capture for end-to-end testing.

    Cameras sit on the unit circle in the xz-plane (a camera moving on the
    sphere's equator): camera i has world-from-camera rotation about the
    y-axis by φ_i = 2πi/N, pose (r_i, t=(0,0,∓1)). Points are scattered in a
    shell around the rig. Returns (poses_r (N,3), t_z sign, points (M,3)).
    """
    k_pts, k_dir = jax.random.split(key)
    phi = jnp.arange(num_cameras, dtype=dtype) * (2.0 * jnp.pi / num_cameras)
    # Rotation about y by phi: world->camera rotation r_i = (0, phi_i, 0).
    poses_r = jnp.stack([jnp.zeros_like(phi), phi, jnp.zeros_like(phi)], axis=-1)
    tz = 1.0 if inward else -1.0
    poses_t = jnp.broadcast_to(jnp.array([0.0, 0.0, tz], dtype), (num_cameras, 3))

    dirs = jax.random.normal(k_dir, (num_points, 3), dtype)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    lo, hi = point_radius_range
    if inward:
        radii = jax.random.uniform(k_pts, (num_points,), dtype) * 0.5
    else:
        radii = lo + (hi - lo) * jax.random.uniform(k_pts, (num_points,), dtype)
    points = dirs * radii[..., None]
    return poses_r, poses_t, points


def corrupt_match_table(idx1, mmask, pair_j, counts, fraction: float,
                        seed: int = 0):
    """Inject outlier correspondences into a padded match table: for each
    pair, replace `fraction` of its valid matches' second-frame indices with
    a random (wrong) keypoint of that frame.

    The PhoneSweep difficulty stand-in (reference
    scripts/evaluate_sfm_relative.py benchmarks real handheld captures whose
    ratio-test survivors carry 10-40% mismatches); rendered captures match
    too cleanly, so the hard evaluation suite corrupts the tables explicitly
    and the pipeline's RANSAC/robust-loss layers must absorb it. Host numpy.
    Returns a new idx1.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    idx1 = np.array(idx1, copy=True)
    P, _ = idx1.shape
    for p in range(P):
        valid = np.nonzero(mmask[p])[0]
        k = int(round(len(valid) * fraction))
        if k == 0:
            continue
        sel = rng.choice(valid, size=k, replace=False)
        kj = int(counts[pair_j[p]])
        idx1[p, sel] = rng.integers(0, max(kj, 1), size=k)
    return idx1


def make_ring_scene(C=2000, W=520, P=131072, noise=0.5, seed=0,
                    dtype=np.float32):
    """Large BA scene: C cameras on the unit circle (every frame a keyframe,
    reference sfm.cpp:200-212 SPARSE_SCHUR scale), P points in an annulus
    around it, each camera observing a contiguous window of W points. The
    observation table is built camera-major, so it is already
    camera-sorted for `cam_ptr`. Host numpy throughout."""
    from ..geometry.so3 import np_so3_exp
    from ..optim.ba import BAProblem, build_tracks

    rng = np.random.default_rng(seed)
    focal = 600.0
    phi = np.arange(C) * 2 * np.pi / C
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1).astype(dtype)
    cam_t = np.tile([0, 0, -1.0], (C, 1)).astype(dtype)

    # point j at azimuth −2πj/P (so camera i≈jC/P sees it head-on)
    theta = -np.arange(P) * 2 * np.pi / P
    rad = rng.uniform(5.0, 9.0, P)
    y = rng.uniform(-1.5, 1.5, P)
    pts = np.stack(
        [rad * np.sin(theta), y, rad * np.cos(theta)], -1
    ).astype(dtype)

    # camera i observes the W points centred on index i·P/C
    centers = (np.arange(C) * (P / C)).astype(np.int64)
    win = np.arange(W) - W // 2
    obs_pt = ((centers[:, None] + win[None, :]) % P).reshape(-1).astype(np.int32)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), W)

    R = np_so3_exp(cam_r.astype(np.float64))
    px = (
        np.einsum("kij,kj->ki", R[obs_cam], pts[obs_pt].astype(np.float64))
        + cam_t[obs_cam]
    )
    good = px[:, 2] > 0.5
    uv = focal * px[:, :2] / np.where(good, px[:, 2], 1.0)[:, None]
    uv = uv + rng.normal(size=uv.shape) * noise
    w = good.astype(dtype)
    cnt = np.bincount(obs_pt, weights=w, minlength=P)
    w = w * (cnt[obs_pt] >= 3)

    track_obs, track_mask = build_tracks(obs_pt, P)
    track_mask = track_mask & (w[track_obs] > 0)
    cam_ptr = np.arange(C + 1, dtype=np.int32) * W

    rot_fixed = np.zeros(C, bool)
    rot_fixed[0] = True
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape).astype(dtype) * 0.002
    cam_r_pert[0] = cam_r[0]
    pts_pert = pts + rng.normal(size=pts.shape).astype(dtype) * 0.03

    return BAProblem(
        focal=jnp.asarray(focal, dtype),
        cam_t=jnp.asarray(cam_t),
        cam_r=jnp.asarray(cam_r_pert),
        points=jnp.asarray(pts_pert),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv.astype(dtype)),
        obs_w=jnp.asarray(w),
        track_obs=jnp.asarray(track_obs),
        track_mask=jnp.asarray(track_mask),
        focal_fixed=jnp.asarray(True),
        rot_fixed=jnp.asarray(rot_fixed),
        trans_fixed=jnp.ones(C, bool),
        point_fixed=jnp.zeros(P, bool),
        cam_ptr=jnp.asarray(cam_ptr),
    )


def make_bench_scene():
    """The 64-camera BA scene (8000 points, ~41k observations): cameras on
    the unit circle, points in a shell around it, observed where they fall
    inside a ±0.8 × ±0.6 normalized field of view."""
    from ..geometry.so3 import np_so3_exp
    from ..optim.ba import BAProblem, build_tracks

    focal = 600.0
    rng = np.random.default_rng(0)
    C, P = 64, 8000
    phi = np.arange(C) * 2 * np.pi / C
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1).astype(np.float32)
    cam_t = np.tile([0, 0, -1.0], (C, 1)).astype(np.float32)
    R = np_so3_exp(cam_r.astype(np.float64)).astype(np.float32)
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = (dirs * rng.uniform(5, 9, (P, 1))).astype(np.float32)
    px = np.einsum("cij,pj->pci", R, pts) + cam_t[None]
    vis = (px[..., 2] > 1.0) & (np.abs(px[..., 0] / px[..., 2]) < 0.8) & (
        np.abs(px[..., 1] / px[..., 2]) < 0.6
    )
    obs_pt, obs_cam = np.nonzero(vis)
    obs_pt = obs_pt.astype(np.int32)
    obs_cam = obs_cam.astype(np.int32)
    obs_uv = (
        focal * px[obs_pt, obs_cam, :2] / px[obs_pt, obs_cam, 2:]
        + rng.normal(size=(len(obs_pt), 2)) * 0.5
    ).astype(np.float32)
    cnt = np.bincount(obs_pt, minlength=P)
    w = (cnt[obs_pt] >= 3).astype(np.float32)
    track_obs, track_mask = build_tracks(obs_pt, P, max_track=16)
    track_mask = track_mask & (w[track_obs] > 0)
    return BAProblem(
        jnp.float32(focal), jnp.asarray(cam_t),
        jnp.asarray(cam_r + rng.normal(size=cam_r.shape).astype(np.float32)
                    * 0.003),
        jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05),
        jnp.asarray(obs_cam), jnp.asarray(obs_pt), jnp.asarray(obs_uv),
        jnp.asarray(w), jnp.asarray(track_obs), jnp.asarray(track_mask),
        jnp.asarray(True), jnp.asarray(np.eye(1, C, 0, dtype=bool)[0]),
        jnp.ones(C, bool), jnp.zeros(P, bool),
    )
