"""Bundle adjustment tests: convergence and parameter recovery on synthetic
spherical captures (SURVEY.md §4: BA convergence on generated scenes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphericalsfm_tpu.geometry import so3_exp
from sphericalsfm_tpu.optim.ba import BAProblem, bundle_adjust, ba_cost, build_tracks

FOCAL = 500.0


def make_scene(seed=0, C=12, P=60, noise=0.0):
    """Cameras on the unit circle (spherical capture), points in a shell."""
    rng = np.random.default_rng(seed)
    phi = np.arange(C) * 2 * np.pi / C * 0.25  # quarter arc
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    cam_t = np.tile(np.array([0.0, 0.0, -1.0]), (C, 1))
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(5.0, 9.0, size=(P, 1))

    R = np.asarray(so3_exp(jnp.asarray(cam_r)))
    obs_cam, obs_pt, obs_uv = [], [], []
    for i in range(C):
        px = pts @ R[i].T + cam_t[i]
        vis = (px[:, 2] > 1.0) & (np.abs(px[:, 0] / px[:, 2]) < 1.2) & (
            np.abs(px[:, 1] / px[:, 2]) < 1.2
        )
        for j in np.nonzero(vis)[0]:
            uv = FOCAL * px[j, :2] / px[j, 2]
            if noise > 0:
                uv = uv + rng.normal(size=2) * noise
            obs_cam.append(i)
            obs_pt.append(j)
            obs_uv.append(uv)
    obs_cam = np.array(obs_cam, np.int32)
    obs_pt = np.array(obs_pt, np.int32)
    obs_uv = np.array(obs_uv)
    # keep only points with >= 3 observations (reference: sfm.cpp:254)
    cnt = np.bincount(obs_pt, minlength=P)
    w = (cnt[obs_pt] >= 3).astype(np.float64)
    return cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w


def build_problem(cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w,
                  focal=FOCAL, spherical=True, fix_first_rot=True,
                  focal_fixed=True):
    C, P = cam_r.shape[0], pts.shape[0]
    track_obs, track_mask = build_tracks(obs_pt, P)
    track_mask = track_mask & (w[track_obs] > 0)
    rot_fixed = np.zeros(C, bool)
    if fix_first_rot:
        rot_fixed[0] = True
    trans_fixed = np.full(C, spherical)
    return BAProblem(
        focal=jnp.asarray(focal, jnp.float64),
        cam_t=jnp.asarray(cam_t),
        cam_r=jnp.asarray(cam_r),
        points=jnp.asarray(pts),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv),
        obs_w=jnp.asarray(w),
        track_obs=jnp.asarray(track_obs),
        track_mask=jnp.asarray(track_mask),
        focal_fixed=jnp.asarray(focal_fixed),
        rot_fixed=jnp.asarray(rot_fixed),
        trans_fixed=jnp.asarray(trans_fixed),
        point_fixed=jnp.zeros(P, bool),
    )


def test_ba_zero_at_ground_truth():
    scene = make_scene()
    p = build_problem(*scene)
    cost = float(ba_cost(p.focal, p.cam_t, p.cam_r, p.points, p))
    assert cost < 1e-18


def test_ba_spherical_recovers_perturbed_rotations():
    scene = make_scene(seed=1)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(2)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.01
    cam_r_pert[0] = cam_r[0]  # first camera stays fixed
    pts_pert = pts + rng.normal(size=pts.shape) * 0.05
    p = build_problem(cam_r_pert, cam_t, pts_pert, *rest)
    res = bundle_adjust(p, max_iters=40)
    assert float(res.cost) < 1e-10 * max(1.0, float(res.initial_cost))
    np.testing.assert_allclose(np.asarray(res.cam_r), cam_r, atol=1e-6)


def test_ba_noise_converges():
    scene = make_scene(seed=3, noise=0.5)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(4)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.005
    cam_r_pert[0] = cam_r[0]
    pts_pert = pts + rng.normal(size=pts.shape) * 0.02
    p = build_problem(cam_r_pert, cam_t, pts_pert, *rest)
    res = bundle_adjust(p, max_iters=40)
    # Residual should settle near the noise floor: ~0.5px per obs coordinate.
    K = np.count_nonzero(np.asarray(p.obs_w))
    rms = np.sqrt(2 * float(res.cost) / K / 2)
    assert rms < 1.0, rms


def test_ba_general_mode_converges():
    """Translations free (general BA stage, run_spherical_sfm.cpp:102-107)."""
    scene = make_scene(seed=5)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(6)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.005
    cam_r_pert[0] = cam_r[0]
    cam_t_pert = cam_t + rng.normal(size=cam_t.shape) * 0.01
    cam_t_pert[0] = cam_t[0]
    p = build_problem(cam_r_pert, cam_t_pert, pts, *rest, spherical=False)
    res = bundle_adjust(p, max_iters=60)
    assert float(res.cost) < 1e-9 * max(1.0, float(res.initial_cost))


def test_ba_focal_recovery():
    """Focal as a BA parameter (uncalibrated pipeline stage,
    run_spherical_sfm_uncalib.cpp:178)."""
    scene = make_scene(seed=7)
    cam_r, cam_t, pts, *rest = scene
    p = build_problem(cam_r, cam_t, pts, *rest, focal=FOCAL * 1.1,
                      focal_fixed=False)
    res = bundle_adjust(p, max_iters=60)
    assert abs(float(res.focal) - FOCAL) / FOCAL < 1e-3, float(res.focal)


def test_ba_f32_solve_path():
    """The accelerator regime: float32 reduced-system solve still converges."""
    scene = make_scene(seed=8)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(9)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.005
    cam_r_pert[0] = cam_r[0]
    p = build_problem(cam_r_pert, cam_t, pts, *rest)
    res = bundle_adjust(p, max_iters=40, solve_dtype_name="float32")
    K = np.count_nonzero(np.asarray(p.obs_w))
    rms = np.sqrt(2 * float(res.cost) / K / 2)
    assert rms < 0.1, rms


def test_ba_pcg_matches_dense():
    """The matrix-free PCG camera solve (Ceres SPARSE_SCHUR analogue) must
    reach the same optimum as the exact dense Schur solve."""
    scene = make_scene(seed=1)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(2)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.01
    cam_r_pert[0] = cam_r[0]
    pts_pert = pts + rng.normal(size=pts.shape) * 0.05
    p = build_problem(cam_r_pert, cam_t, pts_pert, *rest)
    res_d = bundle_adjust(p, max_iters=40, camera_solver="dense")
    res_p = bundle_adjust(p, max_iters=40, camera_solver="pcg")
    assert float(res_p.cost) < 1e-10 * max(1.0, float(res_p.initial_cost))
    np.testing.assert_allclose(
        np.asarray(res_p.cam_r), np.asarray(res_d.cam_r), atol=1e-8
    )
    # The optional coarse-grid preconditioner level must not change the
    # reached optimum (it is a preconditioner, not the operator).
    res_c = bundle_adjust(p, max_iters=40, camera_solver="pcg",
                          pcg_coarse=4)
    assert float(res_c.cost) < 1e-10 * max(1.0, float(res_c.initial_cost))
    np.testing.assert_allclose(
        np.asarray(res_c.cam_r), np.asarray(res_d.cam_r), atol=1e-8
    )
    # The pairs-based dense assembly (auto dispatch for 32 < C <= 512) is
    # the SAME exact solve with an O(K + sum T^2) off-diagonal fill — it
    # must land on the dense optimum too.
    res_pair = bundle_adjust(p, max_iters=40, camera_solver="dense_pairs")
    assert float(res_pair.cost) < 1e-10 * max(1.0, float(res_pair.initial_cost))
    np.testing.assert_allclose(
        np.asarray(res_pair.cam_r), np.asarray(res_d.cam_r), atol=1e-8
    )


def test_ba_pcg_focal_and_general():
    """PCG path with focal free and with translations free."""
    scene = make_scene(seed=7)
    cam_r, cam_t, pts, *rest = scene
    p = build_problem(cam_r, cam_t, pts, *rest, focal=FOCAL * 1.1,
                      focal_fixed=False)
    res = bundle_adjust(p, max_iters=60, camera_solver="pcg")
    assert abs(float(res.focal) - FOCAL) / FOCAL < 1e-3, float(res.focal)

    scene = make_scene(seed=5)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(6)
    cam_r_p = cam_r + rng.normal(size=cam_r.shape) * 0.005
    cam_r_p[0] = cam_r[0]
    cam_t_p = cam_t + rng.normal(size=cam_t.shape) * 0.01
    cam_t_p[0] = cam_t[0]
    p = build_problem(cam_r_p, cam_t_p, pts, *rest, spherical=False)
    res = bundle_adjust(p, max_iters=60, camera_solver="pcg")
    assert float(res.cost) < 1e-9 * max(1.0, float(res.initial_cost))


def test_ba_pcg_auto_at_scale():
    """camera_solver="auto" switches to PCG above the dense threshold and
    converges on a few-hundred-camera ring (the scale VERDICT item 1 targets)."""
    scene = make_scene(seed=21, C=220, P=900, noise=0.3)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(22)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.003
    cam_r_pert[0] = cam_r[0]
    p = build_problem(cam_r_pert, cam_t, pts, *rest)
    res = bundle_adjust(p, max_iters=25, camera_solver="auto")
    K = np.count_nonzero(np.asarray(p.obs_w))
    rms = np.sqrt(2 * float(res.cost) / K / 2)
    assert rms < 1.0, rms


def test_ba_pcg_f32_solve():
    """Accelerator regime: f32 PCG solve converges to the noise floor."""
    scene = make_scene(seed=8, noise=0.2)
    cam_r, cam_t, pts, *rest = scene
    rng = np.random.default_rng(9)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.005
    cam_r_pert[0] = cam_r[0]
    p = build_problem(cam_r_pert, cam_t, pts, *rest)
    res = bundle_adjust(p, max_iters=40, camera_solver="pcg",
                        solve_dtype_name="float32", pcg_rtol=1e-6)
    K = np.count_nonzero(np.asarray(p.obs_w))
    rms = np.sqrt(2 * float(res.cost) / K / 2)
    assert rms < 0.5, rms


def test_sorted_segment_sum():
    """Segmented-scan segment sum: exact vs numpy on uneven segments
    (including zero-length), and the f32 absolute error must stay at the
    segment magnitude, not the global-prefix magnitude."""
    from sphericalsfm_tpu.optim.ba import _sorted_segment_sum

    rng = np.random.default_rng(1)
    K, d = 5000, 4
    # same-sign rows: the worst case for prefix-difference cancellation
    x = (rng.random((K, d)).astype(np.float32) + 0.5) * 100.0
    cuts = np.sort(rng.choice(np.arange(1, K), 37, replace=False))
    ptr = np.concatenate([[0], cuts, [cuts[-1]], [K]]).astype(np.int32)
    ref = np.zeros((len(ptr) - 1, d))
    for s in range(len(ptr) - 1):
        ref[s] = x[ptr[s]:ptr[s + 1]].astype(np.float64).sum(0)
    out = np.asarray(jax.jit(_sorted_segment_sum)(
        jnp.asarray(x), jnp.asarray(ptr)))
    # zero-length segment is exactly zero
    zlen = np.where(np.diff(ptr) == 0)[0]
    assert len(zlen) and np.all(out[zlen] == 0.0)
    # error bounded by ~eps relative to each SEGMENT's own magnitude
    seg_mag = np.abs(ref) + 1.0
    rel = np.abs(out - ref) / seg_mag
    assert rel.max() < 5e-5, rel.max()


def test_ba_pcg_f32_converges_at_scale():
    """Regression lock for the f32 PCG numerics fixes (frozen-dim masking,
    segment-local sums, NaN-gated coarse level, exact model decrease):
    at video scale (C=128, f32) the inexact PCG trajectory must land within
    a small factor of the exact dense solve instead of stalling 2-5× above
    it with silently rejected zero steps."""
    C, P = 128, 4096
    rng = np.random.default_rng(0)
    phi = np.arange(C) * 2 * np.pi / C
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1).astype(np.float32)
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1)).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray(cam_r)))
    theta = -np.arange(P) * 2 * np.pi / P
    rad = rng.uniform(5.0, 9.0, P)
    pts = np.stack([rad * np.sin(theta), rng.uniform(-1.5, 1.5, P),
                    rad * np.cos(theta)], -1).astype(np.float32)
    px = np.einsum("cij,pj->pci", R, pts) + cam_t[None]
    vis = (px[..., 2] > 1.0) & (np.abs(px[..., 0] / px[..., 2]) < 0.6)
    obs_pt, obs_cam = np.nonzero(vis)
    keep = np.bincount(obs_pt, minlength=P)[obs_pt] >= 3
    obs_pt, obs_cam = obs_pt[keep].astype(np.int32), obs_cam[keep].astype(np.int32)
    uv = (600.0 * px[obs_pt, obs_cam, :2] / px[obs_pt, obs_cam, 2:]
          + rng.normal(size=(len(obs_pt), 2)) * 0.5).astype(np.float32)
    from sphericalsfm_tpu.optim.ba import BAProblem, build_tracks

    track_obs, track_mask = build_tracks(obs_pt, P)
    prob = BAProblem(
        jnp.float32(600.0), jnp.asarray(cam_t),
        jnp.asarray(cam_r + rng.normal(size=cam_r.shape).astype(np.float32) * 0.004),
        jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05),
        jnp.asarray(obs_cam), jnp.asarray(obs_pt), jnp.asarray(uv),
        jnp.ones(len(obs_pt), jnp.float32),
        jnp.asarray(track_obs), jnp.asarray(track_mask),
        jnp.asarray(True), jnp.asarray(np.eye(1, C, 0, dtype=bool)[0]),
        jnp.ones(C, bool), jnp.zeros(P, bool),
    )
    kw = dict(max_iters=15, solve_dtype_name="float32", ftol=1e-12)
    res_d = bundle_adjust(prob, camera_solver="dense_pairs", **kw)
    res_p = bundle_adjust(prob, camera_solver="pcg", pcg_rtol=1e-2,
                          pcg_iters=25, **kw)
    assert float(res_d.cost) < 0.5 * float(res_d.initial_cost)
    assert float(res_p.cost) < 1.3 * float(res_d.cost), (
        float(res_p.cost), float(res_d.cost))


def test_ba_matches_scipy_reference():
    """Independent cross-check: our Schur LM must reach the same minimum as
    scipy's trust-region least_squares on the identical robust problem."""
    import scipy.optimize

    from sphericalsfm_tpu.geometry.so3 import so3_exp as _exp

    scene = make_scene(seed=11, C=6, P=30, noise=0.3)
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    rng = np.random.default_rng(12)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.01
    cam_r_pert[0] = cam_r[0]
    pts_pert = pts + rng.normal(size=pts.shape) * 0.05

    p = build_problem(cam_r_pert, cam_t, pts_pert, *scene[3:],
                      spherical=True)
    p = p._replace(cam_r=jnp.asarray(cam_r_pert), points=jnp.asarray(pts_pert))
    res = bundle_adjust(p, max_iters=100)

    # scipy: parameters = rotations of cams 1..C-1 + all points; same
    # residuals with Cauchy loss (soft_l1 differs — use cauchy).
    C, P = cam_r.shape[0], pts.shape[0]
    sel = np.asarray(p.obs_w) > 0

    def residuals(theta):
        crs = np.concatenate([cam_r[:1], theta[: 3 * (C - 1)].reshape(C - 1, 3)])
        X = theta[3 * (C - 1):].reshape(P, 3)
        R = np.asarray(_exp(jnp.asarray(crs)))
        px = np.einsum("kij,kj->ki", R[obs_cam[sel]], X[obs_pt[sel]]) + cam_t[obs_cam[sel]]
        proj = FOCAL * px[:, :2] / px[:, 2:]
        return (proj - obs_uv[sel]).ravel()

    theta0 = np.concatenate([cam_r_pert[1:].ravel(), pts_pert.ravel()])
    out = scipy.optimize.least_squares(
        residuals, theta0, loss="cauchy", f_scale=1.0, method="trf",
        max_nfev=300,
    )
    # scipy cost = 0.5 * sum rho(r^2) with rho=cauchy ln(1+s) — same as ours.
    assert abs(float(res.cost) - out.cost) / max(out.cost, 1e-9) < 0.02, (
        float(res.cost), out.cost,
    )


def test_ba_checkpoint_resume(tmp_path):
    """Failure injection (SURVEY §5.3/§5.4): a BA run killed mid-way must
    resume from its on-disk checkpoint and land exactly where an
    uninterrupted segmented run lands."""
    from sphericalsfm_tpu.optim.ba import bundle_adjust_checkpointed

    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = make_scene(seed=2, noise=0.5)
    rng = np.random.default_rng(0)
    prob = build_problem(
        cam_r + rng.normal(size=cam_r.shape) * 0.01, cam_t,
        pts + rng.normal(size=pts.shape) * 0.05,
        obs_cam, obs_pt, obs_uv, w,
    )

    # uninterrupted segmented run
    ck_a = str(tmp_path / "a.npz")
    res_full = bundle_adjust_checkpointed(prob, ck_a, max_iters=12, segment=4)

    # "crash" after one segment: first invocation only allowed 4 iters...
    ck_b = str(tmp_path / "b.npz")
    res_part = bundle_adjust_checkpointed(prob, ck_b, max_iters=4, segment=4)
    assert int(res_part.iterations) == 4
    # ...then a fresh invocation resumes from the checkpoint file
    res_resumed = bundle_adjust_checkpointed(prob, ck_b, max_iters=12, segment=4)

    assert int(res_resumed.iterations) == int(res_full.iterations)
    np.testing.assert_allclose(np.asarray(res_resumed.cost),
                               np.asarray(res_full.cost), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res_resumed.cam_r),
                               np.asarray(res_full.cam_r), atol=1e-12)
    np.testing.assert_allclose(np.asarray(res_resumed.points),
                               np.asarray(res_full.points), atol=1e-12)
    # the run actually optimized
    assert float(res_full.cost) < float(res_full.initial_cost) * 0.5


def test_auto_dispatch_rules(monkeypatch):
    """prepare_problem's measured dispatch: scan-dense for short-track maps,
    pairs for long-track mid-size maps, pcg above the HBM pair cap (the
    e2e256 video map's 15M-pair table once ran a card out of memory)."""
    from sphericalsfm_tpu.optim import ba as _ba

    scene = make_scene(seed=7, C=48, P=96)
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    p = build_problem(cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w)

    # short tracks, complete table, few pairs -> the one-hot scan wins
    p2, solver = _ba.prepare_problem(p, "auto")
    assert solver == "dense", solver

    # same problem with the pair cap forced tiny -> dense_pairs would have
    # been chosen if the scan were expensive; force the scan rule off by
    # truncating the track table (incomplete => scan ineligible)
    import numpy as np
    p_trunc = p._replace(track_obs=np.asarray(p.track_obs)[:, :1],
                         track_mask=np.asarray(p.track_mask)[:, :1])
    p3, solver3 = _ba.prepare_problem(p_trunc, "auto")
    assert solver3 == "dense_pairs", solver3
    assert p3.cc_ptr is not None

    # above the HBM pair cap the exact solvers must give way to pcg
    monkeypatch.setattr(_ba, "_DENSE_PAIRS_CAP", 1)
    p4, solver4 = _ba.prepare_problem(p_trunc, "auto")
    assert solver4 == "pcg", solver4


def test_slot_schur_matches_obs_major():
    """The slot-major dense Schur step (_schur_solve_slots) must reproduce
    the obs-major _schur_solve step exactly (complete track table): same
    d_focal / d_cam / d_points / model decrease, including freeze masks,
    robust weights, and w=0 observations."""
    from sphericalsfm_tpu.optim import ba as ba_mod

    scene = make_scene(seed=3, noise=1.0)
    for spherical, focal_fixed in [(True, True), (False, False)]:
        p = build_problem(*scene, spherical=spherical,
                          focal_fixed=focal_fixed)
        # freeze an extra camera + a point to exercise the gauge masks
        p = p._replace(
            rot_fixed=jnp.asarray(np.array([True, False] * 6)),
            point_fixed=jnp.asarray(
                np.arange(p.points.shape[0]) % 7 == 0),
        )
        lam = jnp.asarray(1e-3, p.points.dtype)
        e, Jf, Jc, Jx = ba_mod._per_obs_jacobians(
            p.focal, p.cam_t, p.cam_r, p.points, p)
        ref = ba_mod._schur_solve(e, Jf, Jc, Jx, p, lam, 1.0,
                                  jnp.float64)
        st = ba_mod._build_slot_tables(p, p.points.dtype)
        new = ba_mod._schur_solve_slots(
            p.focal, p.cam_t, p.cam_r, p.points, st, p, lam, 1.0,
            jnp.float64)
        for a, b, name in zip(ref, new, ["d_f", "d_cam", "d_pts", "md"]):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-7, atol=1e-10,
                err_msg=f"{name} (spherical={spherical})")
        # slot cost == obs-major cost on a complete table
        c_ref = float(ba_cost(p.focal, p.cam_t, p.cam_r, p.points, p))
        c_new = float(ba_mod._ba_cost_slots(
            p.focal, p.cam_t, p.cam_r, p.points, st, p))
        assert abs(c_new - c_ref) <= 1e-9 * max(1.0, c_ref)


def test_obs_major_soa_jacobians_match_autodiff():
    """`_per_obs_jacobians_soa` (analytic SoA planes, r5) must reproduce the
    vmapped-jacfwd obs-major Jacobians and `_ba_cost_obs_soa` the obs-major
    cost — the PCG/dense_pairs LM loops now run the SoA forms."""
    from sphericalsfm_tpu.optim import ba as ba_mod

    scene = make_scene(seed=13, C=16, P=80, noise=0.4)
    for spherical in (True, False):
        p = build_problem(*scene, spherical=spherical, focal_fixed=False)
        # perturb so rotations are generic (incl. near-zero angles)
        rng = np.random.default_rng(5)
        p = p._replace(
            cam_r=p.cam_r + jnp.asarray(
                rng.normal(size=p.cam_r.shape) * 0.05
            ).at[3].set(0.0),
            points=p.points * (1.0 + 0.01 * jnp.asarray(
                rng.normal(size=p.points.shape))),
        )
        e_r, Jf_r, Jc_r, Jx_r = ba_mod._per_obs_jacobians(
            p.focal, p.cam_t, p.cam_r, p.points, p)
        e_s, Jf_s, Jc_s, Jx_s = ba_mod._per_obs_jacobians_soa(
            p.focal, p.cam_t, p.cam_r, p.points, p)
        for a, b, name in ((e_r, e_s, "e"), (Jf_r, Jf_s, "Jf"),
                           (Jc_r, Jc_s, "Jc"), (Jx_r, Jx_s, "Jx")):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-9, atol=1e-12,
                err_msg=f"{name} (spherical={spherical})")
        c_ref = float(ba_cost(p.focal, p.cam_t, p.cam_r, p.points, p))
        c_soa = float(ba_mod._ba_cost_obs_soa(
            p.focal, p.cam_t, p.cam_r, p.points, p))
        assert abs(c_soa - c_ref) <= 1e-9 * max(1.0, c_ref)


def test_plane_assembly_matches_row_major():
    """`_assemble_reduced_planes` / the plane PCG+dense_pairs steps (r5
    plane-major rewrite) must reproduce `_assemble_reduced` on the SoA
    stacked Jacobians field-for-field, and the solver outputs to roundoff."""
    from sphericalsfm_tpu.optim import ba as ba_mod

    scene = make_scene(seed=17, C=20, P=120, noise=0.4)
    for spherical, focal_fixed in ((True, True), (False, False)):
        p = build_problem(*scene, spherical=spherical,
                          focal_fixed=focal_fixed)
        p = ba_mod.sort_obs_by_camera(p)
        p = ba_mod.build_cc_pairs(p)
        lam = jnp.asarray(3e-4, p.points.dtype)
        e, Jf, Jc, Jx = ba_mod._per_obs_jacobians_soa(
            p.focal, p.cam_t, p.cam_r, p.points, p)
        rs_ref = ba_mod._assemble_reduced(e, Jf, Jc, Jx, p, lam, 1.0,
                                          jnp.float64)
        rs_new = ba_mod._assemble_reduced_planes(
            p.focal, p.cam_t, p.cam_r, p.points, p, lam, 1.0, jnp.float64)
        for name in rs_ref._fields:
            a = np.asarray(getattr(rs_ref, name))
            b = np.asarray(getattr(rs_new, name))
            scale = max(1.0, np.abs(a).max()) if a.size else 1.0
            np.testing.assert_allclose(
                b, a, rtol=1e-9, atol=1e-9 * scale,
                err_msg=f"{name} (spherical={spherical})")
        ref = ba_mod._schur_solve_pcg(e, Jf, Jc, Jx, p, lam, 1.0,
                                      jnp.float64, 200, 1e-10, 0)
        new = ba_mod._schur_solve_pcg_planes(
            p.focal, p.cam_t, p.cam_r, p.points, p, lam, 1.0,
            jnp.float64, 200, 1e-10, 0)
        for a, b, name in zip(ref, new, ["d_f", "d_cam", "d_pts", "md"]):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-9,
                err_msg=f"pcg {name}")
        ref = ba_mod._schur_solve_dense_pairs(e, Jf, Jc, Jx, p, lam, 1.0,
                                              jnp.float64)
        new = ba_mod._schur_solve_dense_pairs_planes(
            p.focal, p.cam_t, p.cam_r, p.points, p, lam, 1.0, jnp.float64)
        for a, b, name in zip(ref, new, ["d_f", "d_cam", "d_pts", "md"]):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-7, atol=1e-10,
                err_msg=f"dense_pairs {name}")


def test_sorted_segment_sum_mixed_magnitudes():
    """Weak segments between strong ones keep their own f32 accuracy. A
    difference of global prefix sums returned the 1e-2-scale segments as
    roundoff of the 1e6-scale table (the 2000-camera PCG divergence)."""
    from sphericalsfm_tpu.optim.ba import _sorted_segment_sum

    rng = np.random.default_rng(4)
    lens = rng.integers(100, 600, size=60)
    scale = np.where(np.arange(60) % 3 == 1, 1e-2, 1e6)
    x = np.concatenate([rng.random((n, 6)) * s for n, s in zip(lens, scale)])
    x = x.astype(np.float32)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ref = np.add.reduceat(x.astype(np.float64), ptr[:-1], axis=0)
    out = np.asarray(jax.jit(_sorted_segment_sum)(jnp.asarray(x),
                                                  jnp.asarray(ptr)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)
