"""Driver-level multi-chip tests: cfg.devices routes the PRODUCTION pipeline
through the distributed layer (SURVEY.md §2.5 P1/P2/P3/P5/P8, §5.8) — not a
bespoke script. Stage-level exactness vs the single-device path, plus the
full calibrated and uncalibrated drivers on the 8-way virtual mesh.

The reference has no distributed equivalent (single-process OpenMP,
spherical_sfm_tools.cpp:299,332,588); this is the multi-device capability
the survey's north star defines.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sphericalsfm_tpu.config import FrontendConfig, PipelineConfig
from sphericalsfm_tpu.eval.metrics import ate
from sphericalsfm_tpu.eval.render import render_capture
from sphericalsfm_tpu.geometry.pose import Intrinsics
from sphericalsfm_tpu.geometry.so3 import np_so3_exp
from sphericalsfm_tpu.parallel.sharded import make_mesh
from sphericalsfm_tpu.pipeline.frontend import detect_features, match_pairs
from sphericalsfm_tpu.pipeline.pairwise import estimate_pairwise

FOCAL, W, H = 208.0, 256, 192


@pytest.fixture(scope="module")
def capture():
    return render_capture(num_frames=8, arc=0.5, focal=FOCAL, width=W,
                          height=H, wave_freq=20.0)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def feats(capture):
    _, _, gray, color = capture
    cfg = FrontendConfig(max_keypoints=384, max_matches_per_pair=256,
                         detect_batch=8)
    return detect_features(gray, color, cfg)


def test_sharded_detection_matches_single_device(capture, mesh, feats):
    """Frame-axis shard_map detection (P1) is bitwise per-frame identical."""
    _, _, gray, color = capture
    cfg = FrontendConfig(max_keypoints=384, max_matches_per_pair=256,
                         detect_batch=8)
    f_mesh = detect_features(gray, color, cfg, mesh=mesh)
    assert (feats.valid == f_mesh.valid).all()
    assert np.allclose(feats.xy, f_mesh.xy)
    assert np.allclose(feats.descriptor, f_mesh.descriptor, atol=1e-5)


def test_sharded_matching_matches_single_device(mesh, feats):
    cfg = FrontendConfig(max_keypoints=384, max_matches_per_pair=256)
    pi, pj = np.triu_indices(8, k=1)
    pi, pj = pi.astype(np.int32), pj.astype(np.int32)
    m0 = match_pairs(feats, pi, pj, cfg)
    m1 = match_pairs(feats, pi, pj, cfg, mesh=mesh)
    for a, b in zip(m0, m1):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_sharded_pairwise_matches_single_device(mesh, feats):
    cfg = FrontendConfig(max_keypoints=384, max_matches_per_pair=256)
    pi, pj = np.triu_indices(8, k=1)
    pi, pj = pi.astype(np.int32), pj.astype(np.int32)
    idx0, idx1, mmask = match_pairs(feats, pi, pj, cfg)
    intr = Intrinsics(jnp.asarray(FOCAL), jnp.asarray(W / 2.0),
                      jnp.asarray(H / 2.0))
    key = jax.random.PRNGKey(0)
    pw0 = estimate_pairwise(key, feats.xy, pi, pj, idx0, idx1, mmask, intr,
                            min_num_inliers=30, chunk_size=8)
    pw1 = estimate_pairwise(key, feats.xy, pi, pj, idx0, idx1, mmask, intr,
                            min_num_inliers=30, chunk_size=8, mesh=mesh)
    # same PRNG stream per pair, but GSPMD reduction order can flip
    # near-threshold inliers — require statistical agreement, not bitwise
    assert (pw0.keep == pw1.keep).all()
    assert np.abs(pw0.num_inliers - pw1.num_inliers).max() <= 3
    rot_diff = np.rad2deg(np.linalg.norm(pw0.r - pw1.r, axis=-1))
    assert rot_diff[pw0.keep].max() < 0.1, rot_diff


def _drive_calibrated(capture, devices, tmpdir):
    from sphericalsfm_tpu.pipeline.driver import run_calibrated

    cam_r_gt, cam_t_gt, gray, color = capture
    cfg = PipelineConfig()
    cfg.devices = devices
    cfg.frontend.max_keypoints = 384
    cfg.frontend.max_matches_per_pair = 256
    cfg.ransac.num_hypotheses = 256
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 40
    intr = Intrinsics(jnp.asarray(FOCAL), jnp.asarray(W / 2.0),
                      jnp.asarray(H / 2.0))
    m = run_calibrated(None, intr, str(tmpdir), cfg, gray=gray, color=color)
    R = np_so3_exp(m.cam_r)
    centers = -np.einsum("cji,cj->ci", R, m.cam_t)
    Rg = np_so3_exp(cam_r_gt)
    cg = -np.einsum("cji,cj->ci", Rg, cam_t_gt)
    return float(ate(jnp.asarray(centers), jnp.asarray(cg)))


def test_calibrated_driver_on_mesh_matches_single_device(
    tmp_path_factory, capture
):
    """The FULL calibrated driver with cfg.devices=8: every stage runs
    through the distributed layer and the reconstruction agrees with the
    single-device run to ATE tolerance."""
    a1 = _drive_calibrated(capture, 0, tmp_path_factory.mktemp("mesh0"))
    a8 = _drive_calibrated(capture, 8, tmp_path_factory.mktemp("mesh8"))
    assert a8 < 0.3, a8
    assert abs(a8 - a1) < 0.02, (a1, a8)


def test_uncalibrated_driver_on_mesh_recovers_focal(tmp_path, capture):
    """The uncalibrated shared-focal driver with cfg.devices=8 recovers the
    rendered focal length on the mesh."""
    from sphericalsfm_tpu.pipeline.driver import run_uncalibrated

    _, _, gray, color = capture
    cfg = PipelineConfig()
    cfg.devices = 8
    cfg.frontend.max_keypoints = 384
    cfg.frontend.max_matches_per_pair = 256
    cfg.ransac.num_hypotheses = 256
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 40
    cfg.focal.num_trials = 256
    m, focal = run_uncalibrated(None, str(tmp_path), cfg, gray=gray,
                                color=color)
    assert abs(focal - FOCAL) / FOCAL < 0.08, focal


def test_devices_must_be_power_of_two():
    from sphericalsfm_tpu.pipeline.driver import pipeline_mesh

    cfg = PipelineConfig()
    cfg.devices = 6
    with pytest.raises(ValueError):
        pipeline_mesh(cfg)
    cfg.devices = 1
    assert pipeline_mesh(cfg) is None
