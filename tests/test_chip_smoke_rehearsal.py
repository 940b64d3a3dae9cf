"""Tiny-size rehearsals of chip_smoke.py's driver phases on the CPU (slow
tier): the same phase functions and gates the card runs, at shapes the CPU
backend finishes in about a minute each."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _small_cfg():
    from sphericalsfm_tpu.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.ba.solve_dtype = "float32"
    cfg.frontend.max_keypoints = 512
    cfg.frontend.max_matches_per_pair = 384
    cfg.ransac.num_hypotheses = 384
    cfg.ransac.min_num_inliers = 30
    cfg.focal.num_trials = 256
    cfg.ba.max_iters = 60
    return cfg


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("smoke_cal"))
    rec = chip_smoke.phase_calibrated(out, frames=24, width=320, height=240,
                                      focal=260.0, cfg=_small_cfg(),
                                      compare_matchers=False)
    return out, rec


def test_calibrated_phase(calibrated):
    _, rec = calibrated
    assert rec["warm_compiles"] == 0
    assert rec["ate_warm"] < 0.05


def test_panorama_phase(calibrated):
    out, rec = calibrated
    pano = chip_smoke.phase_panorama(out, rec["poses"], rec["color"], 260.0,
                                     pano_width=360, flow_levels=3)
    assert pano["panoramas"] == 9


def test_uncalibrated_phase(tmp_path):
    cfg = _small_cfg()
    cfg.general_ba = True
    rec = chip_smoke.phase_uncalibrated(str(tmp_path), frames=16, width=320,
                                        height=240, focal=260.0, cfg=cfg)
    assert rec["focal_rel_err"] < 0.02


def test_ba_pcg_phase():
    rec = chip_smoke.phase_ba_pcg(C=600, W=80, P=12000, iters=5)
    assert rec["solver"] == "pcg"


def test_multi_device_phases(tmp_path):
    """The --devices 4 phases on four virtual CPU devices."""
    chip_smoke.phase_multi_ring(4, frames=8, K=256, max_matches=128)
    chip_smoke.phase_multi_ba(4, ring=(600, 80, 12000), iters=5)
    rec = chip_smoke.phase_multi_calibrated(
        str(tmp_path), 4, frames=24, width=320, height=240, focal=260.0,
        cfg_fn=_small_cfg)
    assert rec["ate_diff"] < 0.02
