"""chip_smoke.py on the CPU: it must refuse to run, its phases must be
importable without imaging packages, and its matcher phase must check the
kernel (in interpret mode here, compiled for the card under `-m gpu`)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(code_or_args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_refuses_to_run_without_a_gpu():
    proc = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_entry_points_import_without_imaging_packages():
    """cv2, imageio and matplotlib stay off the smoke run's path."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'imageio', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "from sphericalsfm_tpu.pipeline.driver import (run_calibrated,\n"
        "    run_uncalibrated)\n"
        "from sphericalsfm_tpu.pipeline.stereo_panorama import (\n"
        "    make_stereo_panoramas)\n"
        "print('imported')\n"
    )
    proc = _run(["-c", code], {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_matcher_phase_tiny_interpret(capsys):
    rec = chip_smoke.phase_matcher(pairs=2, ks=(256, 200), time_pairs=2,
                                   time_k=200, reps=1, interpret=True)
    assert set(rec["checks"]) == {256, 200}
    for c in rec["checks"].values():
        assert c["nn_agreement"] >= 0.999 and c["max_abs_dm1"] <= 1e-2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "matcher" and line["interpret"] is True


def test_match_stage_tiny_interpret():
    """The calibrated phase's matcher check on a rendered capture's own
    detector descriptors (bf16 rounds them) and its two timed sweeps."""
    from sphericalsfm_tpu.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 256
    cfg.frontend.max_matches_per_pair = 128
    _, _, gray, color = chip_smoke._render(6, 260.0, 320, 240)
    rec = chip_smoke._match_stage(gray, color, cfg, check_pairs=3, chunk=8,
                                  reps=1, interpret=True)
    assert rec["pairs"] == 15
    assert rec["capture_check"]["accepted"] > 0
    assert rec["capture_check"]["max_abs_dm1"] <= chip_smoke.BF16_D2_BOUND
    assert rec["kernel"] > 0 and rec["xla_bf16"] > 0


def test_gate_raises():
    chip_smoke.gate("fine", True, 0)
    with pytest.raises(chip_smoke.GateFailed):
        chip_smoke.gate("broken", False, 1)


@pytest.mark.gpu
def test_matcher_phase_on_card(gpu_device):
    """The kernel compiled for the card, at the smoke run's widths."""
    rec = chip_smoke.phase_matcher(reps=3)
    assert rec["kernel_us_per_pair"] > 0
