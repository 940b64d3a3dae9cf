"""End-to-end reconstruction benchmark on the current accelerator.

BASELINE.md config (2): the calibrated pipeline on a short circular capture
— rendered synthetic imagery with full parallax (the same ray-cast generator
as tests/test_driver.py, at VGA resolution), timed per stage, with final ATE
against the ground-truth trajectory.

Usage:  python scripts/bench_pipeline.py [--frames 48] [--size 640x480]
"""

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("SPHERICALSFM_TPU_X64", "0")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sphericalsfm_tpu  # noqa: E402,F401
from sphericalsfm_tpu.config import PipelineConfig  # noqa: E402
from sphericalsfm_tpu.eval.metrics import ate  # noqa: E402
from sphericalsfm_tpu.geometry import Intrinsics  # noqa: E402
from sphericalsfm_tpu.geometry.so3 import np_so3_exp  # noqa: E402
from sphericalsfm_tpu.pipeline.driver import run_calibrated  # noqa: E402


def render(num_frames, W, H, focal):
    # Rendering 256 VGA frames is ~340 s of host ray-casting; cache the
    # deterministic capture so repeated measurement runs skip it.
    cache = f"/tmp/sfm_render_{num_frames}_{W}x{H}.npz"
    if os.path.exists(cache):
        d = np.load(cache)
        return d["cam_r"], d["cam_t"], d["gray"], d["color"]
    from sphericalsfm_tpu.eval.render import render_capture

    cam_r, cam_t, gray, color = render_capture(
        num_frames=num_frames, focal=focal, width=W, height=H,
        wave_freq=25.0 * (W / 320),
    )
    np.savez(cache, cam_r=cam_r, cam_t=cam_t, gray=gray, color=color)
    return cam_r, cam_t, gray, color


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--keypoints", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=2,
                    help="pipeline runs: first is cold (in-process), last "
                    "is warm; each uses a fresh output dir")
    ap.add_argument("--matching", default="exhaustive",
                    choices=("exhaustive", "windows"),
                    help="pair candidates: O(F^2) exhaustive or the O(F) "
                    "adjacent-band + loop-closure-window mode")
    ap.add_argument("--uncalibrated", action="store_true",
                    help="BASELINE config (3): run the shared-focal pipeline "
                    "(focal search + pose graph) from a (W+H)/2 guess and "
                    "report the recovered-focal error too")
    args = ap.parse_args()
    W, H = (int(x) for x in args.size.split("x"))
    focal = 0.8 * W

    t0 = time.time()
    cam_r_gt, cam_t_gt, gray, color = render(args.frames, W, H, focal)
    t_render = time.time() - t0

    cfg = PipelineConfig()
    cfg.frontend.matching = args.matching
    cfg.frontend.max_keypoints = args.keypoints
    cfg.frontend.max_matches_per_pair = 512
    cfg.ransac.num_hypotheses = 512
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 60
    cfg.ba.solve_dtype = "float32"

    intr = Intrinsics(jnp.asarray(focal), jnp.asarray(W / 2.0),
                      jnp.asarray(H / 2.0))
    walls = []
    focal_est = None
    for run in range(max(args.runs, 1)):
        out = tempfile.mkdtemp()
        t0 = time.time()
        if args.uncalibrated:
            from sphericalsfm_tpu.pipeline.driver import run_uncalibrated

            m, focal_est = run_uncalibrated(
                None, out, cfg, gray=gray, color=color)
        else:
            m = run_calibrated(None, intr, out, cfg, gray=gray, color=color)
        walls.append(time.time() - t0)

    # Per-stage breakdown of the final (warm) run, from the driver's
    # structured stage log (VERDICT r1 item 6: prove where the wall goes).
    stages = {}
    with open(os.path.join(out, "stages.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            stages[rec["stage"]] = round(rec["seconds"], 2)

    R_gt = np_so3_exp(np.asarray(cam_r_gt, np.float64))
    centers_gt = -np.einsum("cji,cj->ci", R_gt, cam_t_gt)
    err = float(ate(jnp.asarray(np.asarray(m.centers(), np.float64)),
                    jnp.asarray(centers_gt)))
    rec = {
        "config": f"{args.frames} frames {W}x{H}, {args.keypoints} kp"
        + (" (uncalibrated)" if args.uncalibrated else ""),
        "device": str(jax.devices()[0]),
        "render_s": round(t_render, 1),
        "pipeline_wall_s": round(walls[0], 1),
        "pipeline_wall_warm_s": round(walls[-1], 1),
        "frames_per_s_warm": round(args.frames / walls[-1], 2),
        "ate": round(err, 5),
        "points": int(m.point_valid().sum()),
        "stages_warm": stages,
    }
    if focal_est is not None:
        rec["focal_true"] = focal
        rec["focal_est"] = round(float(focal_est), 2)
        rec["focal_err_pct"] = round(
            100.0 * abs(float(focal_est) - focal) / focal, 2)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
