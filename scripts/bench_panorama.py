"""Stereo-panorama synthesis benchmark on the current accelerator.

BASELINE.md config (5): render a full-circle capture, then time the full
stitcher (pyramidal Horn–Schunck flow both directions per keyframe pair +
flow-corrected batched column synthesis + spherical remap) — the JAX
replacement for the reference's CUDA Brox-flow stitcher
(/root/reference/src/stereo_panorama_tools.cpp).

Usage: python scripts/bench_panorama.py [--frames 32] [--size 640x480]
       [--pano-width 2048] [--nphi 5]
Prints one JSON line with cold and warm wall time.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--pano-width", type=int, default=2048)
    ap.add_argument("--nphi", type=int, default=5)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    W, H = (int(x) for x in args.size.split("x"))
    focal = 0.8 * W

    from sphericalsfm_tpu.eval.render import render_capture
    from sphericalsfm_tpu.pipeline.stereo_panorama import make_stereo_panoramas

    t0 = time.time()
    cam_r, cam_t, gray, color = render_capture(
        num_frames=args.frames, focal=focal, width=W, height=H,
        wave_freq=25.0 * (W / 320),
    )
    t_render = time.time() - t0

    tmp = tempfile.mkdtemp()
    poses = os.path.join(tmp, "poses.txt")
    with open(poses, "w") as f:
        for i in range(args.frames):
            vals = list(cam_t[i]) + list(cam_r[i])
            f.write(f"{i} " + " ".join(f"{v:.15f}" for v in vals) + " \n")

    walls = []
    fill = 0.0
    for run in range(max(args.runs, 1)):
        out = os.path.join(tmp, f"pano{run}")
        t0 = time.time()
        sphericals = make_stereo_panoramas(
            poses, color, (focal, W / 2.0, H / 2.0), out,
            pano_width=args.pano_width, nphi=args.nphi, is_loop=True,
        )
        walls.append(time.time() - t0)
        fill = float(np.mean([(s.sum(-1) > 0).mean() for s in sphericals]))

    print(json.dumps({
        "config": (f"{args.frames} frames {W}x{H} -> {args.nphi} panoramas "
                   f"x {args.pano_width} cols"),
        "device": str(jax.devices()[0]),
        "render_s": round(t_render, 1),
        "stitch_wall_s": round(walls[0], 1),
        "stitch_wall_warm_s": round(walls[-1], 1),
        "columns_per_s_warm": round(
            args.pano_width * args.nphi / walls[-1], 1),
        "mean_fill": round(fill, 3),
    }))


if __name__ == "__main__":
    main()
