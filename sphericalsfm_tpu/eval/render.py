"""Synthetic capture renderer for end-to-end evaluation.

Ray-casts a band-limited random 3D texture on a sphere from cameras on the
unit circle (spherical capture geometry) — real parallax and dense texture,
the CPU-testable stand-in for the PhoneSweep sequences the reference
evaluates on (scripts/evaluate_sfm_relative.py; dataset not fetchable in
this environment).

The ray-cast + texture evaluation is one jitted device program (frames
scanned, rows blocked so the (pixels, n_waves) phase matrix stays small) —
rendering 256 VGA frames takes seconds instead of the ~10 s/frame the
original host-numpy loop cost.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry.so3 import so3_exp


@partial(jax.jit, static_argnames=("height", "width", "row_block"))
def _render_frames(
    cam_r,        # (F, 3) world→camera axis-angle
    cam_t,        # (F, 3)
    wvec,         # (n_waves, 3)
    phase,        # (n_waves,)
    amp,          # (n_waves,)
    focal,        # scalar
    r2,           # scalar: sphere_radius**2
    *,
    height: int,
    width: int,
    row_block: int = 60,
):
    """Scan over frames; block rows so the (B*W, n_waves) intermediate is
    bounded (a full VGA frame would materialize ~740 MB per frame)."""
    # HIGHEST matmul precision throughout: with reduced-precision matmul
    # inputs (bf16 at the first chip's default) the ray-direction and
    # wave-phase products render a
    # smoothly WARPED scene — pixel-scale, geometry-coherent texture
    # displacement that the pipeline then faithfully reconstructs. Found in
    # round 5: general BA on bf16-rendered sequences converged to ATE 0.26
    # "distortions" that fit the rendered observations 2.7x better than the
    # analytic ground truth did (f800_140: GT-pose optimal-point median
    # residual 0.55 px vs the fitted model's 0.205 px).
    ys, xs = jnp.mgrid[0:height, 0:width]
    dirs_cam = jnp.stack(
        [
            (xs - width / 2) / focal,
            (ys - height / 2) / focal,
            jnp.ones_like(xs, jnp.float32),
        ],
        -1,
    ).astype(jnp.float32)                      # (H, W, 3)
    n_blocks = -(-height // row_block)
    pad = n_blocks * row_block - height
    dirs_blocked = jnp.pad(dirs_cam, ((0, pad), (0, 0), (0, 0))).reshape(
        n_blocks, row_block, width, 3
    )
    R = so3_exp(cam_r).astype(jnp.float32)     # (F, 3, 3)

    hp = jax.lax.Precision.HIGHEST

    def one_frame(_, rt):
        Ri, ti = rt
        center = -jnp.matmul(Ri.T, ti, precision=hp)  # camera center

        def one_block(_, dirs_b):              # (B, W, 3)
            d = jnp.matmul(dirs_b, Ri, precision=hp)  # R^T·dir rows
            d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
            cd = jnp.matmul(d, center, precision=hp)
            tt = -cd + jnp.sqrt(
                jnp.maximum(cd * cd - jnp.sum(center * center) + r2, 0.0)
            )
            p = center + d * tt[..., None]     # (B, W, 3) on the sphere
            ph = jnp.matmul(p.reshape(-1, 3), wvec.T, precision=hp) + phase
            return None, jnp.matmul(
                jnp.cos(ph), amp, precision=hp
            ).reshape(dirs_b.shape[:2])

        _, tex = jax.lax.scan(one_block, None, dirs_blocked)
        tex = tex.reshape(n_blocks * row_block, width)[:height]
        lo, hi = tex.min(), tex.max()
        return None, (tex - lo) / jnp.maximum(hi - lo, 1e-9)

    _, gray = jax.lax.scan(one_frame, None, (R, cam_t))
    return gray                                 # (F, H, W) float32 in [0,1]


def render_capture(
    num_frames: int = 16,
    arc: float = 1.0,
    focal: float = 260.0,
    width: int = 320,
    height: int = 240,
    seed: int = 7,
    sphere_radius: float = 8.0,
    inward: bool = False,
    n_waves: int = 600,
    wave_freq: float = 25.0,
):
    """Returns (cam_r (F,3) world→camera axis-angle, cam_t (F,3), gray
    (F,H,W) float32 in [0,1], color (F,H,W,3) uint8). `wave_freq` is the max
    spatial frequency of the texture — scale it with resolution
    (25·width/320) to keep per-pixel texture detail constant."""
    rng = np.random.default_rng(seed)
    wdir = rng.normal(size=(n_waves, 3))
    wdir /= np.linalg.norm(wdir, axis=-1, keepdims=True)
    wvec = (wdir * rng.uniform(1.0, wave_freq, (n_waves, 1))).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    amp = (rng.uniform(0.3, 1.0, n_waves) / np.sqrt(n_waves)).astype(np.float32)

    phi = np.arange(num_frames) * 2 * np.pi * arc / num_frames
    cam_r = np.stack([np.zeros(num_frames), phi, np.zeros(num_frames)], -1)
    tz = 1.0 if inward else -1.0
    cam_t = np.tile([0.0, 0.0, tz], (num_frames, 1))

    gray = np.asarray(
        _render_frames(
            jnp.asarray(cam_r, jnp.float32), jnp.asarray(cam_t, jnp.float32),
            jnp.asarray(wvec), jnp.asarray(phase), jnp.asarray(amp),
            jnp.float32(focal), jnp.float32(sphere_radius * sphere_radius),
            height=height, width=width,
        )
    )
    color = (gray[..., None] * 255).astype(np.uint8).repeat(3, axis=-1)
    return cam_r, cam_t, gray, color
