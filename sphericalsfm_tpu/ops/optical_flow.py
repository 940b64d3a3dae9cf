"""Dense optical flow on the device: pyramidal warped Horn–Schunck.

Capability parity with the reference stitcher's CUDA Brox flow
(/root/reference/examples/stereo_panorama_tools.cpp:28, 34-57 —
cv::cuda::BroxOpticalFlow, the repo's single GPU touchpoint). The JAX
replacement is a coarse-to-fine variational solver (SURVEY.md §2.5 P7):
Gaussian pyramid, per level warp the second image by the upsampled flow
(bilinear gather), linearize (Ix, Iy, It), and relax the Horn–Schunck
equations with fixed Jacobi iterations (neighborhood averaging as a conv) —
all jittable fixed-shape ops, batched over image pairs with vmap.

Not a numerical clone of Brox (different regularizer: quadratic vs TV), but
serving the same role: sub-pixel dense correspondence for the flow-corrected
panorama column synthesis, where the plane-induced homography already
provides a strong initialization and the flow only models the residual
parallax.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _avg_kernel(img: jnp.ndarray) -> jnp.ndarray:
    """Horn–Schunck neighborhood average (the classic weighted 8-neighbor)."""
    k = jnp.asarray(
        [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]],
        img.dtype,
    )
    return jax.lax.conv_general_dilated(
        img[None, None], k[None, None], (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]


def _blur_down(img: jnp.ndarray) -> jnp.ndarray:
    k1 = jnp.asarray([0.25, 0.5, 0.25], img.dtype)
    x = jax.lax.conv_general_dilated(
        img[None, None], k1[None, None, :, None], (1, 1), [(1, 1), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    x = jax.lax.conv_general_dilated(
        x, k1[None, None, None, :], (1, 1), [(0, 0), (1, 1)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    return x[::2, ::2]


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def _gradients(img):
    gx = 0.5 * (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1))
    gy = 0.5 * (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0))
    return gx, gy


def _hs_level(I0, I1, u, v, alpha, iters):
    """Warped Horn–Schunck relaxation at one pyramid level."""
    H, W = I0.shape
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=I0.dtype), jnp.arange(W, dtype=I0.dtype),
        indexing="ij",
    )
    I1w = _bilinear(I1, xs + u, ys + v)
    g1x, g1y = _gradients(I1)
    Ix = _bilinear(g1x, xs + u, ys + v)
    Iy = _bilinear(g1y, xs + u, ys + v)
    It = I1w - I0

    def body(_, uv):
        uu, vv = uv
        ubar = _avg_kernel(uu)
        vbar = _avg_kernel(vv)
        # Jacobi update of the HS equations around the warp point: the
        # residual du = u − u0 satisfies the linearized brightness constancy
        # Ix(ubar−u0+du…) — with warping, It already includes Ix·u0 terms.
        num = Ix * (ubar - u) + Iy * (vbar - v) + It
        den = alpha * alpha + Ix * Ix + Iy * Iy
        uu_new = ubar - Ix * num / den
        vv_new = vbar - Iy * num / den
        return uu_new, vv_new

    u2, v2 = jax.lax.fori_loop(0, iters, body, (u, v))
    return u2, v2


@partial(jax.jit, static_argnames=("num_levels", "iters_per_level"))
def horn_schunck_flow(
    I0: jnp.ndarray,
    I1: jnp.ndarray,
    num_levels: int = 4,
    iters_per_level: int = 60,
    alpha: float = 0.02,
):
    """Dense flow I0 → I1 for (H, W) images in [0, 1].

    Returns (u, v) in pixels. vmap over a pair axis for batches.
    """
    pyr0 = [I0]
    pyr1 = [I1]
    for _ in range(num_levels - 1):
        pyr0.append(_blur_down(pyr0[-1]))
        pyr1.append(_blur_down(pyr1[-1]))

    h, w = pyr0[-1].shape
    u = jnp.zeros((h, w), I0.dtype)
    v = jnp.zeros((h, w), I0.dtype)
    for lvl in range(num_levels - 1, -1, -1):
        if lvl != num_levels - 1:
            H, W = pyr0[lvl].shape
            u = 2.0 * jax.image.resize(u, (H, W), "linear")
            v = 2.0 * jax.image.resize(v, (H, W), "linear")
        u, v = _hs_level(pyr0[lvl], pyr1[lvl], u, v, alpha, iters_per_level)
    return u, v
