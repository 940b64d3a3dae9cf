"""Device DoG/SIFT-style feature detection and description.

Capability parity with the reference's DetectorTracker (cv::SIFT with 20000
candidate cap + adaptive non-maximal suppression to 4000 keypoints,
/root/reference/examples/spherical_sfm_tools.cpp:56-233). The reference runs
OpenCV SIFT per frame under OpenMP; here the whole detector is a fixed-shape
jittable JAX program — Gaussian pyramids as separable depthwise convolutions
(dense matmuls), 3×3×3 DoG extrema as elementwise comparisons, grid-bucketed
non-maximal suppression, orientation histograms and 4×4×8 SIFT descriptors
from rotated bilinear patch gathers — so a *batch of frames* is one XLA
program (the batched equivalent of SURVEY.md §2.5 P1).

Exact OpenCV-SIFT output parity is not a goal (different implementations of
SIFT disagree keypoint-by-keypoint anyway); repeatability and matchability
against itself is what the pipeline needs, and the e2e tests assert that.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# SIFT-standard constants
_NUM_SCALES = 3              # intervals per octave
_SIGMA0 = 1.6
_CONTRAST_THRESH = 0.015
_EDGE_RATIO = 10.0
_DESC_PATCH = 16             # descriptor support (pixels at detection scale)
_ORI_BINS = 36


class Features(NamedTuple):
    xy: jnp.ndarray          # (K, 2) pixel coordinates (x, y)
    scale: jnp.ndarray       # (K,) sigma in original-image pixels
    angle: jnp.ndarray       # (K,) orientation (radians)
    response: jnp.ndarray    # (K,)
    descriptor: jnp.ndarray  # (K, 128) L2-normalized
    valid: jnp.ndarray       # (K,) bool


def _gauss_kernel1d(sigma: float, radius: int, dtype) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _blur_toeplitz(n: int, sigma: float):
    """Banded Toeplitz blur matrix (n, n), numpy f32: out = M @ x along one
    axis, zero-padded at the edges (identical math to the zero-padded conv
    it replaces). Dense on purpose: on the chip this was first built for, a
    (H, H) @ (H, W) matmul beat 40 sequential 1-channel convolutions by
    about 10×. Whether it still wins on the GPU waits for re-measurement
    (ROADMAP 1.4, 3.6)."""
    import numpy as np

    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    M = np.zeros((n, n), np.float32)
    for i, kv in enumerate(k):
        off = i - radius
        idx = np.arange(max(0, -off), min(n, n - off))
        M[idx, idx + off] = kv
    return M


def _blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur of (H, W) as two banded-matrix matmuls.

    HIGHEST precision: blur outputs feed DoG differences whose magnitudes
    sit near the 0.015 contrast threshold; default bf16 rounding of
    ~1.0-magnitude inputs would put ~1e-3 absolute noise on values read at
    the 1e-2 scale. The FLOPs are tiny (~5 GFLOP/frame) — even the 6-pass
    f32 emulation is sub-millisecond."""
    H, W = img.shape
    Mh = jnp.asarray(_blur_toeplitz(H, sigma))
    Mw = jnp.asarray(_blur_toeplitz(W, sigma))
    hi = jax.lax.Precision.HIGHEST
    return jnp.einsum("hk,kw,wx->hx", Mh, img, Mw, precision=hi)


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    return img[::2, ::2]


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of (H, W) at float coords; out-of-bounds clamp."""
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _bilinear_layer(stack: jnp.ndarray, layer, x, y) -> jnp.ndarray:
    """Bilinear sample of layer `layer` of a (S, H, W) stack.

    The traced layer index folds into the row coordinate of the flattened
    (S·H, W) image — a per-sample gather. Indexing `stack[layer]` directly
    under vmap would materialize one full image per keypoint (a
    keypoints × S × H × W broadcast that OOMs real frame sizes).
    """
    S, H, W = stack.shape
    flat = stack.reshape(S * H, W)
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    row = layer * H + y0
    v00 = flat[row, x0]
    v01 = flat[row, x0 + 1]
    v10 = flat[row + 1, x0]
    v11 = flat[row + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _dog_extrema(dogs: jnp.ndarray, contrast_thresh: float):
    """3×3×3 extrema of a DoG stack (S, H, W) -> response map (S−2, H, W).

    Returns |DoG| where the center is a strict local max/min above threshold
    and passes the edge test, else 0.
    """
    S, H, W = dogs.shape
    center = dogs[1:-1]

    # Separable 3×3(×3) neighborhood extrema instead of materializing the
    # 26-shifted-copy stack (26·S·H·W floats + 52 rolls of HBM traffic —
    # pure bandwidth waste; this form is ~12 rolls and no big stack).
    def _row3(a, op):
        return op(a, op(jnp.roll(a, 1, -1), jnp.roll(a, -1, -1)))

    def _pool9(a, op):          # full 3×3 neighborhood including center
        r = _row3(a, op)
        return op(r, op(jnp.roll(r, 1, -2), jnp.roll(r, -1, -2)))

    def _pool8(a, op):          # 3×3 ring excluding the center
        r3 = _row3(a, op)       # row max incl. center
        lr = op(jnp.roll(a, 1, -1), jnp.roll(a, -1, -1))  # left/right only
        return op(lr, op(jnp.roll(r3, 1, -2), jnp.roll(r3, -1, -2)))

    below = dogs[0 : S - 2]
    above = dogs[2:S]
    nb_max = jnp.maximum(
        jnp.maximum(_pool9(below, jnp.maximum), _pool9(above, jnp.maximum)),
        _pool8(center, jnp.maximum),
    )
    nb_min = jnp.minimum(
        jnp.minimum(_pool9(below, jnp.minimum), _pool9(above, jnp.minimum)),
        _pool8(center, jnp.minimum),
    )
    is_max = center > nb_max
    is_min = center < nb_min
    strong = jnp.abs(center) > contrast_thresh

    # Edge rejection via the 2×2 spatial Hessian trace²/det ratio.
    dxx = jnp.roll(center, -1, -1) + jnp.roll(center, 1, -1) - 2 * center
    dyy = jnp.roll(center, -1, -2) + jnp.roll(center, 1, -2) - 2 * center
    dxy = 0.25 * (
        jnp.roll(jnp.roll(center, -1, -2), -1, -1)
        + jnp.roll(jnp.roll(center, 1, -2), 1, -1)
        - jnp.roll(jnp.roll(center, -1, -2), 1, -1)
        - jnp.roll(jnp.roll(center, 1, -2), -1, -1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = _EDGE_RATIO
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    ok = (is_max | is_min) & strong & edge_ok
    # Kill the 1-pixel border (roll wraps around).
    ok = ok.at[:, :1, :].set(False).at[:, -1:, :].set(False)
    ok = ok.at[:, :, :1].set(False).at[:, :, -1:].set(False)
    return jnp.where(ok, jnp.abs(center), 0.0)


def _block_topk(resp: jnp.ndarray, block: int, keep: int):
    """Per-block top-`keep` prefilter of an octave response stack.

    resp is (S, h, w); the spatial plane is tiled into block×block cells and
    the `keep` strongest responses across all S layers of each cell survive.
    Returns (vals, layer, yy, xx) each of shape (n_blocks·keep,) in octave
    pixel coordinates. A full-image candidate list is ~1.2M entries at VGA
    and the global argsorts over it dominated the whole detector on the
    chip this was first built for; row-local top_k over (n_blocks, S·block²)
    is ~30× smaller
    output with identical downstream selection (extrema are sparse — cells
    with >keep candidates above threshold are rare and capped by the grid
    NMS's per-cell cap anyway).
    """
    S, h, w = resp.shape
    hb = -(-h // block)
    wb = -(-w // block)
    pad_h = hb * block - h
    pad_w = wb * block - w
    r = jnp.pad(resp, ((0, 0), (0, pad_h), (0, pad_w)))
    r = r.reshape(S, hb, block, wb, block)
    r = r.transpose(1, 3, 0, 2, 4).reshape(hb * wb, S * block * block)
    keep = min(keep, S * block * block)
    vals, idx = jax.lax.top_k(r, keep)  # (hb·wb, keep)
    lay = idx // (block * block)
    rem = idx % (block * block)
    by = rem // block
    bx = rem % block
    cell_y = (jnp.arange(hb * wb) // wb)[:, None]
    cell_x = (jnp.arange(hb * wb) % wb)[:, None]
    yy = (cell_y * block + by).astype(jnp.float32)
    xx = (cell_x * block + bx).astype(jnp.float32)
    return (vals.reshape(-1), lay.reshape(-1).astype(jnp.int32),
            yy.reshape(-1), xx.reshape(-1))


def _grid_nms(resp_flat, xy, cell: float, width: float, per_cell: int, k: int):
    """Greedy-free spatial suppression: keep the `per_cell` strongest
    keypoints per grid cell, then the global top-k.

    The reference's adaptiveNonMaximalSuppresion (spherical_sfm_tools.cpp:
    76-123) sorts by suppression radius; bucketed NMS is its fixed-shape
    analogue with the same intent (spatially even coverage cap).
    """
    ncols = int(math.ceil(width / cell)) + 1
    n = resp_flat.shape[0]
    cells = (
        jnp.floor(xy[:, 1] / cell).astype(jnp.int32) * ncols
        + jnp.floor(xy[:, 0] / cell).astype(jnp.int32)
    )
    # Sort by (cell, −response): sort by response first, then a *stable* sort
    # by cell id preserves the strongest-first order within each cell. The
    # rank within the cell is then position − first-position-of-cell, found
    # with a searchsorted on the sorted ids — O(N log N), no dense histogram,
    # no overflow-prone combined sort keys.
    resp_order = jnp.argsort(-resp_flat)
    order = resp_order[jnp.argsort(cells[resp_order], stable=True)]
    cells_sorted = cells[order]
    first_idx = jnp.searchsorted(cells_sorted, cells_sorted, side="left")
    rank_in_cell = jnp.arange(n) - first_idx
    keep_sorted = (rank_in_cell < per_cell) & (resp_flat[order] > 0)
    # Coverage-first selection, matching the intent of the reference's
    # radius-ANMS (suppression-radius order spreads keypoints before it
    # rewards strength): lexicographic (rank-in-cell ascending, response
    # descending) — every cell's strongest keypoint outranks any cell's
    # second before response breaks ties. Measured: at K=200 on a 320×240
    # texture this lifts coarse-cell coverage from 0.83× to ≥1.0× of the
    # radius-ANMS oracle (tests/test_features.py coverage-parity test).
    rmax = jnp.maximum(jnp.max(resp_flat), 1e-12)
    lex = (per_cell - rank_in_cell).astype(resp_flat.dtype) + resp_flat[order] / rmax
    scored = jnp.where(keep_sorted, lex, -1.0)
    vals, topk = jax.lax.top_k(scored, k)  # O(n log k), not a third full sort
    final = order[topk]
    return final, vals > 0


@partial(jax.jit, static_argnames=("max_keypoints", "num_octaves"))
def detect_and_describe(
    image: jnp.ndarray,
    max_keypoints: int = 1024,
    num_octaves: int = 4,
) -> Features:
    """Detect DoG keypoints and compute SIFT descriptors of one (H, W) image
    in [0, 1] (or uint8 in [0, 255] — converted on device, so callers can
    ship frames over the host↔device link at 1 byte/pixel). Returns
    fixed-shape Features (K = max_keypoints). vmap over a frame axis to
    process a whole capture at once.
    """
    img = image.astype(jnp.float32)
    if image.dtype == jnp.uint8:
        img = img / 255.0
    H, W = img.shape
    base = _blur(img, _SIGMA0)

    k_geom = 2.0 ** (1.0 / _NUM_SCALES)
    all_xy, all_resp, all_scale, all_oct, all_layer = [], [], [], [], []

    octave_images = []
    oct_img = base
    for o in range(num_octaves):
        # NOTE: collapsing this chain into one multi-channel direct-from-base
        # conv pair was tried on another chip and reverted: it ran faster
        # but multiplied the XLA compile time of the full kernel several
        # times over. Not re-measured on the GPU.
        sigmas = [(_SIGMA0 * (k_geom**s)) for s in range(_NUM_SCALES + 3)]
        gauss = [oct_img]
        for s in range(1, _NUM_SCALES + 3):
            inc = math.sqrt(max(sigmas[s] ** 2 - sigmas[s - 1] ** 2, 0.01))
            gauss.append(_blur(gauss[-1], inc))
        gstack = jnp.stack(gauss)  # (S+3, h, w)
        octave_images.append(gstack)
        dogs = gstack[1:] - gstack[:-1]  # (S+2, h, w)
        if o == 0:
            # Contrast-adaptive gate: a fixed 0.015 starves low-contrast
            # scenes (53 kp/frame on the lowtex eval sequences → the view
            # graph fragments into 10-frame islands). Scale the gate to the
            # image's own peak DoG response — textured images (max|DoG| ≥
            # 0.3) keep the classic 0.015 cut, smooth scenes degrade
            # gracefully instead of returning nothing. The 2.5e-4 floor
            # keeps quantization-noise extrema out on genuinely flat
            # captures (DoG of a blurred uint8 image sits well below 1e-4).
            # Traced scalar: no recompile across images. The max is taken on
            # an interior crop: the blur's zero-padding makes spurious
            # border DoG responses far above any interior content.
            hh, ww = dogs.shape[1], dogs.shape[2]
            m = max(4, min(16, hh // 8, ww // 8))
            thresh = jnp.clip(
                0.05 * jnp.max(jnp.abs(dogs[:, m:hh - m, m:ww - m])),
                2.5e-4, _CONTRAST_THRESH,
            )
        resp = _dog_extrema(dogs, thresh)  # (S, h, w)

        s_ = resp.shape[0]
        scale_of_layer = jnp.asarray(
            [_SIGMA0 * (k_geom ** (s + 1)) * (2.0**o) for s in range(s_)],
            jnp.float32,
        )
        # Prefilter: top-8 per 16-full-res-px cell (block halves per octave
        # so cells align across octaves) — shrinks the global NMS sorts from
        # the full pixel count to a few k candidates per octave.
        vals, lay, yy, xx = _block_topk(resp, block=max(16 >> o, 1), keep=8)
        # Second prefilter: per-octave top-2·K before the cross-octave NMS.
        # The grid NMS's two global argsorts were the detector's biggest
        # stage post-pyramid on the chip this was first built for (~38k
        # candidates at VGA); top_k to 2·K per octave shrinks them ~5x. 2x headroom covers the
        # corner case where the per-cell cap suppresses strong-but-crowded
        # candidates in favor of weaker isolated ones.
        cap = min(2 * max_keypoints, vals.shape[0])
        vals, sel_o = jax.lax.top_k(vals, cap)
        all_xy.append(jnp.stack(
            [xx[sel_o] * (2.0**o), yy[sel_o] * (2.0**o)], axis=-1))
        all_resp.append(vals)
        all_scale.append(scale_of_layer[lay[sel_o]])
        all_oct.append(jnp.full(vals.shape, o, jnp.int32))
        all_layer.append(lay[sel_o])
        oct_img = _downsample2(gstack[_NUM_SCALES])

    xy = jnp.concatenate(all_xy)
    resp = jnp.concatenate(all_resp)
    scale = jnp.concatenate(all_scale)
    octv = jnp.concatenate(all_oct)
    layer = jnp.concatenate(all_layer)

    # Starvation-conditional admission: sub-0.015 candidates (admitted by
    # the adaptive gate above) stay ONLY when the classic gate is genuinely
    # starved — under 128 candidates, the floor below which matching/RANSAC
    # cannot function. Merely-underfilled budgets keep the classic set: the
    # coverage-first NMS below ranks every cell's best before any cell's
    # second, so a permissive gate on an adequate scene floods the budget
    # with near-noise keypoints from weak cells (the inward object-centric
    # e2e regressed ATE 0.05 → 0.98 at 207 classic candidates when weak ones
    # were admitted up to the 512 budget). Traced scalar — no recompile.
    n_classic = jnp.sum(resp > _CONTRAST_THRESH)
    admit_weak = n_classic < min(max_keypoints, 128)
    resp = jnp.where(admit_weak | (resp > _CONTRAST_THRESH), resp, 0.0)

    # Cell size tracks the keypoint budget — √(W·H/K) is the mean spacing a
    # radius-ANMS at the same budget would enforce, so one-per-cell-first
    # selection (lexicographic rank in _grid_nms) reproduces its spatial
    # coverage (reference adaptiveNonMaximalSuppresion,
    # spherical_sfm_tools.cpp:76-123; parity test in tests/test_features.py).
    anms_cell = 0.75 * math.sqrt(H * W / max(max_keypoints, 1))
    sel, valid = _grid_nms(resp, xy, cell=max(8.0, W / 64.0, anms_cell),
                           width=float(W), per_cell=8, k=max_keypoints)
    xy = xy[sel]
    resp_k = resp[sel]
    scale_k = scale[sel]
    octv_k = octv[sel]
    layer_k = layer[sel]

    # --- subpixel refinement: quadratic fit of the spatial DoG surface -----
    # (Lowe's 3D fit restricted to x, y: offset = −H⁻¹g of the center DoG
    # layer, clamped to ±0.6 px.) All octave DoG stacks pack into one padded
    # canvas like the gradients below; derivatives come from 3×3 gathers.
    S2 = _NUM_SCALES + 2
    dog_pack = jnp.zeros((num_octaves * S2, H, W), jnp.float32)
    for o in range(num_octaves):
        dgs = octave_images[o][1:] - octave_images[o][:-1]
        h_o, w_o = dgs.shape[1], dgs.shape[2]
        dog_pack = dog_pack.at[o * S2 : o * S2 + S2, :h_o, :w_o].set(dgs)

    def refine_xy(i):
        o = jnp.clip(octv_k[i], 0, num_octaves - 1)
        lay_idx = o * S2 + layer_k[i] + 1
        inv = jnp.exp2(-o.astype(jnp.float32))
        xo = xy[i, 0] * inv
        yo = xy[i, 1] * inv

        def at(ddx, ddy):
            return _bilinear_layer(dog_pack, lay_idx, xo + ddx, yo + ddy)

        dx_ = 0.5 * (at(1.0, 0.0) - at(-1.0, 0.0))
        dy_ = 0.5 * (at(0.0, 1.0) - at(0.0, -1.0))
        dxx = at(1.0, 0.0) + at(-1.0, 0.0) - 2.0 * at(0.0, 0.0)
        dyy = at(0.0, 1.0) + at(0.0, -1.0) - 2.0 * at(0.0, 0.0)
        dxy = 0.25 * (at(1.0, 1.0) + at(-1.0, -1.0) - at(1.0, -1.0) - at(-1.0, 1.0))
        det = dxx * dyy - dxy * dxy
        det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
        off_x = -(dyy * dx_ - dxy * dy_) / det
        off_y = -(dxx * dy_ - dxy * dx_) / det
        ok = (jnp.abs(off_x) < 1.5) & (jnp.abs(off_y) < 1.5)
        off_x = jnp.where(ok, jnp.clip(off_x, -0.6, 0.6), 0.0)
        off_y = jnp.where(ok, jnp.clip(off_y, -0.6, 0.6), 0.0)
        return (xy[i, 0] + off_x / inv, xy[i, 1] + off_y / inv)

    rx, ry = jax.vmap(refine_xy)(jnp.arange(max_keypoints))
    xy = jnp.stack([rx, ry], axis=-1)

    # --- orientation + descriptor from the matching octave image -----------
    # All octave gradient stacks pack into ONE zero-padded array and the
    # octave folds into the gather's layer index. (A per-keypoint
    # `lax.switch` over octave branches is a trap: its vmap rule select_n's
    # each branch's captured stack per keypoint — a keypoints × S × H × W
    # broadcast that OOMs at real frame sizes.) An in-patch-gradient
    # variant (one Gaussian slice per keypoint, central differences inside
    # the patch) was tried and reverted: it was slightly faster but
    # measurably degraded the inward rendered-capture reconstruction (ATE 0.05 -> 0.17,
    # tests/test_driver.py::test_calibrated_driver_inward).
    S3 = _NUM_SCALES + 3
    gx_pack = jnp.zeros((num_octaves * S3, H, W), jnp.float32)
    gy_pack = jnp.zeros((num_octaves * S3, H, W), jnp.float32)
    for o in range(num_octaves):
        g = octave_images[o]  # (S+3, h, w)
        gx = 0.5 * (jnp.roll(g, -1, -1) - jnp.roll(g, 1, -1))
        gy = 0.5 * (jnp.roll(g, -1, -2) - jnp.roll(g, 1, -2))
        h_o, w_o = g.shape[1], g.shape[2]
        gx_pack = gx_pack.at[o * S3 : o * S3 + S3, :h_o, :w_o].set(gx)
        gy_pack = gy_pack.at[o * S3 : o * S3 + S3, :h_o, :w_o].set(gy)

    # Per-keypoint work is patch-local: ONE contiguous dynamic_slice per
    # keypoint (rows vectorize, unlike the per-sample bilinear gathers this
    # replaces — those were ~4.5M random scalar gathers per frame and
    # dominated the kernel), then orientation and descriptor are elementwise
    # math over the patch's integer pixels (the OpenCV-SIFT iteration
    # scheme: each pixel contributes at its own offset; no resampling).
    PATCH = 40  # covers the 5.33σ orientation window at the largest layer σ

    def keypoint_frame(i):
        """Orientation and descriptor of one keypoint (vmapped)."""
        o = jnp.clip(octv_k[i], 0, num_octaves - 1)
        lay = layer_k[i]
        layer_idx = o * S3 + lay + 1
        sig = scale_k[i]
        inv = jnp.exp2(-o.astype(jnp.float32))
        xo = xy[i, 0] * inv
        yo = xy[i, 1] * inv
        sig_o = sig * inv

        x0 = jnp.clip(jnp.floor(xo).astype(jnp.int32) - PATCH // 2 + 1,
                      0, W - PATCH)
        y0 = jnp.clip(jnp.floor(yo).astype(jnp.int32) - PATCH // 2 + 1,
                      0, H - PATCH)
        gxp = jax.lax.dynamic_slice(
            gx_pack, (layer_idx, y0, x0), (1, PATCH, PATCH))[0]
        gyp = jax.lax.dynamic_slice(
            gy_pack, (layer_idx, y0, x0), (1, PATCH, PATCH))[0]
        # pixel offsets relative to the (subpixel) keypoint center
        dx = (x0.astype(jnp.float32) + jnp.arange(PATCH, dtype=jnp.float32)
              )[None, :] - xo
        dy = (y0.astype(jnp.float32) + jnp.arange(PATCH, dtype=jnp.float32)
              )[:, None] - yo
        mag = jnp.hypot(gxp, gyp)
        ang = jnp.arctan2(gyp, gxp)
        d2 = dx * dx + dy * dy

        # Orientation: 36-bin histogram, Gaussian σ = 4·σ_o/1.5 px, radius
        # 8·σ_o/1.5 (the same window the sampled version integrated).
        r_ori = sig_o / 1.5
        wgt = jnp.exp(-d2 / (2.0 * (4.0 * r_ori) ** 2)) * (
            d2 <= (8.0 * r_ori) ** 2
        )
        bins = jnp.floor(
            (ang + jnp.pi) / (2 * jnp.pi) * _ORI_BINS
        ).astype(jnp.int32) % _ORI_BINS
        val = (mag * wgt).reshape(-1)
        bins = bins.reshape(-1)
        # one-hot matvec (batched matmul under vmap), not .at[].add: chosen
        # where vmapped scatters were slow, and 36 unrolled masked
        # reductions were both slower and bigger to compile (re-measure on
        # the GPU: ROADMAP 3.6)
        oh36 = (bins[:, None] == jnp.arange(_ORI_BINS)[None, :]).astype(
            jnp.float32)
        hist = val @ oh36
        hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
        theta = (
            (jnp.argmax(hist).astype(jnp.float32) + 0.5) / _ORI_BINS
        ) * 2 * jnp.pi - jnp.pi

        # Descriptor: rotate each pixel's offset into the keypoint frame,
        # bin into 4×4 spatial cells × 8 orientations (unit = 0.4·σ_o px,
        # support |u|,|v| ≤ 8 units like the 16×16 sampled grid it replaces).
        ct, st = jnp.cos(theta), jnp.sin(theta)
        unit = 0.4 * sig_o
        u = (ct * dx + st * dy) / unit
        v = (-st * dx + ct * dy) / unit
        inside = (jnp.abs(u) < 8.0) & (jnp.abs(v) < 8.0)
        wgt2 = jnp.exp(-(u * u + v * v) / (2.0 * 8.0**2)) * inside
        cell_x = jnp.clip(jnp.floor((u + 8.0) / 4.0), 0, 3).astype(jnp.int32)
        cell_y = jnp.clip(jnp.floor((v + 8.0) / 4.0), 0, 3).astype(jnp.int32)
        ang2 = ang - theta
        obin = jnp.floor(
            ((ang2 + 3 * jnp.pi) % (2 * jnp.pi)) / (2 * jnp.pi) * 8
        ).astype(jnp.int32) % 8
        comb = (cell_y * 4 + cell_x).reshape(-1) * 8 + obin.reshape(-1)
        val2 = (mag * wgt2).reshape(-1)
        # fused (cell, orientation-bin) one-hot: ONE (P, 128) matvec per
        # keypoint (a batched matmul under vmap) instead of the two-operand
        # separable contraction XLA split into two passes
        oh128 = (comb[:, None] == jnp.arange(128)[None, :]).astype(jnp.float32)
        desc = val2 @ oh128
        return theta, desc

    thetas, descs = jax.vmap(keypoint_frame)(jnp.arange(max_keypoints))

    # SIFT normalization: L2 → clip 0.2 → L2.
    def _norm(d):
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        d = jnp.minimum(d, 0.2)
        return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)

    descs = _norm(descs)
    return Features(
        xy=xy, scale=scale_k, angle=thetas, response=resp_k,
        descriptor=jnp.where(valid[:, None], descs, 0.0), valid=valid,
    )


@partial(jax.jit, static_argnames=("max_keypoints", "num_octaves"))
def detect_batch(images: jnp.ndarray, max_keypoints: int = 1024,
                 num_octaves: int = 4) -> Features:
    """vmapped detection over a frame axis (F, H, W) -> batched Features.

    Jitted as one program: an un-jitted vmap executes op-by-op, one device
    dispatch per op."""
    return jax.vmap(
        lambda im: detect_and_describe(im, max_keypoints, num_octaves)
    )(images)
