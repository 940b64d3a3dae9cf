"""Image frontend: frame loading, feature detection, exhaustive matching.

Capability parity with the reference's detect_features / match /
match_exhaustive / make_loop_closures
(/root/reference/examples/spherical_sfm_tools.cpp:176-307, 575-734): read
every frame of a video or printf-style image pattern, detect capped keypoint
sets with per-keypoint color samples, match all O(N²) ordered pairs with
ratio-test knn, and search begin/end frame windows for loop closures.

The reference parallelizes with OpenMP; here detection is a vmapped device
kernel over batched frames, matching is chunked batched matrix products (a
streaming Pallas kernel on the GPU), and frame decode stays on the host
(cv2, imported lazily by `load_frames` only — the detector also accepts
pre-loaded arrays).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from functools import partial

from jax.sharding import PartitionSpec as P

from ..config import FrontendConfig
from ..ops.features import detect_batch
from ..ops.matching import match_pairs_compact_batched


@partial(jax.jit, static_argnames=("max_matches", "ratio"))
def _match_chunk(desc, valid, a, b, *, max_matches, ratio):
    """One jitted matching chunk; the pair gathers live inside the jit.
    Module-level so repeated calls hit the in-memory jit cache."""
    return match_pairs_compact_batched(
        desc[a], desc[b], valid[a], valid[b], max_matches, ratio=ratio
    )


@partial(jax.jit, static_argnames=("mesh", "max_matches", "ratio"))
def _match_chunk_sharded(mesh, desc, valid, a, b, *, max_matches, ratio):
    """`_match_chunk` with the pair axis split over the mesh's data axis.

    shard_map, not GSPMD: the partitioner cannot split the kernel's custom
    call, so each device runs the matcher on its own slice of pairs against
    the replicated descriptor table. check_vma=False: pallas_call does not
    infer how its outputs vary across the mesh axes."""
    axis = mesh.axis_names[0]

    def body(d, v, aa, bb):
        return match_pairs_compact_batched(
            d[aa], d[bb], v[aa], v[bb], max_matches, ratio=ratio
        )

    return jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False,
    )(desc, valid, a, b)


class FrameFeatures(NamedTuple):
    """Fixed-shape per-capture feature tables."""

    xy: np.ndarray           # (F, K, 2)
    descriptor: np.ndarray   # (F, K, 128) float32
    valid: np.ndarray        # (F, K)
    color: np.ndarray        # (F, K, 3) uint8 (BGR like the reference)
    counts: np.ndarray       # (F,) valid keypoints per frame
    width: int
    height: int
    # Device-resident copies populated by detect_features so the matcher
    # skips re-uploading descriptors from the host.
    # None when features came from a cache/database (host only).
    descriptor_dev: object = None   # (F, K, 128) f32 on device
    valid_dev: object = None        # (F, K) bool on device


def load_frames(path: str, stride: int = 1, max_frames: int | None = None):
    """Read frames from a video file or printf-style image pattern via
    cv2.VideoCapture (the reference uses the same API for both —
    spherical_sfm_tools.cpp:273-297). Returns (gray (F,H,W) float32 in [0,1],
    color (F,H,W,3) uint8)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"could not read video/pattern: {path}")
    grays, colors = [], []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            colors.append(frame)
            grays.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        i += 1
        if max_frames is not None and len(grays) >= max_frames:
            break
    cap.release()
    if not grays:
        raise IOError(f"no frames decoded from {path}")
    gray = np.stack(grays).astype(np.float32) / 255.0
    return gray, np.stack(colors)


def detect_features(
    gray: np.ndarray,                   # (F, H, W) float32 [0, 1]
    color: np.ndarray | None = None,    # (F, H, W, 3) uint8
    cfg: FrontendConfig = FrontendConfig(),
    batch: int | None = None,
    mesh=None,
) -> FrameFeatures:
    """Detect features on every frame (batched device kernel, or OpenCV SIFT
    when cfg.detector == 'opencv' for cross-checks). With `mesh`, the frame
    axis of every launch shards over the mesh's data axis (shard_map, zero
    collectives — SURVEY.md §2.5 P1)."""
    if batch is None:
        batch = cfg.detect_batch
    if mesh is not None:
        nd = mesh.shape[mesh.axis_names[0]]
        batch = -(-batch // nd) * nd  # whole number of frames per device
    F, H, W = gray.shape
    K = cfg.max_keypoints
    if cfg.detector == "opencv":
        return _detect_opencv(gray, color, cfg)

    # Dispatch every chunk before fetching any result: uploads, kernels and
    # downloads overlap instead of serializing on per-chunk blocking
    # readbacks.
    # Frames ship as uint8 (1 byte/pixel — the reference detects on 8-bit
    # cv2 grayscale too) and descriptors come back SIFT-quantized uint8
    # (×512, the OpenCV/COLMAP convention), cutting link traffic ~4×; the
    # full-precision descriptors stay on device for the matcher.
    if gray.dtype != np.uint8:
        gray = np.clip(gray * 255.0 + 0.5, 0, 255).astype(np.uint8)
    pending = []
    for s in range(0, F, batch):
        e = min(s + batch, F)
        imgs = gray[s:e]
        if e - s < batch:  # pad the tail: one compiled shape for all chunks
            imgs = np.concatenate(
                [imgs, np.zeros((batch - (e - s), H, W), imgs.dtype)])
        if mesh is not None:
            from ..parallel.sharded import put_sharded, sharded_detect

            feats = sharded_detect(mesh, put_sharded(mesh, imgs), K,
                                   cfg.num_octaves)
        else:
            feats = detect_batch(jnp.asarray(imgs), max_keypoints=K,
                                 num_octaves=cfg.num_octaves)
        pending.append((feats, _quantize_desc(feats.descriptor), e - s))
    # One device-side concat per output, then one fetch each, instead of
    # three blocking fetches per chunk.
    xy_dev = jnp.concatenate([p.xy[:n] for p, _, n in pending])
    quant_dev = jnp.concatenate([q[:n] for _, q, n in pending])
    valid_dev = jnp.concatenate([p.valid[:n] for p, _, n in pending])
    desc_dev = jnp.concatenate([p.descriptor[:n] for p, _, n in pending])
    xy = np.asarray(xy_dev)
    desc = np.asarray(quant_dev).astype(np.float32) / 512.0
    valid = np.asarray(valid_dev)
    col = _sample_colors(xy, valid, color, H, W)
    return FrameFeatures(
        xy=xy, descriptor=desc, valid=valid, color=col,
        counts=valid.sum(axis=1).astype(np.int64), width=W, height=H,
        descriptor_dev=desc_dev, valid_dev=valid_dev,
    )


@jax.jit
def _quantize_desc(d):
    return jnp.clip(jnp.round(d * 512.0), 0, 255).astype(jnp.uint8)


def _sample_colors(xy, valid, color, H, W):
    F, K = valid.shape
    if color is None:
        return np.zeros((F, K, 3), np.uint8)
    xi = np.clip(xy[..., 0].astype(np.int64), 0, W - 1)
    yi = np.clip(xy[..., 1].astype(np.int64), 0, H - 1)
    return color[np.arange(F)[:, None], yi, xi]


def _detect_opencv(gray, color, cfg: FrontendConfig) -> FrameFeatures:
    """Host OpenCV SIFT backend (the reference's detector: SIFT::create with
    a large candidate budget capped to max_keypoints), for parity checks."""
    import cv2

    F, H, W = gray.shape
    K = cfg.max_keypoints
    sift = cv2.SIFT_create(20000)
    xy = np.zeros((F, K, 2), np.float64)
    desc = np.zeros((F, K, 128), np.float32)
    valid = np.zeros((F, K), bool)
    for f in range(F):
        img8 = (gray[f] * 255).astype(np.uint8)
        kps, d = sift.detectAndCompute(img8, None)
        if not kps:
            continue
        order = np.argsort([-k.response for k in kps])[:K]
        for out_i, i in enumerate(order):
            xy[f, out_i] = kps[i].pt
            desc[f, out_i] = d[i]
            valid[f, out_i] = True
        # L2-normalize for the dot-product matcher
        n = np.linalg.norm(desc[f], axis=-1, keepdims=True)
        desc[f] = np.where(n > 0, desc[f] / np.maximum(n, 1e-9), 0)
    col = _sample_colors(xy, valid, color, H, W)
    return FrameFeatures(xy=xy, descriptor=desc, valid=valid, color=col,
                         counts=valid.sum(axis=1).astype(np.int64),
                         width=W, height=H)


def match_pairs(
    feats: FrameFeatures,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    cfg: FrontendConfig = FrontendConfig(),
    chunk: int = 32,
    mesh=None,
):
    """Ratio-test matching of the given frame pairs (chunked vmap).

    Returns padded index tables (idx0, idx1, mask) of shape
    (P, cfg.max_matches_per_pair). With `mesh`, each chunk's pair axis
    shards over the data axis (descriptors replicated — the gathers stay
    local; SURVEY.md §2.5 P2's matching half).
    """
    if feats.descriptor_dev is not None:  # device copy: skip the re-upload
        desc = feats.descriptor_dev
        valid = feats.valid_dev
    else:
        desc = jnp.asarray(feats.descriptor)
        valid = jnp.asarray(feats.valid)
    M = cfg.max_matches_per_pair
    if mesh is not None:
        from ..parallel.sharded import put_sharded, replicated

        nd = mesh.shape[mesh.axis_names[0]]
        chunk = -(-chunk // nd) * nd * max(1, nd // 8)  # scale work per launch
        desc = jax.device_put(desc, replicated(mesh))
        valid = jax.device_put(valid, replicated(mesh))

    P = len(pair_i)
    pending = []
    for s in range(0, P, chunk):  # dispatch all chunks, fetch afterwards
        e = min(s + chunk, P)
        a = pair_i[s:e]
        b = pair_j[s:e]
        if e - s < chunk:  # pad the tail: one compiled shape for all chunks
            a = np.concatenate([a, np.zeros(chunk - (e - s), a.dtype)])
            b = np.concatenate([b, np.zeros(chunk - (e - s), b.dtype)])
        kw = dict(max_matches=M, ratio=cfg.match_ratio)
        if mesh is not None:
            a, b = put_sharded(mesh, a, b)
            out = _match_chunk_sharded(mesh, desc, valid, a, b, **kw)
        else:
            out = _match_chunk(desc, valid, jnp.asarray(a), jnp.asarray(b),
                               **kw)
        pending.append((out, e - s))
    # device-side concat, one fetch per output (not 3 per chunk)
    i0 = jnp.concatenate([p[0][:n] for p, n in pending])
    i1 = jnp.concatenate([p[1][:n] for p, n in pending])
    mk = jnp.concatenate([p[2][:n] for p, n in pending])
    return np.asarray(i0), np.asarray(i1), np.asarray(mk)


def window_pairs(num_frames: int, adjacent_window: int,
                 num_begin: int = 0, num_end: int = 0):
    """O(F) candidate pairs: the adjacent band (j − i ≤ window) plus the
    begin/end loop-closure windows — the matching the reference's
    numbegin/numend flags were built for, replacing the O(F²) exhaustive
    sweep on long videos."""
    pi, pj = [], []
    for i in range(num_frames):
        for j in range(i + 1, min(i + 1 + adjacent_window, num_frames)):
            pi.append(i)
            pj.append(j)
    li, lj = loop_closure_pairs(num_frames, num_begin, num_end)
    seen = set(zip(pi, pj))
    for i, j in zip(li.tolist(), lj.tolist()):
        if (i, j) not in seen:
            pi.append(i)
            pj.append(j)
    order = np.lexsort((pj, pi))
    return (np.asarray(pi, np.int32)[order], np.asarray(pj, np.int32)[order])


def loop_closure_pairs(num_frames: int, num_begin: int, num_end: int):
    """Begin-window x end-window candidate pairs, skipping adjacent frames
    (reference make_loop_closures pair enumeration,
    spherical_sfm_tools.cpp:602-650)."""
    pi, pj = [], []
    for i in range(min(num_begin, num_frames)):
        for j in range(max(0, num_frames - num_end), num_frames):
            if j <= i + 1:
                continue
            pi.append(i)
            pj.append(j)
    return np.asarray(pi, np.int32), np.asarray(pj, np.int32)


def make_loop_closures(
    key,
    feats: FrameFeatures,
    intrinsics,
    num_begin: int = 30,
    num_end: int = 30,
    inlier_threshold_px: float = 2.0,
    min_num_inliers: int = 100,
    inward: bool = False,
    best_only: bool = False,
    cfg: FrontendConfig = FrontendConfig(),
):
    """Search begin/end frame windows for loop closures (reference
    make_loop_closures, spherical_sfm_tools.cpp:602-734): match the candidate
    pairs, run spherical RANSAC, keep every pair above the inlier minimum or
    only the single best (`best_only`).

    Returns (pair_i, pair_j, r, E, inlier_mask, idx0, idx1, mmask) for the
    kept pairs.
    """
    from .pairwise import estimate_pairwise

    F = feats.valid.shape[0]
    pi, pj = loop_closure_pairs(F, num_begin, num_end)
    if len(pi) == 0:
        z = np.zeros(0, np.int32)
        return z, z, np.zeros((0, 3)), np.zeros((0, 3, 3)), \
            np.zeros((0, 0), bool), z.reshape(0, 0), z.reshape(0, 0), \
            np.zeros((0, 0), bool)
    idx0, idx1, mmask = match_pairs(feats, pi, pj, cfg)
    pw = estimate_pairwise(
        key, feats.xy, pi, pj, idx0, idx1, mmask, intrinsics,
        inlier_threshold_px=inlier_threshold_px,
        min_num_inliers=min_num_inliers, inward=inward,
    )
    keep = pw.keep
    if best_only and keep.any():
        best = np.argmax(np.where(keep, pw.num_inliers, -1))
        keep = np.zeros_like(keep)
        keep[best] = True
    sel = np.nonzero(keep)[0]
    return (
        pi[sel], pj[sel], pw.r[sel], pw.E[sel], pw.inlier_mask[sel],
        idx0[sel], idx1[sel], mmask[sel],
    )
