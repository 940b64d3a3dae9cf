"""Pairwise relative-pose estimation over the match graph — batched.

Capability parity with the reference's estimate_pairwise
(/root/reference/examples/spherical_sfm_tools.cpp:309-431): for each image
pair with enough matches, lift the matched pixels through K⁻¹, run spherical
RANSAC (3-pt solver, MSAC with threshold (px·K⁻¹₀₀)², final least squares),
keep pairs whose inlier count exceeds the minimum, and store per-pair inlier
matches plus the decomposed relative rotation. Loop-closure count = surviving
non-adjacent pairs.

Device design: all pairs process as one vmapped `spherical_ransac` over padded
(P, Nmax) match tables (SURVEY.md §2.5 P2); chunking keeps peak memory
bounded. Host code only assembles the padded tables and filters results.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry.pose import Intrinsics, pixels_to_rays
from ..ransac.spherical import spherical_ransac, spherical_ransac_adaptive


@partial(jax.jit, static_argnames=(
    "adaptive", "num_hypotheses", "round_size", "max_rounds", "confidence",
    "inward"))
def _pairwise_chunk(keys, u, v, mask, sq_thresh, *, adaptive, num_hypotheses,
                    round_size, max_rounds, confidence, inward):
    """One jitted chunk of the pairwise RANSAC sweep. Module-level so every
    driver call hits the in-memory jit cache (a wrapper built inside
    estimate_pairwise would retrace per call)."""
    if adaptive:
        fn = lambda k, uu, vv, mm: spherical_ransac_adaptive(  # noqa: E731
            k, uu, vv, mm, sq_thresh=sq_thresh, round_size=round_size,
            max_rounds=max_rounds, confidence=confidence, inward=inward,
        )
    else:
        fn = lambda k, uu, vv, mm: spherical_ransac(  # noqa: E731
            k, uu, vv, mm, sq_thresh=sq_thresh,
            num_hypotheses=num_hypotheses, inward=inward,
        )
    return jax.vmap(fn)(keys, u, v, mask)


class PairwiseResult(NamedTuple):
    """Per-pair estimates, aligned with the input pair list."""

    r: np.ndarray             # (P, 3) relative rotation axis-angle
    E: np.ndarray             # (P, 3, 3)
    num_inliers: np.ndarray   # (P,)
    inlier_mask: np.ndarray   # (P, Nmax)
    keep: np.ndarray          # (P,) passed min-inlier test
    loop_closure_count: int


def pad_match_table(matches_per_pair, max_matches=None):
    """Host helper: list of (idx0, idx1) integer arrays -> padded tables.

    Returns (idx0 (P, Nmax), idx1 (P, Nmax), mask (P, Nmax)).
    """
    P = len(matches_per_pair)
    lens = [len(m[0]) for m in matches_per_pair]
    n = max(lens) if max_matches is None else max_matches
    n = max(n, 8)
    idx0 = np.zeros((P, n), np.int32)
    idx1 = np.zeros((P, n), np.int32)
    mask = np.zeros((P, n), bool)
    for p, (a, b) in enumerate(matches_per_pair):
        k = min(len(a), n)
        idx0[p, :k] = a[:k]
        idx1[p, :k] = b[:k]
        mask[p, :k] = True
    return idx0, idx1, mask


def estimate_pairwise(
    key: jax.Array,
    points: np.ndarray,        # (F, Kmax, 2) keypoint pixel coords per frame
    pair_i: np.ndarray,        # (P,) first frame index per pair
    pair_j: np.ndarray,        # (P,) second frame index per pair
    idx0: np.ndarray,          # (P, Nmax) matched keypoint index in frame i
    idx1: np.ndarray,          # (P, Nmax) matched keypoint index in frame j
    match_mask: np.ndarray,    # (P, Nmax)
    intrinsics: Intrinsics,
    inlier_threshold_px: float = 2.0,
    min_num_inliers: int = 100,
    inward: bool = False,
    num_hypotheses: int = 1024,
    chunk_size: int = 64,
    adaptive: bool = True,
    round_size: int = 128,
    confidence: float = 0.99,
    mesh=None,
) -> PairwiseResult:
    """Estimate spherical relative poses for every candidate pair.

    The squared MSAC threshold is (px_thresh·K⁻¹₀₀)² like the reference
    (spherical_sfm_tools.cpp:315). With `adaptive`, each chunk of pairs runs
    round_size-hypothesis rounds under the RansacLib termination bound
    (ransac.h:158-240) instead of the full static `num_hypotheses` budget.

    All chunks are dispatched before any result is fetched (the device queue
    stays full; one host sync at the end instead of one per chunk), and the
    pair axis is padded to a whole number of chunks so every chunk hits the
    same compiled shape.

    With `mesh`, each chunk's pair axis shards over the mesh's data axis
    (embarrassingly parallel — SURVEY.md §2.5 P2) and the per-launch chunk
    scales with the mesh so per-device work matches the single-chip tuning.
    """
    P, Nmax = idx0.shape
    if P == 0:
        z3 = np.zeros((0, 3))
        return PairwiseResult(
            r=z3, E=np.zeros((0, 3, 3)), num_inliers=np.zeros(0, np.int64),
            inlier_mask=np.zeros((0, Nmax), bool), keep=np.zeros(0, bool),
            loop_closure_count=0,
        )
    focal = float(np.asarray(intrinsics.focal))
    sq_thresh = (inlier_threshold_px / focal) ** 2

    # Host-side prep (numpy): each jnp op here would run eagerly on the
    # device, one dispatch per op.
    pts = np.asarray(points, np.float32)
    uv0 = pts[pair_i[:, None], idx0]  # (P, Nmax, 2)
    uv1 = pts[pair_j[:, None], idx1]
    cx = float(np.asarray(intrinsics.cx))
    cy = float(np.asarray(intrinsics.cy))

    def rays(uv):
        x = (uv[..., 0] - cx) / focal
        y = (uv[..., 1] - cy) / focal
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    u = rays(uv0)
    v = rays(uv1)
    mask = match_mask

    max_rounds = max(1, -(-num_hypotheses // round_size))

    if mesh is not None:
        nd = mesh.shape[mesh.axis_names[0]]
        chunk_size = -(-chunk_size // nd) * nd * max(1, nd // 8)

    # pad the pair axis so every chunk compiles to one shape (host numpy —
    # device slicing per chunk would be eager dispatches)
    n_chunks = -(-P // chunk_size)
    Ppad = n_chunks * chunk_size

    def pad(x, fill=0):
        if x.shape[0] == Ppad:
            return x
        widths = [(0, Ppad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths, constant_values=fill)

    keys = np.asarray(jax.random.split(key, P))
    keys = pad(keys)
    u_p, v_p, mask_p = pad(u), pad(v), pad(mask, fill=False)

    chunks = []
    for s in range(0, Ppad, chunk_size):
        e = s + chunk_size
        args = (keys[s:e], u_p[s:e], v_p[s:e], mask_p[s:e])
        if mesh is not None:
            from ..parallel.sharded import put_sharded

            args = put_sharded(mesh, *args)
        else:
            args = tuple(jnp.asarray(a) for a in args)
        chunks.append(_pairwise_chunk(
            *args, jnp.asarray(sq_thresh),
            adaptive=adaptive, num_hypotheses=num_hypotheses,
            round_size=round_size, max_rounds=max_rounds,
            confidence=confidence, inward=inward))
    # device-side concat per output, then a single host sync for the sweep
    r = np.asarray(jnp.concatenate([c.r for c in chunks]))[:P]
    E = np.asarray(jnp.concatenate([c.E for c in chunks]))[:P]
    num_inliers = np.asarray(
        jnp.concatenate([c.num_inliers for c in chunks]))[:P]
    inlier_mask = np.asarray(
        jnp.concatenate([c.inlier_mask for c in chunks]))[:P]

    enough_matches = match_mask.sum(axis=1) >= min_num_inliers
    keep = (num_inliers > min_num_inliers) & enough_matches
    loops = int(np.sum(keep & (pair_i + 1 != pair_j)))
    return PairwiseResult(
        r=r, E=E, num_inliers=num_inliers, inlier_mask=inlier_mask,
        keep=keep, loop_closure_count=loops,
    )


def all_pairs(num_frames: int):
    """All ordered pairs (i < j), like the reference's exhaustive sweep."""
    pi, pj = np.triu_indices(num_frames, k=1)
    return pi.astype(np.int32), pj.astype(np.int32)


def estimate_pairwise_five_point(
    key: jax.Array,
    points: np.ndarray,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    idx0: np.ndarray,
    idx1: np.ndarray,
    match_mask: np.ndarray,
    intrinsics: Intrinsics,
    inlier_threshold_px: float = 2.0,
    min_num_inliers: int = 100,
    num_hypotheses: int = 256,
    chunk_size: int = 16,
) -> PairwiseResult:
    """General (5-pt) pairwise relative pose — the reference's
    estimate_pairwise_five_point (spherical_sfm_tools.cpp:433-573): Stewenius
    RANSAC + cheirality decomposition instead of the spherical solver. Used
    by the uncalibrated pipeline's five-point mode. CPU-backend path (the
    5-pt solver needs a general eigendecomposition)."""
    from ..ransac.general_essential import general_essential_ransac

    P, Nmax = idx0.shape
    focal = float(np.asarray(intrinsics.focal))
    sq_thresh = (inlier_threshold_px / focal) ** 2

    pts = jnp.asarray(points)
    uv0 = pts[pair_i[:, None], idx0]
    uv1 = pts[pair_j[:, None], idx1]
    u = pixels_to_rays(uv0, intrinsics)
    v = pixels_to_rays(uv1, intrinsics)
    mask = jnp.asarray(match_mask)

    run = jax.vmap(
        lambda k, uu, vv, mm: general_essential_ransac(
            k, uu, vv, mm, sq_thresh=jnp.asarray(sq_thresh),
            num_hypotheses=num_hypotheses,
        )
    )
    keys = jax.random.split(key, P)
    rs, Es, ninl, inl = [], [], [], []
    for s in range(0, P, chunk_size):
        e = min(s + chunk_size, P)
        res = run(keys[s:e], u[s:e], v[s:e], mask[s:e])
        rs.append(np.asarray(res.r))
        Es.append(np.asarray(res.E))
        ninl.append(np.asarray(res.num_inliers))
        inl.append(np.asarray(res.inlier_mask))
    r = np.concatenate(rs)
    E = np.concatenate(Es)
    num_inliers = np.concatenate(ninl)
    inlier_mask = np.concatenate(inl)
    enough = match_mask.sum(axis=1) >= min_num_inliers
    keep = (num_inliers > min_num_inliers) & enough
    loops = int(np.sum(keep & (pair_i + 1 != pair_j)))
    return PairwiseResult(r=r, E=E, num_inliers=num_inliers,
                          inlier_mask=inlier_mask, keep=keep,
                          loop_closure_count=loops)
