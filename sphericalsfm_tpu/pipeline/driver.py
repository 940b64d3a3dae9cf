"""End-to-end reconstruction drivers.

Capability parity with the reference's two main executables:
* run_spherical_sfm (calibrated; /root/reference/examples/
  run_spherical_sfm.cpp:29-124 — including the post-`exit(0)` intended path:
  refine rotations, spherical BA ×2 with retriangulation, unfix
  translations, general BA, normalize, write outputs)
* run_spherical_sfm_uncalib (uncalibrated; run_spherical_sfm_uncalib.cpp:
  32-229 — features from video or a COLMAP database, pairwise at a focal
  guess of (w+h)/2, largest connected component, 1024-trial random focal
  search + joint pose-graph optimization, spherical BA with free focal,
  optional general BA, staged COLMAP outputs).

Each stage logs structured metrics and can checkpoint its outputs to .npz so
a run resumes mid-pipeline (SURVEY.md §5.3-5.5 equivalents of the
reference's artifact-as-checkpoint behavior).
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..geometry.pose import Intrinsics
from ..geometry.so3 import so3_exp
from ..optim.pose_graph import (
    RotationGraph,
    find_best_focal_bracketed,
    find_best_focal_grid,
    find_best_focal_random,
    initialize_rotations_global,
    initialize_rotations_sequential,
    optimize_rotations,
    optimize_rotations_and_focal,
    rotations_at_focal,
)
from .frontend import FrameFeatures, detect_features, load_frames, match_pairs
from .pairwise import all_pairs, estimate_pairwise, estimate_pairwise_five_point
from .sfm import SfMMap
from .tracks import (
    build_feature_tracks,
    filter_triplet_cycles,
    largest_connected_component,
)


class StageLogger:
    """Structured per-stage metrics (SURVEY.md §5.1/§5.5): wall-clock and
    counters per stage, streamed as JSON lines and kept in memory."""

    def __init__(self, out_dir: str | None = None, verbose: bool = True):
        self.records = []
        self.verbose = verbose
        self.path = os.path.join(out_dir, "stages.jsonl") if out_dir else None
        self._t0 = None
        self._name = None

    def start(self, name: str):
        self._name = name
        self._t0 = time.perf_counter()

    def end(self, **metrics):
        rec = {
            "stage": self._name,
            "seconds": round(time.perf_counter() - self._t0, 3),
            **metrics,
        }
        self.records.append(rec)
        if self.verbose:
            print(json.dumps(rec), flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


class FrontendResult(NamedTuple):
    feats: FrameFeatures
    pair_i: np.ndarray
    pair_j: np.ndarray
    idx0: np.ndarray
    idx1: np.ndarray
    mmask: np.ndarray


def pipeline_mesh(cfg: PipelineConfig):
    """The device mesh the production drivers run on, from cfg.devices
    (SURVEY.md §2.5 P8 / §5.8: multi-chip is a config knob, not a separate
    entry point). None = single-device. Power-of-two sizes only: the
    pipeline's shape buckets (powers of two, multiples of 8) must divide
    evenly across shards."""
    n = int(getattr(cfg, "devices", 0) or 0)
    if n <= 1:
        return None
    if n & (n - 1) or n > 64:
        raise ValueError(
            f"cfg.devices must be a power of two ≤ 64, got {n}")
    from ..parallel.sharded import make_mesh

    return make_mesh(n)


def run_frontend(
    video: str | None,
    cfg: PipelineConfig,
    log: StageLogger,
    gray: np.ndarray | None = None,
    color: np.ndarray | None = None,
    cache_path: str | None = None,
    mesh=None,
) -> FrontendResult:
    """Frames → features → exhaustive matches.

    With `cache_path`, the result checkpoints to an .npz and later runs
    resume past detection+matching (the stage-checkpoint equivalent of the
    reference's write_feature_tracks/read_feature_tracks resume branch,
    run_spherical_sfm.cpp:45-67; SURVEY.md §5.4).
    """
    if cache_path and os.path.exists(cache_path):
        log.start("load_frontend_cache")
        z = np.load(cache_path)
        desc = z["descriptor"]
        if desc.dtype == np.uint8:  # SIFT-quantized storage (×512)
            desc = desc.astype(np.float32) / 512.0
        fr = FrontendResult(
            FrameFeatures(
                xy=z["xy"], descriptor=desc, valid=z["valid"],
                color=z["color"], counts=z["counts"],
                width=int(z["width"]), height=int(z["height"]),
            ),
            z["pair_i"], z["pair_j"], z["idx0"], z["idx1"], z["mmask"],
        )
        log.end(frames=fr.feats.valid.shape[0], cached=True)
        return fr

    log.start("load_frames")
    if gray is None:
        gray, color = load_frames(video, stride=cfg.frontend.frame_stride)
    log.end(frames=len(gray), height=gray.shape[1], width=gray.shape[2])

    log.start("detect_features")
    feats = detect_features(gray, color, cfg.frontend, mesh=mesh)
    log.end(keypoints=int(feats.counts.sum()),
            mean_per_frame=float(feats.counts.mean()),
            **({"devices": mesh.size} if mesh is not None else {}))

    log.start("match_pairs")
    if cfg.frontend.matching == "windows":
        # O(F) candidate set: adjacent band + begin/end loop windows (the
        # wiring of the reference's numbegin/numend flags; make_loop_closures
        # spherical_sfm_tools.cpp:602-734)
        from .frontend import window_pairs

        pair_i, pair_j = window_pairs(
            len(gray), cfg.frontend.adjacent_window,
            cfg.graph.num_frames_begin, cfg.graph.num_frames_end,
        )
    else:
        pair_i, pair_j = all_pairs(len(gray))
    idx0, idx1, mmask = match_pairs(feats, pair_i, pair_j, cfg.frontend,
                                    mesh=mesh)
    log.end(pairs=len(pair_i), matches=int(mmask.sum()),
            mode=cfg.frontend.matching)
    fr = FrontendResult(feats, pair_i, pair_j, idx0, idx1, mmask)
    if cache_path:
        log.start("save_frontend_cache")
        # Device-detector descriptors persist SIFT-quantized (uint8 ×512 —
        # exactly the form they came off the device in, so the round-trip
        # is lossless). The OpenCV backend returns L2-normalized floats
        # that are NOT 1/512 multiples (and can exceed 255/512), so it
        # stores float as-is. Either way the archive is UNcompressed: zlib
        # over the old 134 MB float descriptor block cost ~7 s of a
        # 256-frame run by itself.
        if cfg.frontend.detector == "opencv":
            desc_store = fr.feats.descriptor
        else:
            desc_store = np.clip(
                np.round(fr.feats.descriptor * 512.0), 0, 255
            ).astype(np.uint8)
        np.savez(
            cache_path,
            xy=fr.feats.xy,
            descriptor=desc_store,
            valid=fr.feats.valid, color=fr.feats.color,
            counts=fr.feats.counts, width=fr.feats.width,
            height=fr.feats.height, pair_i=fr.pair_i, pair_j=fr.pair_j,
            idx0=fr.idx0, idx1=fr.idx1, mmask=fr.mmask,
        )
        log.end(bytes=os.path.getsize(cache_path))
    return fr


def _graph_from_pairwise(fr: FrontendResult, pw, keep, min_rotation_deg,
                         best_only: bool = False):
    """Kept pairwise estimates → rotation graph edges; drops tiny rotations
    (the reference's -minrot gate). With `best_only`, keep only the single
    strongest loop-closure (non-adjacent) edge — the reference's -bestonly
    flag (make_loop_closures, spherical_sfm_tools.cpp:602-734)."""
    rot_mag = np.linalg.norm(pw.r, axis=-1)
    keep = keep & (rot_mag > np.deg2rad(min_rotation_deg))
    if best_only:
        loops = keep & (fr.pair_j != fr.pair_i + 1)
        if loops.any():
            best = np.argmax(np.where(loops, pw.num_inliers, -1))
            keep = keep & (~loops)
            keep[best] = True
    return keep



def _warm_lambda(stats: dict) -> float:
    """Warm-start damping for the next robust LM pass: the previous pass's
    final λ, clamped — a tiny converged λ would make the restart overshoot
    (rejection back-off costs ~8 iterations to recover 12 decades), and a
    huge one would crawl. Ceres keeps its radius across its inner restarts
    for the same reason (trust_region_minimizer.cc)."""
    lam = stats.get("lam", 1e-4)
    if not (lam == lam) or lam <= 0:  # NaN guard
        return 1e-4
    # floor at the cold default: a pass that converged with tiny λ says
    # nothing about the NEXT pass's basin (retriangulation moved the
    # points), and starting below 1e-4 measurably walked the inward driver
    # into a worse minimum; starting HIGHER (previous pass ended damped) is
    # where the iteration savings are
    return float(min(max(lam, 1e-4), 1e-1))

def run_calibrated(
    video: str | None,
    intrinsics: Intrinsics,
    output_dir: str,
    cfg: PipelineConfig | None = None,
    gray: np.ndarray | None = None,
    color: np.ndarray | None = None,
    frontend: FrontendResult | None = None,
) -> SfMMap:
    """The calibrated pipeline (D1), through the *intended* full path."""
    cfg = cfg or PipelineConfig()
    os.makedirs(output_dir, exist_ok=True)
    log = StageLogger(output_dir)
    key = jax.random.PRNGKey(0)
    mesh = pipeline_mesh(cfg)
    if cfg.profile_dir:
        jax.profiler.start_trace(cfg.profile_dir)

    fr = frontend or run_frontend(
        video, cfg, log, gray, color,
        cache_path=os.path.join(output_dir, "frontend.npz"),
        mesh=mesh,
    )
    F = fr.feats.valid.shape[0]

    log.start("estimate_pairwise")
    pw = estimate_pairwise(
        key, fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1, fr.mmask,
        intrinsics,
        inlier_threshold_px=cfg.ransac.inlier_threshold_px,
        min_num_inliers=cfg.ransac.min_num_inliers,
        inward=cfg.inward,
        num_hypotheses=cfg.ransac.num_hypotheses,
        chunk_size=cfg.ransac.pair_chunk,
        adaptive=cfg.ransac.adaptive,
        round_size=cfg.ransac.round_size,
        confidence=cfg.ransac.confidence,
        mesh=mesh,
    )
    keep = _graph_from_pairwise(fr, pw, pw.keep, cfg.graph.min_rotation_deg,
                                best_only=cfg.graph.best_only)
    log.end(kept_pairs=int(keep.sum()), loop_closures=pw.loop_closure_count)
    if pw.loop_closure_count == 0:
        print("warning: no loop closures found")

    log.start("rotation_init")
    keep = filter_triplet_cycles(fr.pair_i, fr.pair_j, pw.r, keep,
                                 cfg.graph.triplet_filter_deg)
    frames, remap = largest_connected_component(F, fr.pair_i, fr.pair_j, keep)
    g = RotationGraph(
        edge_i=jnp.asarray(fr.pair_i), edge_j=jnp.asarray(fr.pair_j),
        r_meas=jnp.asarray(pw.r), edge_w=jnp.asarray(keep.astype(float)),
    )
    # Rotation init dispatch (reference initialize_rotations,
    # spherical_sfm_tools.cpp:1133-1140): adjacent chain, or the global
    # spanning-tree path that survives a broken chain (-sequential=false).
    if cfg.graph.sequential:
        rot0 = initialize_rotations_sequential(F, g)
    else:
        rot0 = initialize_rotations_global(
            F, g, weights=np.where(keep, pw.num_inliers, 0)
        )
    rots, pg_cost = optimize_rotations(rot0, g)
    log.end(frames_in_component=len(frames), cost=float(pg_cost))

    log.start("build_sfm")
    tracks = build_feature_tracks(
        F, fr.feats.counts, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1,
        pw.inlier_mask & fr.mmask & keep[:, None],
    )
    m = SfMMap.build(
        intrinsics, np.asarray(rots), tracks, fr.feats.xy,
        colors=fr.feats.color, spherical=True, inward=cfg.inward,
    )
    m.retriangulate(jax.random.fold_in(key, 1), mesh=mesh)
    log.end(points=int(m.point_valid().sum()), tracks=tracks.num_points)

    log.start("spherical_ba")
    t0 = time.perf_counter()
    stats1 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        loss_scale=cfg.ba.loss_scale,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh)
    t1 = time.perf_counter()
    m.retriangulate(jax.random.fold_in(key, 2), mesh=mesh)
    t2 = time.perf_counter()
    stats2 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        loss_scale=cfg.ba.loss_scale,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh, init_lambda=_warm_lambda(stats1))
    log.end(**{f"ba1_{k}": v for k, v in stats1.items()},
            **{f"ba2_{k}": v for k, v in stats2.items()},
            ba1_s=round(t1 - t0, 2), retri_s=round(t2 - t1, 2),
            ba2_s=round(time.perf_counter() - t2, 2))
    m.write_camera_centers_obj(os.path.join(output_dir, "pre-loop-cameras.obj"))

    log.start("general_ba")
    m.translation_fixed[:] = False
    m.translation_fixed[0] = True
    stats3 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        loss_scale=cfg.ba.loss_scale,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh, init_lambda=_warm_lambda(stats2))
    m.normalize()
    if cfg.ba.filter_threshold_px > 0:  # opt-in (reference never calls it)
        m.filter_observations(cfg.ba.filter_threshold_px)
    m.retriangulate(jax.random.fold_in(key, 3), mesh=mesh)
    stats4 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        loss_scale=cfg.ba.loss_scale,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh, init_lambda=_warm_lambda(stats3))
    m.normalize()
    log.end(**{f"ba3_{k}": v for k, v in stats3.items()},
            **{f"ba4_{k}": v for k, v in stats4.items()})

    log.start("write_outputs")
    _write_outputs(m, output_dir, fr)
    _maybe_write_reproj_overlays(m, cfg, output_dir, video, gray)
    log.end()
    if cfg.profile_dir:
        jax.profiler.stop_trace()
    return m


def run_uncalibrated(
    video: str | None,
    output_dir: str,
    cfg: PipelineConfig | None = None,
    colmap_db: str | None = None,
    gray: np.ndarray | None = None,
    color: np.ndarray | None = None,
    frontend: FrontendResult | None = None,
    image_size: tuple | None = None,
) -> tuple:
    """The uncalibrated shared-focal pipeline (D2). Returns (SfMMap, focal)."""
    cfg = cfg or PipelineConfig()
    os.makedirs(output_dir, exist_ok=True)
    log = StageLogger(output_dir)
    key = jax.random.PRNGKey(0)
    mesh = pipeline_mesh(cfg)

    if colmap_db is not None:
        from ..io.colmap import read_database
        from .pairwise import pad_match_table

        log.start("read_colmap_db")
        db = read_database(colmap_db)
        W, H = db.width, db.height
        F = len(db.names)
        Kmax = max(len(k) for k in db.keypoints)
        xy = np.zeros((F, Kmax, 2))
        valid = np.zeros((F, Kmax), bool)
        desc = np.zeros((F, Kmax, 128), np.float32)
        for f in range(F):
            k = len(db.keypoints[f])
            xy[f, :k] = db.keypoints[f]
            valid[f, :k] = True
            if len(db.descriptors[f]):
                d = db.descriptors[f]
                n = np.linalg.norm(d, axis=-1, keepdims=True)
                desc[f, :k] = d / np.maximum(n, 1e-9)
        feats = FrameFeatures(
            xy=xy, descriptor=desc, valid=valid,
            color=np.zeros((F, Kmax, 3), np.uint8),
            counts=valid.sum(1).astype(np.int64), width=W, height=H,
        )
        items = sorted(db.matches.items())
        pair_i = np.asarray([p[0][0] for p in items], np.int32)
        pair_j = np.asarray([p[0][1] for p in items], np.int32)
        idx0, idx1, mmask = pad_match_table(
            [(m[:, 0], m[:, 1]) for _, m in items],
            cfg.frontend.max_matches_per_pair,
        )
        fr = FrontendResult(feats, pair_i, pair_j, idx0, idx1, mmask)
        log.end(frames=F, pairs=len(pair_i))
    else:
        fr = frontend or run_frontend(
            video, cfg, log, gray, color,
            cache_path=os.path.join(output_dir, "frontend.npz"),
            mesh=mesh,
        )
        W, H = fr.feats.width, fr.feats.height
        F = fr.feats.valid.shape[0]
    if image_size is not None:
        W, H = image_size
    F = fr.feats.valid.shape[0]

    # Focal guess = (w + h) / 2 (run_spherical_sfm_uncalib.cpp:101).
    focal_guess = (W + H) / 2.0
    intr_guess = Intrinsics(jnp.asarray(float(focal_guess)),
                            jnp.asarray(W / 2.0), jnp.asarray(H / 2.0))

    log.start("estimate_pairwise")
    if cfg.five_point:
        # -fivepoint: general essential pairwise (reference
        # run_spherical_sfm_uncalib.cpp -fivepoint flag).
        pw = estimate_pairwise_five_point(
            key, fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1,
            fr.mmask, intr_guess,
            inlier_threshold_px=cfg.ransac.inlier_threshold_px,
            min_num_inliers=cfg.ransac.min_num_inliers,
            num_hypotheses=cfg.ransac.num_hypotheses,
        )
    else:
        pw = estimate_pairwise(
            key, fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1, fr.mmask,
            intr_guess,
            inlier_threshold_px=cfg.ransac.inlier_threshold_px,
            min_num_inliers=cfg.ransac.min_num_inliers,
            inward=cfg.inward,
            num_hypotheses=cfg.ransac.num_hypotheses,
            chunk_size=cfg.ransac.pair_chunk,
            adaptive=cfg.ransac.adaptive,
            round_size=cfg.ransac.round_size,
            confidence=cfg.ransac.confidence,
            mesh=mesh,
        )
    keep = _graph_from_pairwise(fr, pw, pw.keep, cfg.graph.min_rotation_deg,
                                best_only=cfg.graph.best_only)
    log.end(kept_pairs=int(keep.sum()), loop_closures=pw.loop_closure_count)

    log.start("largest_component")
    frames, remap = largest_connected_component(F, fr.pair_i, fr.pair_j, keep)
    in_comp = (remap[fr.pair_i] >= 0) & (remap[fr.pair_j] >= 0)
    keep = keep & in_comp
    log.end(frames_in_component=len(frames))

    log.start("focal_search")
    ew = jnp.asarray(keep.astype(float))
    # The search conjugates *spherical* essential matrices rebuilt from the
    # estimated relative rotations (reference find_best_focal_length_random,
    # spherical_sfm_tools.cpp:1429-1433) — not the raw RANSAC E (which is
    # general in five-point mode).
    from ..geometry.essential import make_spherical_essential

    E_search = make_spherical_essential(so3_exp(jnp.asarray(pw.r)), cfg.inward)
    # Bucket the edge axis to the next power of two (padding edges carry
    # w = 0, masked throughout): the focal-search sweeps compile per edge
    # count otherwise — one fresh XLA compile per capture.
    E_n = len(fr.pair_i)
    E_pad = 64
    while E_pad < E_n:
        E_pad *= 2
    padE = lambda x, fill=0: np.pad(  # noqa: E731
        np.asarray(x), [(0, E_pad - E_n)] + [(0, 0)] * (np.ndim(x) - 1),
        constant_values=fill)
    search_args = (
        jnp.asarray(padE(E_search)), jnp.asarray(padE(fr.pair_i)),
        jnp.asarray(padE(fr.pair_j)), jnp.asarray(padE(keep.astype(float))),
        F,
    )
    search_kw = dict(
        min_focal=focal_guess * cfg.focal.min_focal_factor,
        max_focal=focal_guess * cfg.focal.max_focal_factor,
        inward=cfg.inward,
        sequential=cfg.graph.sequential,
    )
    # Strategy dispatch (reference find_best_focal_length_{random,grid,opt},
    # spherical_sfm_tools.cpp:1191-1496; the reference driver uses random).
    if cfg.six_point:
        # --sixpoint: consensus shared focal straight from the strongest
        # pairs via joint (E, f) RANSAC — skips the sweep entirely. The
        # reference built its SixPointEstimator but never called it
        # (six_point_estimator.h:15-37); here it is a live mode. The joint
        # rotations+focal refinement below still polishes the estimate.
        from ..ransac.sixpoint import estimate_focal_sixpoint

        best_focal, sp_info = estimate_focal_sixpoint(
            jax.random.fold_in(key, 11), fr.feats.xy, fr.pair_i, fr.pair_j,
            fr.idx0, fr.idx1, fr.mmask & keep[:, None],
            pair_weight=np.where(keep, pw.num_inliers, 0),
            focal_guess=focal_guess,
            width=float(fr.feats.width), height=float(fr.feats.height),
            inlier_threshold_px=cfg.ransac.inlier_threshold_px,
            min_focal_factor=cfg.focal.min_focal_factor,
            max_focal_factor=cfg.focal.max_focal_factor,
        )
        if sp_info.get("pairs_used", 0) == 0:
            print("warning: sixpoint found no usable pairs; "
                  "keeping the focal guess")
    elif cfg.focal.strategy == "grid":
        best_focal, costs, focals = find_best_focal_grid(
            focal_guess, *search_args, num_steps=cfg.focal.grid_steps,
            cost=cfg.focal.cost, **search_kw,
        )
    elif cfg.focal.strategy == "opt":
        best_focal, ok = find_best_focal_bracketed(
            jax.random.fold_in(key, 10), focal_guess, *search_args,
            cost=cfg.focal.cost, **search_kw,
        )
        if not ok:
            print("warning: focal bracketing failed; keeping the guess "
                  "(reference: 'try increasing focal bounds')")
    else:
        best_focal, costs, focals = find_best_focal_random(
            jax.random.fold_in(key, 10), focal_guess, *search_args,
            num_trials=cfg.focal.num_trials, **search_kw,
        )
    if cfg.focal.strategy in ("grid", "random") and not cfg.six_point:
        # Debug artifact mirroring the reference's costs.txt dump
        # (spherical_sfm_tools.cpp:1358-1404): one "focal cost" row per
        # hypothesis, sorted by focal.
        order = np.argsort(np.asarray(focals))
        with open(os.path.join(output_dir, "focal_costs.txt"), "w") as fh:
            for fo, co in zip(np.asarray(focals)[order],
                              np.asarray(costs)[order]):
                fh.write(f"{float(fo):.4f} {float(co):.8g}\n")
    # Joint rotations + focal refinement at the best hypothesis.
    r_best = rotations_at_focal(E_search, best_focal / focal_guess,
                                cfg.inward)
    g = RotationGraph(jnp.asarray(fr.pair_i), jnp.asarray(fr.pair_j),
                      r_best, ew)
    if cfg.graph.sequential:
        rot0 = initialize_rotations_sequential(F, g)
    else:
        rot0 = initialize_rotations_global(
            F, g, weights=np.where(keep, pw.num_inliers, 0)
        )
    rots, fmult, pg_cost = optimize_rotations_and_focal(
        rot0, g, jnp.asarray(1.0),
        jnp.asarray(float(focal_guess * cfg.focal.min_focal_factor / best_focal)),
        jnp.asarray(float(focal_guess * cfg.focal.max_focal_factor / best_focal)),
    )
    focal = float(best_focal) * float(fmult)
    log.end(best_search_focal=float(best_focal), focal=focal,
            cost=float(pg_cost),
            **({"sixpoint": sp_info} if cfg.six_point else {}))

    intr = Intrinsics(jnp.asarray(focal), jnp.asarray(W / 2.0),
                      jnp.asarray(H / 2.0))

    log.start("build_sfm")
    tracks = build_feature_tracks(
        F, fr.feats.counts, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1,
        pw.inlier_mask & fr.mmask & keep[:, None],
    )
    m = SfMMap.build(intr, np.asarray(rots), tracks, fr.feats.xy,
                     colors=fr.feats.color, spherical=True, inward=cfg.inward)
    m.focal_fixed = False  # focal is a BA parameter from here on
    m.retriangulate(jax.random.fold_in(key, 1), mesh=mesh)
    log.end(points=int(m.point_valid().sum()))
    m.write_colmap(os.path.join(output_dir, "sparse", "pre-spherical-ba"), W, H)

    log.start("spherical_ba")
    stats1 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh)
    m.retriangulate(jax.random.fold_in(key, 2), mesh=mesh)
    stats2 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh, init_lambda=_warm_lambda(stats1))
    log.end(**{f"ba1_{k}": v for k, v in stats1.items()},
            **{f"ba2_{k}": v for k, v in stats2.items()})
    m.write_colmap(os.path.join(output_dir, "sparse", "pre-general-ba"), W, H)

    if cfg.general_ba:
        log.start("general_ba")
        m.translation_fixed[:] = False
        m.translation_fixed[0] = True
        s3 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh, init_lambda=_warm_lambda(stats2))
        m.normalize()
        if cfg.ba.filter_threshold_px > 0:  # opt-in (see BAConfig)
            m.filter_observations(cfg.ba.filter_threshold_px)
        m.retriangulate(jax.random.fold_in(key, 3), mesh=mesh)
        s4 = m.optimize(max_iters=cfg.ba.max_iters,
                        solve_dtype=cfg.ba.solve_dtype,
                        pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters,
                        mesh=mesh, init_lambda=_warm_lambda(s3))
        m.normalize()
        log.end(**{f"ba3_{k}": v for k, v in s3.items()},
                **{f"ba4_{k}": v for k, v in s4.items()})

    log.start("write_outputs")
    m.write_colmap(os.path.join(output_dir, "sparse", "final"), W, H)
    _write_outputs(m, output_dir, fr)
    _maybe_write_reproj_overlays(m, cfg, output_dir, video, gray)
    log.end()
    with open(os.path.join(output_dir, "calib.txt"), "w") as f:
        focal_out = float(np.asarray(m.intrinsics.focal))
        f.write(f"{focal_out} {W / 2.0} {H / 2.0}\n")
    return m, float(np.asarray(m.intrinsics.focal))


def _maybe_write_reproj_overlays(m: SfMMap, cfg, output_dir: str,
                                 video, gray):
    """Observed-vs-reprojected overlay JPEGs behind cfg.debug_reprojection
    (reference show_reprojection_error, spherical_sfm_tools.cpp:957-1005)."""
    if not cfg.debug_reprojection:
        return
    from .debug import write_reprojection_overlays

    if gray is None and video is not None:
        gray, _ = load_frames(video, stride=cfg.frontend.frame_stride)
    if gray is None:
        print("warning: debug_reprojection set but no frames available")
        return
    n = write_reprojection_overlays(
        m, gray, os.path.join(output_dir, "reproj"))
    print(f"wrote {n} reprojection overlays to {output_dir}/reproj")


def _write_outputs(m: SfMMap, output_dir: str, fr: FrontendResult):
    m.write_poses(os.path.join(output_dir, "poses.txt"))
    m.write_points_obj(os.path.join(output_dir, "points.obj"))
    m.write_camera_centers_obj(os.path.join(output_dir, "cameras.obj"))
    m.write_colmap(os.path.join(output_dir, "sparse", "model"),
                   fr.feats.width, fr.feats.height)
    # Machine-readable reconstruction summary next to the artifacts.
    errs = m.reprojection_errors()
    live = np.asarray(m.obs_valid) & (np.linalg.norm(
        m.points[m.obs_pt], axis=-1) > 0)
    summary = {
        "cameras": int(m.num_cameras),
        "points": int(m.point_valid().sum()),
        "observations": int(live.sum()),
        "focal": float(np.asarray(m.intrinsics.focal)),
        "mean_reproj_px": float(errs[live].mean()) if live.any() else None,
        "median_reproj_px": (
            float(np.median(errs[live])) if live.any() else None),
    }
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
