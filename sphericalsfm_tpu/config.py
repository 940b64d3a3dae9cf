"""Typed configuration for the whole pipeline (SURVEY.md §5.6).

One dataclass replaces the reference's per-driver gflags
(run_spherical_sfm.cpp:17-27, run_spherical_sfm_uncalib.cpp:20-30) and its
scattered hardcoded constants (SIFT caps spherical_sfm_tools.cpp:177-186,
focal search ranges run_spherical_sfm_uncalib.cpp:141-146, stitcher constants
stereo_panorama_tools.cpp:30-32). Defaults mirror the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class FrontendConfig:
    """Feature detection + matching."""

    max_keypoints: int = 4000          # reference ANMS cap
    num_octaves: int = 4
    match_ratio: float = 0.75          # Lowe ratio
    max_matches_per_pair: int = 1024
    detector: str = "device"           # "device" (DoG/SIFT kernel) or "opencv"
    frame_stride: int = 1
    matching: str = "exhaustive"       # "exhaustive" O(F²) | "windows" O(F):
    adjacent_window: int = 3           # adjacent band width in windows mode
    detect_batch: int = 16             # frames per detection kernel launch


@dataclass
class RansacConfig:
    inlier_threshold_px: float = 2.0
    min_num_inliers: int = 100
    num_hypotheses: int = 1024         # cap (= round_size × max rounds)
    pair_chunk: int = 128
    adaptive: bool = True              # RansacLib-style early termination
    round_size: int = 128              # hypotheses per adaptive round
    confidence: float = 0.99           # termination confidence


@dataclass
class GraphConfig:
    min_rotation_deg: float = 1.0      # -minrot
    num_frames_begin: int = 30         # loop-closure search windows
    num_frames_end: int = 30
    best_only: bool = False
    # Rotation init strategy. False = heaviest-spanning-tree / global init,
    # the reference driver's default (run_spherical_sfm_uncalib.cpp:27,
    # DEFINE_bool(sequential, false, ...)). The adjacent-pair chain is NOT
    # the safe default: on wide-FOV captures whose pairwise rotations come
    # out ~2x at the focal GUESS, a 100-frame chain totals two full turns —
    # which also closes the loop, so the focal search's loop-consistency
    # cost develops a spurious minimum at the guess (found round 5:
    # wide_f280 eval sequence locked onto f=571 instead of 280 with
    # sequential=True; the spanning tree pulls closure edges into the init
    # and breaks the alias).
    sequential: bool = False
    triplet_filter_deg: float = 2.0


@dataclass
class FocalSearchConfig:
    """Uncalibrated shared-focal search (ICCV 2025 pipeline)."""

    num_trials: int = 1024
    min_focal_factor: float = 0.25     # guess/4
    max_focal_factor: float = 2.0      # guess*2
    strategy: str = "random"           # random | grid | opt (bracketed)
    cost: str = "loop"                 # loop | total_rotation
    grid_steps: int = 64               # grid strategy resolution


@dataclass
class BAConfig:
    max_iters: int = 200
    loss_scale: float = 1.0            # Cauchy
    solve_dtype: str = "float64"       # "float32" in the accelerator regime
    # Reprojection-error observation filter applied between the general-BA
    # rounds when > 0. Off by default for reference parity: the reference
    # defines SfM::FilterObservations (sfm.cpp:297) but no driver calls it.
    filter_threshold_px: float = 0.0
    # Inexact-Newton forcing for the PCG camera solve (>512 cameras): LM
    # steps don't need a tight inner solve, and the 25-iteration cap bounds
    # per-step latency at the same reached cost as looser caps. Chosen on
    # another chip with scripts/bench_ba_forcing.py; waits for
    # re-derivation on the H100 (ROADMAP 3.3).
    pcg_rtol: float = 1e-2
    pcg_iters: int = 25


@dataclass
class PipelineConfig:
    inward: bool = False
    # Multi-chip execution (SURVEY.md §2.5 P2/P5/P8, §5.8): >1 shards the
    # pipeline over a jax.sharding.Mesh of this many devices — detection over
    # the frame axis (shard_map), matching/pairwise RANSAC over the pair
    # axis, retriangulation over the point axis, and BA observations/points
    # over the data axis with a psum-reduced camera system. 0/1 runs
    # single-device. Must be a power of two ≤ 64 so the pipeline's shape
    # buckets (powers of two / multiples of 8) divide evenly across shards.
    devices: int = 0
    general_ba: bool = False           # unfix translations at the end
    five_point: bool = False           # -fivepoint: general 5-pt pairwise
    six_point: bool = False            # --sixpoint: shared-focal 6-pt RANSAC
    #   replaces the focal search (reference built SixPointEstimator but
    #   never wired it — six_point_estimator.h:15-37)
    profile_dir: str | None = None     # jax.profiler trace output
    debug_reprojection: bool = False   # write reproj%06d.jpg overlays
    #   (reference show_reprojection_error, spherical_sfm_tools.cpp:957-1005)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    focal: FocalSearchConfig = field(default_factory=FocalSearchConfig)
    ba: BAConfig = field(default_factory=BAConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        sub_map = dict(
            frontend=FrontendConfig, ransac=RansacConfig, graph=GraphConfig,
            focal=FocalSearchConfig, ba=BAConfig,
        )
        kwargs = {
            k: (sub_map[k](**v) if k in sub_map else v) for k, v in d.items()
        }
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        return cls.from_dict(json.loads(s))
