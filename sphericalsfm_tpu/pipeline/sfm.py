"""The SfM map: host-side reconstruction state + device compute kernels.

Capability parity with the reference's SfM class
(/root/reference/include/sphericalsfm/sfm.h:18-106, src/sfm.cpp): mutable
cameras/points/observations with per-parameter freeze flags, RANSAC
retriangulation, robust bundle adjustment, observation filtering, similarity
transforms, normalization, and COLMAP/OBJ/poses writers.

Design split (SURVEY.md §7.8): the mutable std::map-backed containers of the
reference become numpy tables on the host, rebuilt between rounds; every
compute-heavy method (Retriangulate, Optimize) lowers to one fixed-shape
batched device call (vmapped triangulation RANSAC, Schur-complement LM BA).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry.pose import Intrinsics
from ..geometry.so3 import np_so3_exp, np_so3_log
from ..optim.ba import (
    BAProblem, bundle_adjust, build_tracks, prepare_problem,
)
from ..ransac.triangulation import triangulation_ransac
from .tracks import Tracks


def _rotmat(r):
    # Host numpy: this runs in bookkeeping paths (centers, reprojection
    # errors, similarity transforms) where an eager device op would cost a
    # dispatch and a fetch per call.
    return np_so3_exp(r)


@partial(jax.jit, static_argnames=("sq_thresh", "num_hypotheses"))
def _retri_chunk(keys, rs, ts, uv, mask, focal, *, sq_thresh, num_hypotheses):
    """One jitted retriangulation chunk. Module-level so repeated
    retriangulate() calls hit the in-memory jit cache — a jit wrapper built
    inside the method would retrace on every call. Traced under HIGHEST
    matmul precision: the triangulated points are direct geometry outputs,
    and a backend's default f32 matmul may round its inputs (TF32 on the
    GPU)."""
    with jax.default_matmul_precision("highest"):
        return jax.vmap(
            lambda k, a, b, c, d: triangulation_ransac(
                k, a, b, c, d, focal, sq_thresh=sq_thresh,
                num_hypotheses=num_hypotheses,
            )
        )(keys, rs, ts, uv, mask)


@dataclass
class SfMMap:
    intrinsics: Intrinsics
    inward: bool = False

    cam_t: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    cam_r: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    paths: list = field(default_factory=list)
    rotation_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    translation_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    focal_fixed: bool = True

    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    point_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))

    obs_cam: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obs_pt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obs_uv: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    obs_valid: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))

    # --- construction -----------------------------------------------------

    @classmethod
    def build(
        cls,
        intrinsics: Intrinsics,
        rotations_r: np.ndarray,          # (C, 3) global rotations
        tracks: Tracks,
        keypoints: np.ndarray,            # (C, Kmax, 2) pixel coords
        colors: np.ndarray | None = None,  # (C, Kmax, 3) sampled colors
        spherical: bool = True,
        inward: bool = False,
        fix_camera: int = 0,
        paths: list | None = None,
    ) -> "SfMMap":
        """The reference's build_sfm (spherical_sfm_tools.cpp:862-954):
        cameras at t=(0,0,∓1) with the given rotations (translation frozen in
        spherical mode, rotation frozen only for `fix_camera`), observations
        centered at the principal point."""
        C = rotations_r.shape[0]
        tz = 1.0 if inward else -1.0
        m = cls(intrinsics=intrinsics, inward=inward)
        m.cam_r = np.asarray(rotations_r, float).copy()
        m.cam_t = np.tile(np.array([0.0, 0.0, tz]), (C, 1))
        m.paths = list(paths) if paths is not None else [f"{i:06d}.png" for i in range(C)]
        m.rotation_fixed = np.zeros(C, bool)
        m.rotation_fixed[fix_camera] = True
        m.translation_fixed = np.full(C, bool(spherical))

        P = tracks.num_points
        m.points = np.zeros((P, 3))
        m.point_fixed = np.zeros(P, bool)
        cx = float(np.asarray(intrinsics.cx))
        cy = float(np.asarray(intrinsics.cy))
        uv = np.asarray(keypoints)[tracks.obs_cam, tracks.obs_feat] - np.array([cx, cy])
        m.obs_cam = tracks.obs_cam.copy()
        m.obs_pt = tracks.obs_pt.copy()
        m.obs_uv = uv
        m.obs_valid = np.ones(len(uv), bool)
        if colors is not None:
            m.colors = np.zeros((P, 3), np.uint8)
            m.colors[tracks.obs_pt] = np.asarray(colors)[tracks.obs_cam, tracks.obs_feat]
        else:
            m.colors = np.zeros((P, 3), np.uint8)
        return m

    # --- bookkeeping ------------------------------------------------------

    @property
    def num_cameras(self) -> int:
        return self.cam_r.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    def point_valid(self) -> np.ndarray:
        return np.linalg.norm(self.points, axis=-1) > 0

    def centers(self) -> np.ndarray:
        R = _rotmat(self.cam_r)
        return -np.einsum("cji,cj->ci", R, self.cam_t)

    def _track_tables(self, max_track: int | None = None):
        K = len(self.obs_cam)
        w = self.obs_valid.astype(float)
        track_obs, track_mask = build_tracks(self.obs_pt, self.num_points, max_track)
        track_mask = track_mask & (w[track_obs] > 0)
        return track_obs, track_mask

    # --- compute stages ---------------------------------------------------

    def retriangulate(self, key=None, sq_thresh: float = 4.0,
                      num_hypotheses: int = 32, chunk: int = 4096,
                      mesh=None):
        """RANSAC-retriangulate every track (reference Retriangulate,
        sfm.cpp:156-192): tracks with <3 valid observations zero out;
        successes need ≥3 inliers at 2px (4 px²). With `mesh`, each chunk's
        point axis shards over the data axis (SURVEY.md §2.5 P3)."""
        if self.num_points == 0:
            return
        key = jax.random.PRNGKey(0) if key is None else key
        # Bucket the track axis to the next power of two: the raw max track
        # length is data-dependent, so every new capture would otherwise
        # compile a fresh kernel shape (the persistent cache only helps for
        # shapes seen before).
        nmax = int(np.bincount(self.obs_pt, minlength=1).max())
        T = 4
        while T < nmax:
            T *= 2
        track_obs, track_mask = self._track_tables(max_track=T)
        # All prep is host numpy: every eager jnp gather/pad here would be a
        # separate device dispatch.
        cam_of_obs = np.asarray(self.obs_cam)[np.asarray(track_obs)]
        rs = np.asarray(self.cam_r)[cam_of_obs]
        ts = np.asarray(self.cam_t)[cam_of_obs]
        uv = np.asarray(self.obs_uv)[np.asarray(track_obs)]
        mask = np.asarray(track_mask)
        focal = float(np.asarray(self.intrinsics.focal))
        dt = rs.dtype.type

        # Pad the point axis to whole chunks (one compiled shape) and queue
        # every chunk before fetching any result — a per-chunk np.asarray
        # would serialize host and device.
        P = self.num_points
        n_chunks = -(-P // chunk)
        Ppad = n_chunks * chunk

        def pad(x, fill=0):
            if x.shape[0] == Ppad:
                return x
            widths = [(0, Ppad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, widths, constant_values=fill)

        keys = np.asarray(jax.random.split(key, P))
        keys = pad(keys)
        rs, ts, uv = pad(rs), pad(ts), pad(uv)
        mask = pad(mask, fill=False)
        outs = []
        for s in range(0, Ppad, chunk):
            e = s + chunk
            args = (keys[s:e], rs[s:e], ts[s:e], uv[s:e], mask[s:e])
            if mesh is not None:
                from ..parallel.sharded import put_sharded

                args = put_sharded(mesh, *args)
            else:
                args = tuple(jnp.asarray(a) for a in args)
            outs.append(_retri_chunk(
                *args, dt(focal),
                sq_thresh=sq_thresh, num_hypotheses=num_hypotheses))
        X = np.asarray(jnp.concatenate([o.X for o in outs]))[:P]
        ok = np.asarray(jnp.concatenate([o.ok for o in outs]))[:P]
        self.points = np.where(ok[:, None], X, 0.0)

    def optimize(self, max_iters: int = 100, solve_dtype: str = "float64",
                 loss_scale: float = 1.0, ftol: float = 1e-6,
                 pcg_rtol: float = 1e-4, pcg_iters: int = 100,
                 mesh=None, init_lambda: float = 1e-4,
                 init_dec: float = 2.0) -> dict:
        """Robust BA (reference Optimize, sfm.cpp:228-290): points with <3
        observations or at the origin are excluded; Cauchy(1.0) loss.

        ftol defaults to Ceres' function_tolerance default (1e-6), which the
        reference's ConfigureSolverOptions (sfm.cpp:200-212) leaves untouched
        — with the previous 1e-9 the f32 path could never terminate early and
        every BA burned its full max_iters.

        With `mesh`, the prepared problem lays out over the mesh
        (observations/points sharded, cameras replicated — the distributed
        Schur layout of SURVEY.md §2.5 P5) before the same jitted LM loop
        runs; the padded shape buckets below are powers of two, so they
        divide any power-of-two mesh."""
        import time as _time

        if self.num_cameras == 0 or self.num_points == 0:
            return {}
        _t0 = _time.perf_counter()
        pv = self.point_valid()
        nobs = np.bincount(
            self.obs_pt, weights=self.obs_valid.astype(float),
            minlength=self.num_points,
        )
        usable_pt = pv & (nobs >= 3)
        w = (self.obs_valid & usable_pt[self.obs_pt]).astype(float)
        if w.sum() == 0:
            return {}
        # Bucket the track axis like C below (8-aligned 1.25× ladder): the
        # dense slot solver's compiled shape depends on Tmax, and the raw
        # longest track changes after every retriangulation — one ~30 s XLA
        # compile per BA pass without this. Bucketing UP keeps the table
        # complete (extra slots are masked padding).
        nmax = int(np.bincount(self.obs_pt, minlength=1).max()) or 1
        Tb = 8
        while Tb < nmax:
            Tb = max(Tb + 8, int(Tb * 1.25) // 8 * 8)
        track_obs, track_mask = build_tracks(
            self.obs_pt, self.num_points, max_track=Tb)
        track_mask = track_mask & (w[track_obs] > 0)

        # Bucket the traced shapes (C to 1.25×-steps, P/K to powers of two)
        # so captures of DIFFERENT length reuse compiled BA programs — the
        # XLA compile of the LM while_loop takes tens of seconds per
        # distinct shape.
        # Padding is inert by construction: padded cameras are fully frozen
        # with no observations (the solvers' frozen-dim masking keeps their
        # blocks exact zeros), padded points are fixed with no live
        # observations (Hpp_inv = 0 via the live-obs count), and padded
        # observations carry w = 0 and are excluded from the pair tables.
        C, P, K = self.num_cameras, self.num_points, len(self.obs_cam)
        Cp = 8
        while Cp < C:
            Cp = max(Cp + 8, int(Cp * 1.25) // 8 * 8)
        Pp, Kp = 64, 64
        while Pp <= P:  # strictly > P: padded observations park on point P
            Pp *= 2
        while Kp < K:
            Kp *= 2

        def padn(x, n, fill=0):
            widths = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, widths, constant_values=fill)

        # Host(numpy)-backed problem: `prepare_problem` (solver choice, sort,
        # pair tables) then runs entirely host-side with ZERO device
        # fetches — prepping an already-uploaded problem would fetch it back
        # first. The arrays upload once, at the jitted LM call.
        prob = BAProblem(
            focal=np.asarray(float(np.asarray(self.intrinsics.focal))),
            cam_t=padn(self.cam_t, Cp),
            cam_r=padn(self.cam_r, Cp),
            points=padn(self.points, Pp),
            obs_cam=padn(self.obs_cam, Kp),
            obs_pt=padn(self.obs_pt, Kp, fill=P),
            obs_uv=padn(self.obs_uv, Kp),
            obs_w=padn(w, Kp),
            track_obs=padn(track_obs, Pp),
            track_mask=padn(track_mask, Pp, fill=False),
            focal_fixed=np.asarray(self.focal_fixed),
            rot_fixed=padn(self.rotation_fixed, Cp, fill=True),
            trans_fixed=padn(self.translation_fixed, Cp, fill=True),
            point_fixed=padn(self.point_fixed | ~usable_pt, Pp, fill=True),
        )
        prob, solver = prepare_problem(prob)
        if mesh is not None:
            from ..parallel.sharded import shard_ba_problem

            prob = shard_ba_problem(mesh, prob)
        _t1 = _time.perf_counter()
        res = bundle_adjust(prob, max_iters=max_iters,
                            loss_scale=loss_scale,
                            solve_dtype_name=solve_dtype, ftol=ftol,
                            pcg_rtol=pcg_rtol, pcg_iters=pcg_iters,
                            camera_solver=solver,
                            init_lambda=init_lambda, init_dec=init_dec)
        # ONE host fetch for everything (each separate np.asarray would be
        # its own blocking transfer).
        cam_t, cam_r, upd, focal, cost, c0, iters, lam_f = jax.device_get(
            (res.cam_t, res.cam_r, res.points, res.focal, res.cost,
             res.initial_cost, res.iterations, res.lam)
        )
        _t2 = _time.perf_counter()
        self.cam_t = np.asarray(cam_t)[:C]
        self.cam_r = np.asarray(cam_r)[:C]
        self.points = np.where(usable_pt[:, None], np.asarray(upd)[:P],
                               self.points)
        self.intrinsics = Intrinsics(
            jnp.asarray(float(focal)), self.intrinsics.cx, self.intrinsics.cy
        )
        return {
            "initial_cost": float(c0),
            "final_cost": float(cost),
            "iterations": int(iters),
            "focal": float(focal),
            "prep_s": round(_t1 - _t0, 2),
            "solve_s": round(_t2 - _t1, 2),
            # final LM damping, for warm-starting the next robust pass
            # (clamped by the caller; see driver._warm_lambda)
            "lam": float(lam_f),
        }

    def reprojection_errors(self) -> np.ndarray:
        """Per-observation reprojection error in pixels."""
        R = _rotmat(self.cam_r)
        PX = (
            np.einsum("kij,kj->ki", R[self.obs_cam], self.points[self.obs_pt])
            + self.cam_t[self.obs_cam]
        )
        z = np.where(np.abs(PX[:, 2]) > 1e-12, PX[:, 2], 1e-12)
        f = float(np.asarray(self.intrinsics.focal))
        proj = f * PX[:, :2] / z[:, None]
        return np.linalg.norm(proj - self.obs_uv, axis=-1)

    def filter_observations(self, thresh_px: float) -> int:
        """Invalidate observations above the reprojection threshold
        (reference FilterObservations, sfm.cpp:297-339); points left with no
        valid observation zero out."""
        pv = self.point_valid()
        nobs = np.bincount(self.obs_pt, weights=self.obs_valid.astype(float),
                           minlength=self.num_points)
        eligible = pv & (nobs >= 3)
        err = self.reprojection_errors()
        bad = self.obs_valid & eligible[self.obs_pt] & (err > thresh_px)
        self.obs_valid &= ~bad
        left = np.bincount(self.obs_pt, weights=self.obs_valid.astype(float),
                           minlength=self.num_points)
        self.points[left == 0] = 0.0
        return int(bad.sum())

    # --- similarity transforms -------------------------------------------

    def apply_pose(self, R: np.ndarray, t: np.ndarray):
        """X → R X + t on the world (reference Apply(Pose), sfm.cpp:341-362):
        cameras post-multiply by the inverse."""
        # camera: x = Rc X + tc. After world map X' = R X + t (X = Rᵀ(X'−t)):
        # x = Rc Rᵀ X' + (tc − Rc Rᵀ t).
        Rc = _rotmat(self.cam_r)
        Rn = Rc @ R.T
        tn = self.cam_t - np.einsum("cij,j->ci", Rn, t)
        self.cam_r = np_so3_log(Rn)
        self.cam_t = tn
        valid = self.point_valid()
        self.points = np.where(
            valid[:, None], self.points @ R.T + t, self.points
        )

    def apply_scale(self, s: float):
        self.cam_t = self.cam_t * s
        valid = self.point_valid()
        self.points = np.where(valid[:, None], self.points * s, self.points)

    def normalize(self):
        """Center camera centroid, unit mean radius, flip if inverted
        (reference Normalize, sfm.cpp:535-571; flip keyed to camera 0's t_z)."""
        c = self.centers()
        centroid = c.mean(axis=0)
        self.apply_pose(np.eye(3), -centroid)
        scale = np.linalg.norm(self.centers(), axis=-1).mean()
        self.apply_scale(1.0 / max(scale, 1e-12))
        tz = self.cam_t[0, 2]
        if (self.inward and tz < 0) or ((not self.inward) and tz > 0):
            self.apply_scale(-1.0)

    # --- writers ----------------------------------------------------------

    def write_poses(self, path: str, indices=None):
        """poses.txt: index + 6 camera params (t then r), 15 decimals
        (reference WritePoses, sfm.cpp:463-480)."""
        idx = indices if indices is not None else list(range(self.num_cameras))
        with open(path, "w") as f:
            for i in range(self.num_cameras):
                vals = list(self.cam_t[i]) + list(self.cam_r[i])
                f.write(f"{idx[i]} " + " ".join(f"{v:.15f}" for v in vals) + " \n")

    def write_points_obj(self, path: str, max_distance: float = 2000.0):
        """OBJ point cloud, dropping far points (reference WritePointsOBJ,
        sfm.cpp:482-519)."""
        c = self.centers()
        valid = self.point_valid()
        with open(path, "w") as f:
            for j in np.nonzero(valid)[0]:
                obs = self.obs_valid & (self.obs_pt == j)
                if obs.any():
                    cam = self.obs_cam[obs][-1]
                    if np.linalg.norm(self.points[j] - c[cam]) > max_distance:
                        continue
                X = self.points[j]
                f.write(f"v {X[0]:.15f} {X[1]:.15f} {X[2]:.15f}\n")

    def write_camera_centers_obj(self, path: str):
        with open(path, "w") as f:
            for ctr in self.centers():
                f.write(f"v {ctr[0]:.15f} {ctr[1]:.15f} {ctr[2]:.15f}\n")

    def write_colmap(self, sparse_dir: str, width: int, height: int):
        """COLMAP text model (cameras/images/points3D.txt) with SIMPLE_PINHOLE
        and principal-point re-centering (reference WriteCOLMAP,
        sfm.cpp:573-647)."""
        from ..io.colmap import write_colmap_text

        write_colmap_text(self, sparse_dir, width, height)
