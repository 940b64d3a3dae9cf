"""Shared-focal 6-pt RANSAC: joint (E, focal) consensus for one image pair.

The reference built a SixPointEstimator around PoseLib's
relpose_6pt_shared_focal but never wired it into a driver
(/root/reference/examples/six_point_estimator.h:15-37 — constructed, never
called). Here it becomes a live capability: `--sixpoint` lets the
uncalibrated pipeline estimate the shared focal directly from strong pairs
and skip the focal search sweep.

Candidates come from the eigensolver-free focal-sweep 6-pt solver
(solvers/shared_focal.py); each (E, f) candidate is conjugated back to the
nominal-focal ray frame and MSAC-scored with the Sampson error, exactly like
the spherical engine. Fixed shapes throughout; vmap over pairs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.essential import conjugate_essential_by_focal
from ..solvers.five_point import cheirality_best, decompose_essential
from ..solvers.shared_focal import solve_shared_focal_6pt
from .engine import best_model, sample_tuples
from .spherical import sampson_error


class SixPointRansacResult(NamedTuple):
    E: jnp.ndarray            # (3, 3) best essential, NOMINAL-focal frame
    R: jnp.ndarray            # (3, 3) relative rotation
    t: jnp.ndarray            # (3,) unit translation
    focal_mult: jnp.ndarray   # scalar: true focal / nominal focal
    score: jnp.ndarray        # MSAC score
    inlier_mask: jnp.ndarray  # (N,) bool
    num_inliers: jnp.ndarray  # scalar int


@partial(
    jax.jit,
    static_argnames=("num_hypotheses", "num_focal_samples"),
)
def sixpoint_ransac(
    key: jax.Array,
    u: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray,
    sq_thresh: jnp.ndarray,
    num_hypotheses: int = 32,
    min_focal: float = 0.3,
    max_focal: float = 3.0,
    num_focal_samples: int = 64,
) -> SixPointRansacResult:
    """Estimate (E, shared focal) for one pair of ray sets.

    u, v: (N, 3) rays normalized by the NOMINAL focal guess (padded);
    mask: (N,) validity; sq_thresh: squared Sampson threshold in the
    nominal-ray frame. Returns the focal as a multiplier on the guess.
    """
    with jax.default_matmul_precision("highest"):
        tuples = sample_tuples(key, mask, num_hypotheses, 6)  # (M, 6)
        Es, valid, f = solve_shared_focal_6pt(
            u[tuples], v[tuples],
            min_focal=min_focal, max_focal=max_focal,
            num_focal_samples=num_focal_samples,
        )  # (M, 12, 3, 3), (M, 12), (M, 12)
        Es = Es.reshape(-1, 3, 3)
        valid = valid.reshape(-1)
        f = f.reshape(-1)
        # score in the nominal frame: u_cal = diag(1/f,1/f,1) u_nom, so
        # E_nom = diag(1/f,1/f,1) E_cal diag(1/f,1/f,1)
        E_nom = conjugate_essential_by_focal(Es, 1.0 / f)
        errs = sampson_error(E_nom[:, None], u[None], v[None])[:, 0]
        best, score, inliers = best_model(errs, valid, sq_thresh, mask)
        E_best = E_nom[best]
        f_best = f[best]

        # decompose the CALIBRATED-frame essential with cheirality voting on
        # calibrated rays
        d = jnp.stack([1.0 / f_best, 1.0 / f_best, jnp.ones_like(f_best)])
        u_cal = u * d[None, :]
        v_cal = v * d[None, :]
        Rs, ts = decompose_essential(Es[best])
        R, t, _ = cheirality_best(Rs, ts, u_cal, v_cal, inliers)
    return SixPointRansacResult(
        E=E_best, R=R, t=t, focal_mult=f_best, score=score,
        inlier_mask=inliers, num_inliers=jnp.sum(inliers),
    )


def estimate_focal_sixpoint(
    key: jax.Array,
    xy: jnp.ndarray,           # (F, K, 2) keypoints (pixels)
    pair_i, pair_j,            # (P,) frame indices of candidate pairs
    idx0, idx1,                # (P, M) match indices into each frame's kps
    mmask,                     # (P, M) match validity
    pair_weight,               # (P,) selection weight (e.g. inlier counts)
    focal_guess: float,
    width: float,
    height: float,
    inlier_threshold_px: float = 2.0,
    num_pairs: int = 16,
    num_hypotheses: int = 32,
    min_focal_factor: float = 0.3,
    max_focal_factor: float = 3.0,
) -> tuple[float, dict]:
    """Consensus shared focal from the strongest pairs (driver helper).

    Runs `sixpoint_ransac` on the `num_pairs` highest-weight pairs and
    returns the inlier-weighted median focal (absolute pixels) plus
    per-pair diagnostics.
    """
    import numpy as np

    w = np.asarray(pair_weight, float)
    sel = np.argsort(-w)[:num_pairs]
    sel = sel[w[sel] > 0]
    if len(sel) == 0:
        return float(focal_guess), {"pairs_used": 0}
    xy_np = np.asarray(xy)
    cx, cy = width / 2.0, height / 2.0

    def rays(fidx, kidx):
        p = xy_np[fidx][kidx]  # (M, 2)
        x = (p[:, 0] - cx) / focal_guess
        y = (p[:, 1] - cy) / focal_guess
        return np.stack([x, y, np.ones_like(x)], -1)

    u = np.stack([rays(int(pair_i[s]), np.asarray(idx0[s])) for s in sel])
    v = np.stack([rays(int(pair_j[s]), np.asarray(idx1[s])) for s in sel])
    m = np.stack([np.asarray(mmask[s]) for s in sel])
    keys = jax.random.split(key, len(sel))
    run = jax.jit(jax.vmap(
        lambda k, uu, vv, mm: sixpoint_ransac(
            k, uu, vv, mm,
            sq_thresh=jnp.asarray((inlier_threshold_px / focal_guess) ** 2,
                                  xy.dtype if hasattr(xy, "dtype")
                                  else jnp.float32),
            num_hypotheses=num_hypotheses,
            min_focal=min_focal_factor, max_focal=max_focal_factor,
        )
    ))
    res = run(keys, jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32),
              jnp.asarray(m))
    mults = np.asarray(res.focal_mult, float)
    ninl = np.asarray(res.num_inliers, float)
    ok = ninl >= 12  # need a meaningful consensus per pair
    if not ok.any():
        return float(focal_guess), {"pairs_used": 0}
    # inlier-weighted median of the per-pair focal multipliers
    order = np.argsort(mults[ok])
    mw = ninl[ok][order]
    cum = np.cumsum(mw)
    med = mults[ok][order][np.searchsorted(cum, 0.5 * cum[-1])]
    return float(focal_guess * med), {
        "pairs_used": int(ok.sum()),
        "focal_mults": mults[ok].round(4).tolist(),
        "inliers": ninl[ok].astype(int).tolist(),
    }
