"""Batched fixed-shape RANSAC engine — the device replacement for LO-RANSAC.

The reference wraps a sequential, adaptively-terminated LO-MSAC
(RansacLib, /root/reference/include/RansacLib/ransac.h:121-275). On an
accelerator the idiomatic shape is *breadth-first*: generate M hypotheses at once (vmapped
minimal solver over PRNG-sampled index triples), score every hypothesis
against every correspondence as one batched contraction (MSAC top-hat),
argmin, then locally optimize the winner (non-minimal refits + damped
Gauss-Newton refinement standing in for RansacLib's LO steps + Ceres final
least squares). Fixed shapes throughout; padded correspondences carry a
validity mask.

Number-of-iterations semantics: the reference adapts its iteration count to
the inlier ratio (utils.h:110-140); here M is static — callers size it so
that P(miss) = (1 − ρ³)^M is negligible for the lowest inlier ratio they care
about (M = 1024 covers ρ = 0.15 at 99.7%).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: jnp.ndarray      # best model parameters (estimator-specific)
    score: jnp.ndarray      # MSAC score (lower is better)
    inlier_mask: jnp.ndarray  # (N,) bool
    num_inliers: jnp.ndarray  # scalar int


def sample_tuples(
    key: jax.Array, mask: jnp.ndarray, num_samples: int, k: int
) -> jnp.ndarray:
    """Draw `num_samples` k-tuples of indices (distinct within each tuple)
    uniformly from the valid entries of `mask` (N,). Returns (num_samples, k).

    Uniform without replacement via the shifted-integer trick applied on a
    compacted valid-index ordering — no rejection loops, fixed shapes. k is
    static and small (2-7).
    """
    n = mask.shape[0]
    order = jnp.argsort(~mask, stable=True)  # valid indices first
    v = jnp.maximum(jnp.sum(mask), k)

    keys = jax.random.split(key, k)
    chosen = []  # each (num_samples,), positions in [0, v)
    for j in range(k):
        i = jax.random.randint(keys[j], (num_samples,), 0, v - j)
        # Shift past already-chosen positions, in ascending order of their
        # values. With j ≤ 6 a static insertion-sort of the previous picks
        # keeps this O(k²) scalar work per sample.
        prev = chosen
        if prev:
            stacked = jnp.stack(prev, axis=-1)  # (num_samples, j)
            stacked = jnp.sort(stacked, axis=-1)
            for idx_p in range(len(prev)):
                i = i + (i >= stacked[:, idx_p])
        chosen.append(i)
    idx = jnp.stack(chosen, axis=-1)
    return order[jnp.clip(idx, 0, n - 1)]


def sample_triples(key: jax.Array, mask: jnp.ndarray, num_samples: int) -> jnp.ndarray:
    """Draw index triples; see `sample_tuples`."""
    return sample_tuples(key, mask, num_samples, 3)


def sample_k(key: jax.Array, mask: jnp.ndarray, k: int) -> jnp.ndarray:
    """Draw k indices without replacement, biased to valid entries: take the
    top-k of valid-preferring random keys (Gumbel trick). Returns (k,)."""
    g = jax.random.uniform(key, mask.shape)
    scores = jnp.where(mask, g, -1.0)
    return jnp.argsort(-scores)[:k]


def msac_score(sq_err: jnp.ndarray, sq_thresh, mask: jnp.ndarray) -> jnp.ndarray:
    """MSAC (truncated quadratic) score over the last axis."""
    capped = jnp.minimum(sq_err, sq_thresh)
    return jnp.sum(jnp.where(mask, capped, 0.0), axis=-1)


def best_model(
    sq_errs: jnp.ndarray,      # (S, N) squared residuals of each candidate
    model_valid: jnp.ndarray,  # (S,) candidate validity
    sq_thresh,
    mask: jnp.ndarray,         # (N,) data validity
):
    """Select the MSAC-best candidate. Returns (best_idx, score, inliers)."""
    sq_errs = jnp.where(jnp.isfinite(sq_errs), sq_errs, jnp.inf)
    scores = msac_score(sq_errs, sq_thresh, mask)
    scores = jnp.where(model_valid, scores, jnp.inf)
    best = jnp.argmin(scores)
    inliers = (sq_errs[best] < sq_thresh) & mask
    return best, scores[best], inliers
