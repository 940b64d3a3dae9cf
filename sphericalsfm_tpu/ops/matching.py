"""Descriptor matching as batched matrix products.

Capability parity with the reference's BFMatcher knn-2 + Lowe ratio matching
(/root/reference/examples/spherical_sfm_tools.cpp:235-251) and
match_exhaustive (:575-600). The reference loops over O(N²) image pairs with
OpenMP and brute-force L2 knn; here one pair's matching is a single
(K×128)·(128×K) matmul plus a two-smallest reduction (the plain path, run
on the CPU) or the streaming Pallas kernel of ops/pallas_matching.py (run
on the GPU), and many pairs batch along a leading axis (vmap / shard over a
mesh `pairs` axis — SURVEY.md §2.5 P2).

Convention (matching the reference's reversed query/train roles): features of
image j (second) are the *queries*; for each query the two nearest neighbors
in image i are found, the ratio test d₁ < ratio·d₂ is applied, and the
surviving pairs are scattered as m01[i_feature] = j_feature.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_INF = jnp.inf


def pairwise_sq_dists(
    d0: jnp.ndarray, d1: jnp.ndarray, precision=jax.lax.Precision.HIGHEST,
    compute_dtype=None,
) -> jnp.ndarray:
    """Squared L2 distances (..., N, K) x (..., M, K) -> (..., N, M).

    The inner product is one batched matrix product (inputs cast to
    `compute_dtype` when given, accumulated in the inputs' own dtype);
    norms are rank-1 updates.
    """
    out = jnp.result_type(d0, d1)
    cdt = out if compute_dtype is None else jnp.dtype(compute_dtype)
    ip = jnp.einsum("...nk,...mk->...nm", d0.astype(cdt), d1.astype(cdt),
                    precision=precision, preferred_element_type=out)
    n0 = jnp.sum(d0 * d0, axis=-1)
    n1 = jnp.sum(d1 * d1, axis=-1)
    return jnp.maximum(n0[..., :, None] + n1[..., None, :] - 2.0 * ip, 0.0)


def _two_smallest(d: jnp.ndarray):
    """Smallest and second-smallest along the last axis, plus argmin."""
    i1 = jnp.argmin(d, axis=-1)
    m1 = jnp.take_along_axis(d, i1[..., None], axis=-1)[..., 0]
    masked = jnp.where(
        jax.nn.one_hot(i1, d.shape[-1], dtype=bool), _INF, d
    )
    m2 = jnp.min(masked, axis=-1)
    return m1, m2, i1


@partial(jax.jit, static_argnames=("ratio",))
def match_pair(
    d0: jnp.ndarray,        # (N, K) descriptors image i
    d1: jnp.ndarray,        # (M, K) descriptors image j
    valid0: jnp.ndarray,    # (N,) bool
    valid1: jnp.ndarray,    # (M,) bool
    ratio: float = 0.75,
):
    """Lowe-ratio matching of one image pair.

    Returns (m01 (N,) int32: index into image j or −1, mask (N,) bool).
    vmap over a leading pair axis for exhaustive matching.
    """
    d = pairwise_sq_dists(d1, d0)  # queries are image-j features: (M, N)
    d = jnp.where(valid0[None, :], d, _INF)
    d = jnp.where(valid1[:, None], d, _INF)
    m1, m2, nn = _two_smallest(d)  # per query j: best train i
    # Lowe test on *distances* (not squared): d1 < ratio·d2 ⇔ d1² < ratio²·d2².
    accept = (m1 < (ratio * ratio) * m2) & valid1 & jnp.isfinite(m1)

    n = d0.shape[0]
    m01 = jnp.full((n,), -1, jnp.int32)
    scatter_idx = jnp.where(accept, nn, n)  # rejected queries → dump slot
    m01 = (
        jnp.concatenate([m01, jnp.full((1,), -1, jnp.int32)])
        .at[scatter_idx]
        .set(jnp.arange(d1.shape[0], dtype=jnp.int32))[:n]
    )
    mask = m01 >= 0
    return m01, mask


def match_to_index_pairs(m01: jnp.ndarray, mask: jnp.ndarray, max_matches: int):
    """Compact a match map (N,) into fixed-size index pairs.

    Returns (idx0 (max_matches,), idx1 (max_matches,), valid (max_matches,)).
    """
    n = m01.shape[0]
    order = jnp.argsort(~mask, stable=True)
    idx0 = order[:max_matches]
    valid = mask[idx0]
    idx1 = jnp.where(valid, m01[idx0], 0)
    return idx0.astype(jnp.int32), idx1.astype(jnp.int32), valid


def nn_to_index_pairs(
    nn: jnp.ndarray, accept: jnp.ndarray, num_train: int, max_matches: int
):
    """Query-indexed nearest neighbors → compact dedup'd index pairs.

    nn (Kq,): train index per query; accept (Kq,): ratio-test survivors.
    Keeps one query per train feature (first by train order — the same
    one-match-per-feature invariant the reference's m01 std::map enforces),
    via one stable sort instead of a scatter.
    Returns (idx0 (M,) train, idx1 (M,) query, valid (M,)).
    """
    kq = nn.shape[0]
    key = jnp.where(accept, nn, num_train)  # rejected → sort to the end
    order = jnp.argsort(key, stable=True)
    key_sorted = key[order]
    first = jnp.ones_like(key_sorted, bool).at[1:].set(
        key_sorted[1:] != key_sorted[:-1]
    )
    valid_sorted = (key_sorted < num_train) & first
    # compact the survivors to the front
    comp = jnp.argsort(~valid_sorted, stable=True)[:max_matches]
    idx0 = key_sorted[comp].astype(jnp.int32)
    idx1 = order[comp].astype(jnp.int32)
    valid = valid_sorted[comp]
    idx0 = jnp.where(valid, idx0, 0)
    idx1 = jnp.where(valid, idx1, 0)
    return idx0, idx1, valid


def matcher_uses_kernel(backend: str) -> bool:
    """Which two-NN implementation a backend runs: the streaming Pallas
    kernel (ops/pallas_matching.py, Triton route) on the GPU, the plain XLA
    distance-matrix path on the CPU."""
    return backend == "gpu"


def two_nn_plain(d0, d1, valid0, valid1, compute_dtype=None):
    """Plain XLA two-NN of (B, K1) queries against (B, K0) train rows:
    the full K1×K0 distance block per pair, then `_two_smallest`. The
    reference the kernel is checked against."""

    def one(dd0, dd1, v0, v1):
        d = pairwise_sq_dists(dd1, dd0, compute_dtype=compute_dtype)
        d = jnp.where(v0[None, :], d, _INF)
        d = jnp.where(v1[:, None], d, _INF)
        return _two_smallest(d)

    return jax.vmap(one)(d0, d1, valid0, valid1)


def two_nearest_neighbors(d0, d1, valid0, valid1, use_kernel=None,
                          interpret: bool = False):
    """Two smallest squared distances + argmin of every (B, K1) query
    against its pair's (B, K0) train rows: the streaming kernel (bf16
    inputs, f32 accumulation) where `matcher_uses_kernel` says so, the
    plain path (f32 at HIGHEST) otherwise. `use_kernel` overrides the
    choice; `interpret=True` runs the kernel in the Pallas interpreter."""
    if use_kernel is None:
        use_kernel = matcher_uses_kernel(jax.default_backend())
    if use_kernel:
        from .pallas_matching import two_nearest_neighbors_batched

        return two_nearest_neighbors_batched(d0, d1, valid0, valid1,
                                             interpret=interpret)
    return two_nn_plain(d0, d1, valid0, valid1)


def match_pairs_compact_batched(
    d0: jnp.ndarray,       # (B, K0, D)
    d1: jnp.ndarray,       # (B, K1, D)
    valid0: jnp.ndarray,
    valid1: jnp.ndarray,
    max_matches: int,
    ratio: float = 0.75,
    use_kernel: bool | None = None,
    interpret: bool = False,
):
    """Batched exhaustive-sweep matcher → compact (i0, i1, valid) tables.

    The two-NN search is `two_nearest_neighbors` (implementation by
    backend unless `use_kernel` says otherwise); the cheap
    dedupe/compaction is vmapped.
    """
    m1, m2, nn = two_nearest_neighbors(d0, d1, valid0, valid1, use_kernel,
                                       interpret)
    accept = (m1 < (ratio * ratio) * m2) & valid1 & jnp.isfinite(m1)
    return jax.vmap(
        lambda n, a: nn_to_index_pairs(n, a, d0.shape[1], max_matches)
    )(nn, accept)
