"""Streaming matcher tests: the Triton-route Pallas kernel in interpret mode
on the CPU backend, checked against the plain XLA path, plus the backend
dispatch and the compaction that follows the two-NN search."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sphericalsfm_tpu.ops.matching import (
    match_pairs_compact_batched,
    matcher_uses_kernel,
    nn_to_index_pairs,
    two_nn_plain,
)
from sphericalsfm_tpu.ops.pallas_matching import two_nearest_neighbors_batched


def _descriptors(seed, B, K, noise=0.05, K1=None):
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(B, K, 128)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    perm = rng.permutation(K)[: K1 or K]
    d1 = d0[:, perm] + rng.normal(size=(B, len(perm), 128)).astype(
        np.float32) * noise
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return jnp.asarray(d0), jnp.asarray(d1), perm


# (K0, K1): block multiples, ragged tails on both sides, and K0 != K1.
@pytest.mark.parametrize("K0,K1", [(384, 384), (200, 130), (96, 250)])
def test_kernel_matches_xla_reference(K0, K1):
    B = 2
    d0, d1, _ = _descriptors(0, B, K0, K1=min(K0, K1))
    if K1 > K0:  # extra queries with no true partner
        extra = np.random.default_rng(5).normal(size=(B, K1 - K0, 128))
        extra /= np.linalg.norm(extra, axis=-1, keepdims=True)
        d1 = jnp.concatenate([d1, jnp.asarray(extra, jnp.float32)], 1)
    v0 = jnp.ones((B, K0), bool).at[:, -5:].set(False)
    v1 = jnp.ones((B, K1), bool).at[:, :3].set(False)
    m1p, m2p, nnp = two_nearest_neighbors_batched(
        d0, d1, v0, v1, interpret=True, compute_dtype="float32"
    )
    m1x, m2x, nnx = two_nn_plain(d0, d1, v0, v1)
    valid = np.asarray(v1)
    assert m1p.shape == m2p.shape == nnp.shape == (B, K1)
    np.testing.assert_allclose(
        np.asarray(m1p)[valid], np.asarray(m1x)[valid], atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(m2p)[valid], np.asarray(m2x)[valid], atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(nnp)[valid], np.asarray(nnx)[valid])
    # invalid queries carry +inf, like the plain path
    assert np.all(np.isinf(np.asarray(m1p)[~valid]))


def _ratio_matches(B, m1, m2, nn):
    r2 = 0.75 * 0.75
    acc = np.asarray((m1 < r2 * m2) & jnp.isfinite(m1))
    return {(b, int(q), int(n)) for b in range(B)
            for q, n in enumerate(np.asarray(nn)[b]) if acc[b, q]}


def test_bf16_kernel_keeps_ratio_test_recall():
    """The production bf16-input/f32-accumulate mode must keep the same
    ratio-test decisions as exact f32."""
    B, K = 2, 384
    d0, d1, _ = _descriptors(2, B, K)
    v = jnp.ones((B, K), bool)
    match_f = _ratio_matches(B, *two_nearest_neighbors_batched(
        d0, d1, v, v, interpret=True, compute_dtype="float32"))
    match_b = _ratio_matches(B, *two_nearest_neighbors_batched(
        d0, d1, v, v, interpret=True, compute_dtype="bfloat16"))
    agree = len(match_f & match_b) / max(len(match_f | match_b), 1)
    assert agree > 0.99, agree


def test_plain_bf16_path_keeps_ratio_test_recall():
    """The plain path at the kernel's precision (bf16 inputs, f32
    accumulation) — the XLA side of the on-card timing comparison — keeps
    the f32 decisions too."""
    B, K = 2, 384
    d0, d1, _ = _descriptors(3, B, K)
    v = jnp.ones((B, K), bool)
    match_f = _ratio_matches(B, *two_nn_plain(d0, d1, v, v))
    match_b = _ratio_matches(B, *two_nn_plain(d0, d1, v, v,
                                              compute_dtype="bfloat16"))
    agree = len(match_f & match_b) / max(len(match_f | match_b), 1)
    assert agree > 0.99, agree


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_matcher_implementation_per_backend(backend, kernel):
    assert matcher_uses_kernel(backend) is kernel


def test_default_dispatch_on_cpu_is_plain_path():
    """With no override the CPU backend runs the plain path: the result is
    bit-identical to an explicit use_kernel=False call."""
    B, K = 1, 128
    d0, d1, _ = _descriptors(4, B, K)
    v = jnp.ones((B, K), bool)
    a = match_pairs_compact_batched(d0, d1, v, v, max_matches=K)
    b = match_pairs_compact_batched(d0, d1, v, v, max_matches=K,
                                    use_kernel=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_nn_to_index_pairs_dedupes():
    nn = jnp.asarray([3, 3, 7, 1, 7, 2], jnp.int32)
    accept = jnp.asarray([True, True, True, False, True, True])
    i0, i1, valid = nn_to_index_pairs(nn, accept, 8, 6)
    got = {(int(a), int(b)) for a, b, v in zip(i0, i1, valid) if v}
    # one query per train index; first query (by train order) wins
    assert got == {(2, 5), (3, 0), (7, 2)}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_compact_matcher_end_to_end(use_kernel):
    B, K = 2, 256
    d0, d1, perm = _descriptors(1, B, K)
    v = jnp.ones((B, K), bool)
    i0, i1, valid = match_pairs_compact_batched(
        d0, d1, v, v, max_matches=K, use_kernel=use_kernel,
        interpret=use_kernel,
    )
    i0, i1, valid = map(np.asarray, (i0, i1, valid))
    good = total = 0
    for b in range(B):
        for a, q, ok in zip(i0[b], i1[b], valid[b]):
            if not ok:
                continue
            total += 1
            good += perm[q] == a
    assert total > K * 0.9 * B
    assert good / total > 0.99
