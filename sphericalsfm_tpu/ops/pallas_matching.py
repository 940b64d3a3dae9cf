"""Pallas (Triton route) kernel: streaming two-nearest-neighbor matching.

The exhaustive matching sweep is the pipeline's raw-FLOP hot spot
(SURVEY.md §3.1: O(N²·K²·128) — reference spherical_sfm_tools.cpp:575-600
does it with OpenMP + BFMatcher). The XLA path (ops/matching.py) writes
the full K×K f32 distance block of every pair to device memory (64 MB at
K = 4096) and reads it back for the two-smallest reduction. This kernel
never materializes it: each program holds one block of queries, walks the
train descriptors tile by tile in a `fori_loop`, and folds each
(queries × tile) product into a running (min, second-min, argmin) kept in
registers. Device-memory traffic drops from O(K²) to O(K·D) per pair.

Grid: (pair, query block). Programs run in parallel and in no order; the
loop over train tiles inside each program replaces a sequential grid axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_NEG = -1
# Tiles and Triton launch parameters. A sweep of (query block, train tile,
# warps, stages) over {32..128}² × {4, 8} × {2, 3} at 32 pairs × K=4000 on
# an H100 (400 W limit) put every 64/128 combination within ~2 µs/pair of
# each other; (64, 128, 4, 3) was the fastest (PERF.md, Findings).
_Q_BLOCK = 64
_T_BLOCK = 128
_NUM_WARPS = 4
_NUM_STAGES = 3


def _match_kernel(q_ref, t_ref, bias_ref, m1_ref, m2_ref, idx_ref, *,
                  t_block: int, num_tiles: int, precision):
    q = q_ref[...]                                   # (Q, D)
    nq = q.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (nq, t_block), 1)

    def tile(j, carry):
        m1, m2, idx = carry
        rows = pl.ds(pl.multiple_of(j * t_block, t_block), t_block)
        t = t_ref[rows, :]                           # (T, D)
        # d² = |q|² + |t|² − 2·q·t; bias carries |t|² (+inf on padding and
        # invalid rows), and the per-query |q|² is added by the wrapper —
        # it shifts a whole row, so the argmin does not depend on it.
        ip = pl.dot(q, t, trans_b=True, precision=precision)  # (Q, T) f32
        d = bias_ref[rows][None, :] - 2.0 * ip
        blk_m1 = jnp.min(d, axis=1)
        blk_arg = jnp.argmin(d, axis=1).astype(jnp.int32)
        blk_m2 = jnp.min(jnp.where(col == blk_arg[:, None], jnp.inf, d),
                         axis=1)
        new_idx = jnp.where(blk_m1 < m1, blk_arg + j * t_block, idx)
        new_m2 = jnp.minimum(jnp.maximum(m1, blk_m1), jnp.minimum(m2, blk_m2))
        return jnp.minimum(m1, blk_m1), new_m2, new_idx

    init = (jnp.full((nq,), jnp.inf, jnp.float32),
            jnp.full((nq,), jnp.inf, jnp.float32),
            jnp.full((nq,), _NEG, jnp.int32))
    m1, m2, idx = jax.lax.fori_loop(0, num_tiles, tile, init)
    m1_ref[...] = m1
    m2_ref[...] = m2
    idx_ref[...] = idx


@partial(jax.jit, static_argnames=("interpret", "compute_dtype"))
def two_nearest_neighbors_batched(
    d0: jnp.ndarray,       # (B, K0, D) train descriptors
    d1: jnp.ndarray,       # (B, K1, D) query descriptors
    valid0: jnp.ndarray,   # (B, K0)
    valid1: jnp.ndarray,   # (B, K1)
    interpret: bool = False,
    compute_dtype: str = "bfloat16",
):
    """Two smallest squared L2 distances + argmin per query, per pair.

    Returns (m1 (B, K1), m2 (B, K1), idx (B, K1) int32), the same contract
    as ops.matching's plain path: invalid queries carry +inf distances, and
    distances are clamped at 0 like `pairwise_sq_dists`. K0/K1 are padded
    internally to block multiples; D must be a power of two.

    `compute_dtype` is the product's INPUT dtype; accumulation is always
    f32. On SIFT's stored grid (uint8 / 512) bf16 is exact; the detector's
    full-precision descriptors round to bf16's 8 significant bits, ~4e-3 on
    a unit-norm inner product — far inside the 0.75 ratio-test margin.
    Pass "float32" for exactness checks.
    """
    B, K0, D = d0.shape
    K1 = d1.shape[1]
    cdt = jnp.dtype(compute_dtype)
    q_block, t_block = _Q_BLOCK, _T_BLOCK
    K0p = -(-K0 // t_block) * t_block
    K1p = -(-K1 // q_block) * q_block
    d0f = d0.astype(jnp.float32)
    d1f = d1.astype(jnp.float32)
    d0p = jnp.pad(d0.astype(cdt), ((0, 0), (0, K0p - K0), (0, 0)))
    d1p = jnp.pad(d1.astype(cdt), ((0, 0), (0, K1p - K1), (0, 0)))
    bias0 = jnp.where(valid0, jnp.sum(d0f * d0f, -1), jnp.inf)
    bias0 = jnp.pad(bias0, ((0, 0), (0, K0p - K0)),
                    constant_values=jnp.inf).astype(jnp.float32)

    precision = (jax.lax.Precision.HIGHEST if cdt == jnp.float32 else None)
    kernel = partial(_match_kernel, t_block=t_block,
                     num_tiles=K0p // t_block, precision=precision)
    row = pl.BlockSpec((None, q_block), lambda b, i: (b, i))
    m1, m2, idx = pl.pallas_call(
        kernel,
        grid=(B, K1p // q_block),
        in_specs=[
            pl.BlockSpec((None, q_block, D), lambda b, i: (b, i, 0)),
            pl.BlockSpec((None, K0p, D), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((None, K0p), lambda b, i: (b, 0)),
        ],
        out_specs=[row, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((B, K1p), jnp.float32),
            jax.ShapeDtypeStruct((B, K1p), jnp.float32),
            jax.ShapeDtypeStruct((B, K1p), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="two_nn_match",
    )(d1p, d0p, bias0)

    n1 = jnp.sum(d1f * d1f, -1)
    m1 = jnp.where(valid1, jnp.maximum(m1[:, :K1] + n1, 0.0), jnp.inf)
    m2 = jnp.where(valid1, jnp.maximum(m2[:, :K1] + n1, 0.0), jnp.inf)
    return m1, m2, idx[:, :K1]
