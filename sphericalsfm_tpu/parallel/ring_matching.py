"""Ring-sharded exhaustive matching: the O(N²) sweep over a device mesh.

The reference sweeps all frame pairs with OpenMP (spherical_sfm_tools.cpp:
575-600). Across a device mesh the idiomatic layout (SURVEY.md §5.7, the
sequence-parallel analogue) is a *ring*: each device holds one block of
frames' descriptors; at step s every device matches its resident block
against the block that has rotated s hops around the ring (`ppermute`). After nd steps every block pair has met exactly once — structurally
identical to ring attention, with descriptor blocks in place of KV blocks.

Matches are compacted to fixed-width (idx0, idx1, mask) tables *inside the
ring step* (sort-based dedupe, no scatters), so the sweep's footprint is
O(F²·max_matches) — never the O(F²·K) dense nearest-neighbor field, and
never a host-side reassembly loop.

Works identically on a CPU mesh (`--xla_force_host_platform_device_count`)
and on several GPUs.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.matching import _two_smallest, nn_to_index_pairs, pairwise_sq_dists


def _block_two_nn(d_query, d_train, vq, vt):
    """Two-NN of every query frame against every train frame in the blocks.

    d_query/d_train: (Bf, K, D); returns (m1, m2, nn) each (Bf_q, Bf_t, K).
    """

    def one(dq, vq1, dt, vt1):
        d = pairwise_sq_dists(dq, dt)
        d = jnp.where(vt1[None, :], d, jnp.inf)
        d = jnp.where(vq1[:, None], d, jnp.inf)
        return _two_smallest(d)

    return jax.vmap(
        lambda dq, vq1: jax.vmap(lambda dt, vt1: one(dq, vq1, dt, vt1))(
            d_train, vt
        )
    )(d_query, vq)


@partial(jax.jit, static_argnames=("mesh", "max_matches", "ratio"))
def ring_exhaustive_match(
    mesh: Mesh,
    desc: jnp.ndarray,    # (F, K, D) — F divisible by mesh size
    valid: jnp.ndarray,   # (F, K)
    max_matches: int,
    ratio: float = 0.75,
):
    """All-pairs ratio-test matching with ring communication and per-pair
    device-side compaction.

    Returns (idx0, idx1, mask) of global shape (nd, Bf, F, M): entry
    [s, q, t] holds the compact matches of query frame `src(s, t//Bf)·Bf + q`
    against train frame t, where src(s, d) = (d − s) mod nd is the origin of
    the block resident on device d at ring step s. idx0 indexes the train
    frame's features, idx1 the query frame's (the matcher's reversed
    query/train convention). The train axis stays sharded.
    """
    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    F, K, D = desc.shape
    Bf = F // nd

    compact = jax.vmap(
        jax.vmap(lambda n, a: nn_to_index_pairs(n, a, K, max_matches))
    )

    def body(local_desc, local_valid):
        rot_desc = local_desc
        rot_valid = local_valid
        outs = []
        for step in range(nd):
            # queries = rotating block, train = local block
            m1, m2, nn = _block_two_nn(
                rot_desc, local_desc, rot_valid, local_valid
            )
            accept = (m1 < (ratio * ratio) * m2) & jnp.isfinite(m1)
            outs.append(compact(nn.astype(jnp.int32), accept))
            if step + 1 < nd:
                perm = [(i, (i + 1) % nd) for i in range(nd)]
                rot_desc = jax.lax.ppermute(rot_desc, axis, perm)
                rot_valid = jax.lax.ppermute(rot_valid, axis, perm)
        i0 = jnp.stack([o[0] for o in outs])  # (nd, Bf_q, Bf_t, M)
        i1 = jnp.stack([o[1] for o in outs])
        mk = jnp.stack([o[2] for o in outs])
        return i0, i1, mk

    spec = P(axis)
    out_spec = P(None, None, axis)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(out_spec, out_spec, out_spec),
    )(desc.reshape(F, K, D), valid)


def ring_match_pairs(
    mesh: Mesh,
    desc: np.ndarray,
    valid: np.ndarray,
    max_matches: int,
    ratio: float = 0.75,
):
    """Host wrapper: ring sweep → compact (pair_i, pair_j, idx0, idx1, mask)
    tables for the i < j pairs, matching pad_match_table's layout."""
    F, K, _ = desc.shape
    nd = mesh.shape[mesh.axis_names[0]]
    pad = (-F) % nd
    if pad:
        desc = np.concatenate([desc, np.zeros((pad,) + desc.shape[1:], desc.dtype)])
        valid = np.concatenate([valid, np.zeros((pad, K), bool)])
    Fp = F + pad
    Bf = Fp // nd
    i0_all, i1_all, mk_all = ring_exhaustive_match(
        mesh, jnp.asarray(desc, jnp.float32), jnp.asarray(valid),
        max_matches, ratio,
    )
    pair_i, pair_j = np.triu_indices(F, k=1)
    # queries are frame j features matched into frame i (the matcher's
    # reversed query/train convention): the (j → i) result lives at ring step
    # s = (block(i) − block(j)) mod nd, query row j % Bf, train column i.
    step = (pair_i // Bf - pair_j // Bf) % nd
    i0 = jnp.asarray(i0_all)[step, pair_j % Bf, pair_i]
    i1 = jnp.asarray(i1_all)[step, pair_j % Bf, pair_i]
    mk = jnp.asarray(mk_all)[step, pair_j % Bf, pair_i]
    return (
        pair_i.astype(np.int32), pair_j.astype(np.int32),
        np.asarray(i0), np.asarray(i1), np.asarray(mk),
    )
