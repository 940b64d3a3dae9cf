"""Track building and view-graph hygiene — host-side graph bookkeeping.

Capability parity with the reference's
* build_sfm track construction (/root/reference/examples/
  spherical_sfm_tools.cpp:886-950): union matched features across pairs into
  tracks, with track merging when a feature already belongs to a point;
* find_largest_connected_component (:736-792);
* filter_image_matches triplet rotation-cycle filter (:1031-1082).

These are tiny pointer-chasing jobs (thousands of nodes), deliberately kept
on the host: a union-find in C (native/graph.cpp, loaded via ctypes, with
this numpy fallback) feeds the static-shape observation tables that the
device kernels consume. No reason to spend device launches on them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..geometry.so3 import rotation_angle, so3_exp

try:
    from ..native import graph as _native
except Exception:  # pragma: no cover - native lib optional
    _native = None


class UnionFind:
    """Path-compressing union-find over a fixed universe."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x):
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class Tracks(NamedTuple):
    """Static-shape observation tables for the device kernels."""

    num_points: int
    obs_cam: np.ndarray    # (K,) frame index
    obs_feat: np.ndarray   # (K,) feature index within frame
    obs_pt: np.ndarray     # (K,) track (point) id
    track_len: np.ndarray  # (num_points,)


def build_feature_tracks(
    num_frames: int,
    num_feats: np.ndarray,     # (F,) features per frame
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    idx0: np.ndarray,          # (P, Nmax)
    idx1: np.ndarray,
    inlier_mask: np.ndarray,   # (P, Nmax)
) -> Tracks:
    """Union inlier matches into tracks.

    Node id = frame_offset[f] + feature. Matching the reference's semantics:
    connecting two features that already belong to different tracks merges
    the tracks (MergePoint, spherical_sfm_tools.cpp:917-947).
    """
    offsets = np.zeros(num_frames + 1, np.int64)
    offsets[1:] = np.cumsum(num_feats)
    total = int(offsets[-1])

    ii = inlier_mask.nonzero()
    a = offsets[pair_i[ii[0]]] + idx0[ii]
    b = offsets[pair_j[ii[0]]] + idx1[ii]

    if _native is not None:
        roots = _native.union_find(total, a.astype(np.int64), b.astype(np.int64))
    else:
        uf = UnionFind(total)
        for x, y in zip(a, b):
            uf.union(int(x), int(y))
        roots = np.array([uf.find(i) for i in range(total)], np.int64)

    # Only nodes that participate in ≥1 match become observations.
    touched = np.zeros(total, bool)
    touched[a] = True
    touched[b] = True
    nodes = np.nonzero(touched)[0]
    node_roots = roots[nodes]
    uniq, pt_ids = np.unique(node_roots, return_inverse=True)

    obs_cam = np.searchsorted(offsets, nodes, side="right").astype(np.int32) - 1
    obs_feat = (nodes - offsets[obs_cam]).astype(np.int32)
    obs_pt = pt_ids.astype(np.int32)

    # A track may acquire two features of the same frame through merging; the
    # reference keeps whichever observation wrote last (std::map assignment).
    # Keep the first occurrence per (frame, track).
    order = np.lexsort((obs_feat, obs_cam, obs_pt))
    oc, of, op = obs_cam[order], obs_feat[order], obs_pt[order]
    first = np.ones(len(order), bool)
    first[1:] = (oc[1:] != oc[:-1]) | (op[1:] != op[:-1])
    oc, of, op = oc[first], of[first], op[first]

    track_len = np.bincount(op, minlength=len(uniq))
    return Tracks(
        num_points=len(uniq),
        obs_cam=oc, obs_feat=of, obs_pt=op,
        track_len=track_len,
    )


def largest_connected_component(
    num_frames: int, pair_i: np.ndarray, pair_j: np.ndarray, keep: np.ndarray
):
    """Frames of the largest connected component of the kept-pair graph.

    Returns (frame_ids ascending, old->new index map (−1 outside)).
    Reference: find_largest_connected_component (Boost connected_components).
    """
    uf = UnionFind(num_frames)
    for i, j in zip(pair_i[keep], pair_j[keep]):
        uf.union(int(i), int(j))
    roots = np.array([uf.find(i) for i in range(num_frames)])
    vals, counts = np.unique(roots, return_counts=True)
    big = vals[np.argmax(counts)]
    frames = np.nonzero(roots == big)[0]
    remap = np.full(num_frames, -1, np.int64)
    remap[frames] = np.arange(len(frames))
    return frames, remap


def filter_triplet_cycles(
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    r_rel: np.ndarray,       # (P, 3) relative rotations
    keep: np.ndarray,        # (P,) bool, updated copy returned
    thresh_deg: float = 2.0,
):
    """Drop edges violating triplet rotation cycle consistency
    ‖log(R_ij·R_jk·R_ik^T)‖ < thresh (reference filter_image_matches,
    spherical_sfm_tools.cpp:1031-1082).

    An edge survives if it participates in at least one consistent triplet
    (edges in no triplet are kept).
    """
    keep = keep.copy()
    R_all = np.asarray(so3_exp(np.asarray(r_rel)), np.float64)
    if _native is not None and len(pair_i):
        return _native.triplet_filter(
            int(max(pair_i.max(), pair_j.max())) + 1,
            pair_i, pair_j, R_all, np.deg2rad(thresh_deg), keep,
        )
    idx = {}
    for p in np.nonzero(keep)[0]:
        idx[(int(pair_i[p]), int(pair_j[p]))] = p
    from ..geometry.so3 import np_so3_exp

    R = np_so3_exp(np.asarray(r_rel, np.float64))

    import collections

    neighbors = collections.defaultdict(set)
    for (i, j) in idx:
        neighbors[i].add(j)
        neighbors[j].add(i)

    in_triplet = collections.defaultdict(bool)
    consistent = collections.defaultdict(bool)
    thresh = np.deg2rad(thresh_deg)
    for (i, j), p_ij in idx.items():
        for k in neighbors[i] & neighbors[j]:
            a, b, c = sorted((i, j, k))
            p_ab = idx.get((a, b))
            p_bc = idx.get((b, c))
            p_ac = idx.get((a, c))
            if p_ab is None or p_bc is None or p_ac is None:
                continue
            cycle = R[p_bc] @ R[p_ab] @ R[p_ac].T
            err = float(np.arccos(np.clip(
                (np.trace(cycle) - 1.0) * 0.5, -1.0, 1.0)))
            for p in (p_ab, p_bc, p_ac):
                in_triplet[p] = True
                if err < thresh:
                    consistent[p] = True
    for p in np.nonzero(keep)[0]:
        if in_triplet[p] and not consistent[p]:
            keep[p] = False
    return keep
