"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sphericalsfm_tpu.eval.synthetic import make_random_problems
from sphericalsfm_tpu.eval.metrics import rotation_error_deg
from sphericalsfm_tpu.geometry import so3_exp
from sphericalsfm_tpu.parallel import (
    distributed_bundle_adjust,
    make_mesh,
    sharded_pairwise_ransac,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_sharded_pairwise_ransac_matches_single_device():
    mesh = make_mesh(8)
    P = 16
    prob = make_random_problems(
        jax.random.PRNGKey(0), batch=P, num_corr=64, rotation_deg=3.0,
        point_noise=0.5 / 600.0,
    )
    keys = jax.random.split(jax.random.PRNGKey(1), P)
    res = sharded_pairwise_ransac(
        mesh, keys, prob.u, prob.v, prob.valid,
        sq_thresh=jnp.asarray((2.0 / 600.0) ** 2), num_hypotheses=256,
    )
    errs = np.asarray(rotation_error_deg(so3_exp(res.r), prob.R))
    assert np.median(errs) < 0.2, errs
    # sharded output must cover every pair
    assert res.r.shape == (P, 3)
    assert int(jnp.sum(res.num_inliers > 32)) == P


def test_distributed_ba_matches_single_device():
    """Sharded BA must reproduce the single-device result."""
    from tests.test_ba import make_scene, build_problem
    from sphericalsfm_tpu.optim.ba import bundle_adjust

    scene = make_scene(seed=1, C=8, P=64)
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    rng = np.random.default_rng(0)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.01
    cam_r_pert[0] = cam_r[0]

    # pad observation table to a multiple of 8 for even sharding
    K = len(obs_cam)
    pad = (-K) % 8
    obs_cam = np.pad(obs_cam, (0, pad))
    obs_pt = np.pad(obs_pt, (0, pad))
    obs_uv = np.pad(obs_uv, ((0, pad), (0, 0)))
    w = np.pad(w, (0, pad))

    p = build_problem(cam_r_pert, cam_t, pts, obs_cam, obs_pt, obs_uv, w)

    res_single = bundle_adjust(p, max_iters=15)
    mesh = make_mesh(8)
    res_dist = distributed_bundle_adjust(mesh, p, max_iters=15)

    np.testing.assert_allclose(
        float(res_dist.cost), float(res_single.cost),
        rtol=1e-6, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(res_dist.cam_r), np.asarray(res_single.cam_r), atol=1e-8
    )


def test_distributed_ba_pcg_matches_single_device():
    """The matrix-free PCG camera solve must stay consistent when the
    observation/point axes are sharded across the mesh."""
    from tests.test_ba import make_scene, build_problem
    from sphericalsfm_tpu.optim.ba import bundle_adjust, sort_obs_by_camera

    scene = make_scene(seed=3, C=10, P=80)
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    rng = np.random.default_rng(4)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.01
    cam_r_pert[0] = cam_r[0]

    K = len(obs_cam)
    pad = (-K) % 8
    # pad with highest camera index so the camera-sorted order is preserved
    obs_cam = np.pad(obs_cam, (0, pad), constant_values=len(cam_r) - 1)
    obs_pt = np.pad(obs_pt, (0, pad))
    obs_uv = np.pad(obs_uv, ((0, pad), (0, 0)))
    w = np.pad(w, (0, pad))

    p = sort_obs_by_camera(
        build_problem(cam_r_pert, cam_t, pts, obs_cam, obs_pt, obs_uv, w)
    )
    res_single = bundle_adjust(p, max_iters=15, camera_solver="pcg")
    mesh = make_mesh(8)
    res_dist = distributed_bundle_adjust(
        mesh, p, max_iters=15, camera_solver="pcg",
        solve_dtype_name="float64",
    )
    np.testing.assert_allclose(
        float(res_dist.cost), float(res_single.cost), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(res_dist.cam_r), np.asarray(res_single.cam_r), atol=1e-7
    )


def test_distributed_ba_dense_pairs_matches_single_device():
    """The observation-pair dense assembly must survive sharding: pair
    tables shard along the data axis (VERDICT r2 item 5 — previously
    shard_ba_problem silently dropped them)."""
    from tests.test_ba import make_scene, build_problem
    from sphericalsfm_tpu.optim.ba import (
        build_cc_pairs, bundle_adjust, sort_obs_by_camera,
    )

    scene = make_scene(seed=5, C=12, P=96)
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    rng = np.random.default_rng(6)
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape) * 0.01
    cam_r_pert[0] = cam_r[0]

    K = len(obs_cam)
    pad = (-K) % 8
    obs_cam = np.pad(obs_cam, (0, pad), constant_values=len(cam_r) - 1)
    obs_pt = np.pad(obs_pt, (0, pad))
    obs_uv = np.pad(obs_uv, ((0, pad), (0, 0)))
    w = np.pad(w, (0, pad))

    p = build_cc_pairs(sort_obs_by_camera(
        build_problem(cam_r_pert, cam_t, pts, obs_cam, obs_pt, obs_uv, w)
    ))
    res_single = bundle_adjust(p, max_iters=12, camera_solver="dense_pairs")
    mesh = make_mesh(8)
    res_dist = distributed_bundle_adjust(
        mesh, p, max_iters=12, camera_solver="dense_pairs",
        solve_dtype_name="float64",
    )
    np.testing.assert_allclose(
        float(res_dist.cost), float(res_single.cost), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(res_dist.cam_r), np.asarray(res_single.cam_r), atol=1e-7
    )


def test_ring_matching_equals_dense():
    """Ring-sharded exhaustive matching must reproduce the single-device
    matcher over every frame pair."""
    from sphericalsfm_tpu.ops.matching import match_pairs_compact_batched
    from sphericalsfm_tpu.parallel.ring_matching import ring_match_pairs

    rng = np.random.default_rng(0)
    F, K, D = 8, 64, 128
    desc = rng.normal(size=(F, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = np.ones((F, K), bool)
    valid[:, -4:] = False

    mesh = make_mesh(8)
    pi, pj, i0, i1, mk = ring_match_pairs(mesh, desc, valid, max_matches=K)

    dj = jnp.asarray(desc)
    vj = jnp.asarray(valid)
    i0_ref, i1_ref, mk_ref = match_pairs_compact_batched(
        dj[pi], dj[pj], vj[pi], vj[pj], K, use_kernel=False
    )
    np.testing.assert_array_equal(mk, np.asarray(mk_ref))
    np.testing.assert_array_equal(i0[mk], np.asarray(i0_ref)[np.asarray(mk_ref)])
    np.testing.assert_array_equal(i1[mk], np.asarray(i1_ref)[np.asarray(mk_ref)])


def test_ring_matching_compact_scale():
    """Device-side compaction keeps the sweep at O(F²·M): a F=64, K=256
    sweep yields compact tables (the pre-compaction dense field would be
    F²·K); exactness spot-checked on a pair subset."""
    from sphericalsfm_tpu.ops.matching import match_pairs_compact_batched
    from sphericalsfm_tpu.parallel.ring_matching import ring_match_pairs

    rng = np.random.default_rng(1)
    F, K, D, M = 64, 256, 64, 128
    desc = rng.normal(size=(F, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = np.ones((F, K), bool)

    mesh = make_mesh(8)
    pi, pj, i0, i1, mk = ring_match_pairs(mesh, desc, valid, max_matches=M)
    assert i0.shape == (F * (F - 1) // 2, M)

    sel = np.arange(0, len(pi), 97)  # spot-check a spread of pairs
    dj = jnp.asarray(desc)
    vj = jnp.asarray(valid)
    i0_ref, i1_ref, mk_ref = match_pairs_compact_batched(
        dj[pi[sel]], dj[pj[sel]], vj[pi[sel]], vj[pj[sel]], M,
        use_kernel=False,
    )
    np.testing.assert_array_equal(mk[sel], np.asarray(mk_ref))
    np.testing.assert_array_equal(i0[sel][mk[sel]],
                                  np.asarray(i0_ref)[np.asarray(mk_ref)])
    np.testing.assert_array_equal(i1[sel][mk[sel]],
                                  np.asarray(i1_ref)[np.asarray(mk_ref)])


def test_sharded_retriangulate_matches_single_device():
    """Point-axis sharded retriangulation (SURVEY §2.5 P3) must reproduce
    the single-device vmapped result on the 8-way mesh."""
    from sphericalsfm_tpu.parallel import sharded_retriangulate
    from sphericalsfm_tpu.ransac.triangulation import triangulation_ransac
    from sphericalsfm_tpu.geometry import so3_exp as _exp

    rng = np.random.default_rng(3)
    P, T = 64, 8  # 64 tracks of up to 8 observations
    C = 12
    phi = np.arange(C) * 2 * np.pi / C
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    cam_t = np.tile([0, 0, -1.0], (C, 1))
    R = np.asarray(_exp(jnp.asarray(cam_r)))
    pts = rng.normal(size=(P, 3)) * [3, 1, 3] + [0, 0, 6]
    FOCAL = 600.0

    cams = np.stack([rng.choice(C, T, replace=False) for _ in range(P)])
    px = np.einsum("ptij,pj->pti", R[cams], pts) + cam_t[cams]
    uv = FOCAL * px[..., :2] / np.maximum(px[..., 2:], 0.1)
    uv += rng.normal(size=uv.shape) * 0.5
    mask = px[..., 2] > 0.5

    keys = jax.random.split(jax.random.PRNGKey(7), P)
    args = (jnp.asarray(cam_r[cams]), jnp.asarray(cam_t[cams]),
            jnp.asarray(uv), jnp.asarray(mask))

    mesh = make_mesh(8)
    res_sh = sharded_retriangulate(mesh, keys, *args, focal=FOCAL,
                                   num_hypotheses=16)

    run = jax.vmap(lambda k, a, b, c, d: triangulation_ransac(
        k, a, b, c, d, jnp.asarray(FOCAL), num_hypotheses=16))
    res_1d = run(keys, *args)

    np.testing.assert_array_equal(np.asarray(res_sh.ok), np.asarray(res_1d.ok))
    np.testing.assert_allclose(np.asarray(res_sh.X), np.asarray(res_1d.X),
                               rtol=1e-5, atol=1e-5)
    ok = np.asarray(res_sh.ok)
    assert ok.sum() > P // 2  # most tracks triangulate
    err = np.linalg.norm(np.asarray(res_sh.X)[ok] - pts[ok], axis=-1)
    assert np.median(err) < 0.1


def test_sharded_match_chunk_runs_the_kernel_under_shard_map(monkeypatch):
    """The mesh match path with the matcher kernel (as on several GPUs; here
    in Pallas interpret mode) equals the single-device plain path."""
    from sphericalsfm_tpu.ops import matching, pallas_matching
    from sphericalsfm_tpu.pipeline.frontend import _match_chunk_sharded

    kernel = pallas_matching.two_nearest_neighbors_batched
    monkeypatch.setattr(matching, "matcher_uses_kernel", lambda b: True)
    monkeypatch.setattr(pallas_matching, "two_nearest_neighbors_batched",
                        lambda *a, **k: kernel(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(3)
    F, K = 6, 136
    desc = rng.random((F, K, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    desc = np.round(desc * 512.0).astype(np.float32) / 512.0  # bf16-exact
    valid = np.ones((F, K), bool)
    valid[:, -3:] = False
    a = np.array([0, 1, 2, 3, 0, 4, 1, 5], np.int32)
    b = np.array([1, 2, 3, 4, 5, 5, 3, 0], np.int32)
    mesh = make_mesh(4)
    got = _match_chunk_sharded(mesh, jnp.asarray(desc), jnp.asarray(valid),
                               jnp.asarray(a), jnp.asarray(b),
                               max_matches=96, ratio=0.75)
    dj, vj = jnp.asarray(desc), jnp.asarray(valid)
    want = matching.match_pairs_compact_batched(
        dj[a], dj[b], vj[a], vj[b], 96, ratio=0.75, use_kernel=False)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
