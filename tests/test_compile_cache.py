"""Compile caching: captures of different length must REUSE the compiled BA
and pose-graph programs (SfMMap.optimize and the pose-graph entry points
bucket every traced axis to prevent one fresh compile per video), and the
persistent cache goes where JAX_COMPILATION_CACHE_DIR says, else to one
fixed path in the checkout."""

import os
import subprocess
import sys

import numpy as np

import jax
import jax.numpy as jnp

from sphericalsfm_tpu.geometry.pose import Intrinsics
from sphericalsfm_tpu.geometry.so3 import so3_exp
from sphericalsfm_tpu.optim import ba as B
from sphericalsfm_tpu.optim import pose_graph as PG
from sphericalsfm_tpu.pipeline.sfm import SfMMap


def _tiny_map(C, P, seed):
    rng = np.random.default_rng(seed)
    m = SfMMap(Intrinsics(jnp.asarray(500.0), jnp.asarray(160.0),
                          jnp.asarray(120.0)))
    phi = np.arange(C) * 0.1
    m.cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    m.cam_t = np.tile([0, 0, -1.0], (C, 1))
    m.rotation_fixed = np.zeros(C, bool)
    m.rotation_fixed[0] = True
    m.translation_fixed = np.ones(C, bool)
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    m.points = dirs * 7.0
    m.point_fixed = np.zeros(P, bool)
    R = np.asarray(so3_exp(jnp.asarray(m.cam_r)))
    obs_cam, obs_pt, obs_uv = [], [], []
    for i in range(C):
        px = m.points @ R[i].T + m.cam_t[i]
        for j in np.nonzero(px[:, 2] > 1)[0]:
            obs_cam.append(i)
            obs_pt.append(j)
            obs_uv.append(500 * px[j, :2] / px[j, 2])
    m.obs_cam = np.array(obs_cam, np.int32)
    m.obs_pt = np.array(obs_pt, np.int32)
    m.obs_uv = np.array(obs_uv)
    m.obs_valid = np.ones(len(obs_cam), bool)
    m.colors = np.zeros((P, 3), np.uint8)
    return m


def test_ba_shapes_bucketed_across_map_sizes():
    n0 = B._bundle_adjust_jit._cache_size()
    r1 = _tiny_map(41, 100, 0).optimize(max_iters=4, solve_dtype="float32")
    n1 = B._bundle_adjust_jit._cache_size()
    r2 = _tiny_map(44, 100, 1).optimize(max_iters=4, solve_dtype="float32")
    n2 = B._bundle_adjust_jit._cache_size()
    assert n1 - n0 >= 1
    assert n2 - n1 == 0, "same-bucket map sizes must not retrace BA"
    assert r1["final_cost"] <= r1["initial_cost"]
    assert r2["final_cost"] <= r2["initial_cost"]


def test_pose_graph_shapes_bucketed_across_sizes():
    def ring_graph(N, E_extra, seed):
        rng = np.random.default_rng(seed)
        rot_gt = np.stack(
            [np.zeros(N), np.arange(N) * 0.05, np.zeros(N)], -1)
        Rg = np.asarray(so3_exp(jnp.asarray(rot_gt)))
        ei = np.arange(N - 1, dtype=np.int32)
        ej = ei + 1
        # a few extra loop edges to vary E
        xi = rng.integers(0, N - 3, E_extra).astype(np.int32)
        ei = np.concatenate([ei, xi])
        ej = np.concatenate([ej, xi + 2])
        Rm = np.einsum("eij,ekj->eik", Rg[ej], Rg[ei])  # R_j R_iᵀ
        import sphericalsfm_tpu.geometry.so3 as s3

        r_meas = np.asarray(s3.so3_log(jnp.asarray(Rm)))
        g = PG.RotationGraph(
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(r_meas),
            jnp.ones(len(ei)),
        )
        init = rot_gt + rng.normal(size=rot_gt.shape) * 0.01
        init[0] = rot_gt[0]
        return jnp.asarray(init), g

    n0 = PG._optimize_rotations_jit._cache_size()
    rots1, c1 = PG.optimize_rotations(*ring_graph(41, 5, 0), max_iters=8)
    n1 = PG._optimize_rotations_jit._cache_size()
    rots2, c2 = PG.optimize_rotations(*ring_graph(44, 7, 1), max_iters=8)
    n2 = PG._optimize_rotations_jit._cache_size()
    assert n1 - n0 >= 1
    assert n2 - n1 == 0, "same-bucket graph sizes must not retrace"
    assert rots1.shape == (41, 3) and rots2.shape == (44, 3)
    assert float(c1) < 1e-3 and float(c2) < 1e-3


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_fresh_process(**env):
    """jax_compilation_cache_dir as a fresh interpreter sees it after
    importing the package under `env` (no backend is initialized)."""
    full = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS",
                         "SPHERICALSFM_TPU_NO_COMPILE_CACHE")}
    full.update(env, PYTHONPATH=REPO)
    code = ("import jax, sphericalsfm_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=full, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env_var(tmp_path):
    import sphericalsfm_tpu as pkg

    assert pkg._compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) is None
    assert _cache_dir_in_fresh_process(
        JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == str(tmp_path)


def test_compile_cache_defaults_to_checkout_path():
    import sphericalsfm_tpu as pkg

    fixed = os.path.join(REPO, ".jax_cache")
    assert pkg._compile_cache_dir({}) == fixed
    assert pkg._compile_cache_dir({"JAX_PLATFORMS": "cpu"}) is None
    assert pkg._compile_cache_dir(
        {"SPHERICALSFM_TPU_NO_COMPILE_CACHE": "1"}) is None
    assert _cache_dir_in_fresh_process(JAX_PLATFORMS="") == fixed
