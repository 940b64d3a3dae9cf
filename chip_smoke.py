"""Smoke run of the reconstruction pipeline on the GPU.

Drives the library entry points a user calls (`run_calibrated`,
`run_uncalibrated`, `make_stereo_panoramas`, `bundle_adjust`) once each, in
one process, at the PhoneSweep stand-in sizes (100-250 VGA frames,
EVAL_SUITE.md) and the package's default 4000-keypoint budget. Every input
is generated from a seed during set-up (`eval.render.render_capture`,
`eval.synthetic`). Each phase prints one JSON line with its gate values,
its seconds and the device's peak memory; a failed gate raises. The last
line is `{"ok": true, "device": {...}}`.

    python chip_smoke.py              # one card: device, matcher,
                                      # calibrated, uncalibrated, panorama,
                                      # ba_pcg
    python chip_smoke.py --devices 4  # four cards: the multi-device path
                                      # against one card, nothing else

Without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
from functools import partial

import numpy as np

RATIO = 0.75
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class GateFailed(RuntimeError):
    pass


def gate(name: str, ok: bool, value) -> None:
    if not ok:
        raise GateFailed(f"gate {name} failed: {value!r}")


def _peak_bytes():
    import jax

    stats = [d.memory_stats() or {} for d in jax.local_devices()]
    peaks = [s["peak_bytes_in_use"] for s in stats if "peak_bytes_in_use" in s]
    return max(peaks) if peaks else None


def emit(phase: str, t0: float, **fields) -> dict:
    rec = {"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
           **fields, "peak_bytes_in_use": _peak_bytes()}
    print(json.dumps(rec), flush=True)
    return rec


class CompileCounter:
    """Counts XLA backend compilations while active (JAX monitoring)."""

    def __init__(self):
        self.count = 0

    def _on(self, event, duration_secs, **kwargs):
        if event == COMPILE_EVENT:
            self.count += 1

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._on)


def _centers(cam_r, cam_t):
    from sphericalsfm_tpu.geometry.so3 import np_so3_exp

    R = np_so3_exp(np.asarray(cam_r, np.float64))
    return -np.einsum("cji,cj->ci", R, np.asarray(cam_t, np.float64))


def _ate(m, cam_r_gt, cam_t_gt) -> float:
    import jax.numpy as jnp

    from sphericalsfm_tpu.eval.metrics import ate

    return float(ate(jnp.asarray(_centers(m.cam_r, m.cam_t)),
                     jnp.asarray(_centers(cam_r_gt, cam_t_gt))))


def sift_like(rng, shape):
    """L2-normalized, non-negative descriptors on the 1/512 grid SIFT
    descriptors are stored on (uint8 ×512). On that grid every f32 inner
    product and norm is exact, so two f32 matchers agree bit for bit."""
    d = rng.random(shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.round(d * 512.0).astype(np.float32) / np.float32(512.0)


def matcher_inputs(rng, B: int, K: int):
    """B pairs: half the queries are noisy copies of train rows (a real
    nearest neighbour), half are unrelated; the last 7 train rows are
    invalid, so the padding/validity path is exercised."""
    d0 = sift_like(rng, (B, K, 128))
    half = K // 2
    d1 = np.empty_like(d0)
    for b in range(B):
        src = rng.permutation(K)[:half]
        noisy = d0[b, src] + rng.normal(size=(half, 128)).astype(
            np.float32) * 0.02
        d1[b, :half] = np.abs(noisy)
    d1[:, half:] = rng.random((B, K - half, 128))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d1 = np.round(d1 * 512.0).astype(np.float32) / np.float32(512.0)
    v0 = np.ones((B, K), bool)
    v0[:, -7:] = False
    return d0, d1, v0, np.ones((B, K), bool)


# ---------------------------------------------------------------- phases


def phase_device(expect_count: int) -> dict:
    """Refuse to run anywhere but on the GPU, and name the card."""
    import jax

    from sphericalsfm_tpu.ops.matching import matcher_uses_kernel

    t0 = time.perf_counter()
    devs = jax.devices()
    if devs[0].platform != "gpu" or jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devs[0]} "
                         f"(backend {jax.default_backend()})")
    if len(devs) < expect_count:
        raise SystemExit(f"need {expect_count} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    gate("matcher_uses_kernel", matcher_uses_kernel(jax.default_backend()),
         jax.default_backend())
    return emit("device", t0, kind=devs[0].device_kind, count=len(devs),
                nvidia_smi=smi.splitlines())


# Worst-case |Δd²| when unit-norm, non-negative descriptors are rounded to
# bf16 (unit roundoff u = 2^-8) before an f32-accumulated product:
# |Δip| ≤ 2u + u², doubled in d² = 2 − 2·ip. The capture check needs it:
# on 32k real detector queries the largest |Δm1| reached 0.00998.
BF16_D2_BOUND = 2 * (2 * 2.0 ** -8 + 2.0 ** -16)


def _agreement(name, kernel_out, ref_out, ratio=RATIO, dtol=1e-2) -> dict:
    """Kernel against the f32 reference on one batch: nearest-neighbour
    index agreement on the queries either side accepts at `ratio`, and the
    largest |Δm1|, |Δm2|. Gated at ≥ 0.999 and ≤ `dtol`; the default 1e-2
    is the typical bf16 error (~4e-3 on a unit-norm inner product, doubled
    in d² = 2 − 2·ip), which bounds inputs on SIFT's 1/512 grid, where
    bf16 is exact."""
    m1k, m2k, nnk = map(np.asarray, kernel_out)
    m1r, m2r, nnr = map(np.asarray, ref_out)
    r2 = ratio * ratio
    acc_k = (m1k < r2 * m2k) & np.isfinite(m1k)
    acc_r = (m1r < r2 * m2r) & np.isfinite(m1r)
    either = acc_k | acc_r
    f1, f2 = np.isfinite(m1r), np.isfinite(m2r)
    rec = dict(accepted=int(acc_r.sum()),
               nn_agreement=float((nnk[either] == nnr[either]).mean()),
               max_abs_dm1=float(np.abs(m1k[f1] - m1r[f1]).max()),
               max_abs_dm2=float(np.abs(m2k[f2] - m2r[f2]).max()))
    gate(f"{name}_nn_agreement", rec["nn_agreement"] >= 0.999, rec)
    gate(f"{name}_dm1", rec["max_abs_dm1"] <= dtol, rec)
    gate(f"{name}_dm2", rec["max_abs_dm2"] <= dtol, rec)
    return rec


def phase_matcher(pairs: int = 16, ks=(4096, 4000), time_pairs: int = 32,
                  time_k: int = 4000, reps: int = 7, interpret: bool = False,
                  seed: int = 0) -> dict:
    """The production matcher (streaming kernel, bf16 inputs, f32
    accumulation) against the plain f32 reference at HIGHEST, then both
    implementations timed at the calibrated phase's chunk shape with the
    same bf16/f32 precision."""
    import jax

    from sphericalsfm_tpu.ops.matching import two_nn_plain
    from sphericalsfm_tpu.ops.pallas_matching import (
        two_nearest_neighbors_batched,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    kernel = jax.jit(lambda a, b, va, vb: two_nearest_neighbors_batched(
        a, b, va, vb, interpret=interpret))
    plain_f32 = jax.jit(two_nn_plain)
    plain_bf16 = jax.jit(lambda a, b, va, vb: two_nn_plain(
        a, b, va, vb, compute_dtype="bfloat16"))
    checks = {}
    for K in ks:
        args = [jax.device_put(x) for x in matcher_inputs(rng, pairs, K)]
        checks[K] = _agreement(f"K{K}", kernel(*args), plain_f32(*args))
        gate(f"K{K}_accepted", checks[K]["accepted"] >= 0.25 * pairs * K,
             checks[K])

    args = [jax.device_put(x)
            for x in matcher_inputs(rng, time_pairs, time_k)]
    times = {"kernel": [], "xla": []}
    fns = {"kernel": kernel, "xla": plain_bf16}
    for fn in fns.values():
        jax.block_until_ready(fn(*args))  # compile + warm
    for _ in range(reps):
        for name, fn in fns.items():
            t = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times[name].append(time.perf_counter() - t)
    us = {f"{k}_us_per_pair": statistics.median(v) * 1e6 / time_pairs
          for k, v in times.items()}
    return emit("matcher", t0, checks=checks, interpret=interpret,
                time_shape=[time_pairs, time_k], reps=reps, **us)


def _render(frames, focal, width, height, seed=7):
    from sphericalsfm_tpu.eval.render import render_capture

    return render_capture(num_frames=frames, arc=1.0, focal=focal,
                          width=width, height=height, seed=seed,
                          wave_freq=25.0 * width / 320.0)


def _read_stages(out_dir):
    with open(os.path.join(out_dir, "stages.jsonl")) as f:
        return {r["stage"]: r["seconds"] for r in map(json.loads, f)}


def phase_calibrated(out_root: str, frames: int = 120, width: int = 640,
                     height: int = 480, focal: float = 512.0, cfg=None,
                     compare_matchers: bool = True) -> dict:
    """run_calibrated twice on a rendered outward circle (default
    FrontendConfig: exhaustive matching, 4000 keypoints), the second run
    warm and compile-free; then the warm match_pairs stage with each
    matcher implementation."""
    import jax.numpy as jnp

    from sphericalsfm_tpu.config import PipelineConfig
    from sphericalsfm_tpu.geometry.pose import Intrinsics
    from sphericalsfm_tpu.pipeline.driver import run_calibrated

    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = _render(frames, focal, width, height)
    setup_s = time.perf_counter() - t0
    if cfg is None:
        cfg = PipelineConfig()
        cfg.ba.solve_dtype = "float32"
    intr = Intrinsics(jnp.asarray(focal), jnp.asarray(width / 2.0),
                      jnp.asarray(height / 2.0))
    cold_dir = os.path.join(out_root, "calibrated_cold")
    warm_dir = os.path.join(out_root, "calibrated_warm")
    t = time.perf_counter()
    m_cold = run_calibrated(None, intr, cold_dir, cfg, gray=gray, color=color)
    cold_s = time.perf_counter() - t
    with CompileCounter() as cc:
        t = time.perf_counter()
        m = run_calibrated(None, intr, warm_dir, cfg, gray=gray, color=color)
        warm_s = time.perf_counter() - t
    ate_cold = _ate(m_cold, cam_r, cam_t)
    ate_warm = _ate(m, cam_r, cam_t)
    fields = dict(frames=frames, size=[width, height], setup_s=setup_s,
                  cold_s=cold_s, warm_s=warm_s, warm_compiles=cc.count,
                  ate_cold=ate_cold, ate_warm=ate_warm,
                  warm_stage_seconds=_read_stages(warm_dir))
    if compare_matchers:
        fields["match_sweep_s"] = _match_stage(gray, color, cfg)
    rec = emit("calibrated", t0, **fields)
    gate("calibrated_ate_cold", ate_cold < 0.05, ate_cold)
    gate("calibrated_ate_warm", ate_warm < 0.05, ate_warm)
    gate("calibrated_warm_compiles", cc.count == 0, cc.count)
    rec.update(gray=gray, color=color, poses=os.path.join(warm_dir,
                                                          "poses.txt"))
    return rec


def _match_stage(gray, color, cfg, check_pairs: int = 16, chunk: int = 32,
                 reps: int = 3, interpret: bool = False) -> dict:
    """The matcher on the capture's own detector descriptors, which are
    full precision, so bf16 rounds them: the kernel against the f32
    reference on `check_pairs` pairs, then the capture's whole pair sweep
    (the driver's 32-pair chunks, ratio test and compaction) with the
    kernel and with the plain path at the same bf16/f32 precision (median
    of `reps`, alternating)."""
    import jax
    import jax.numpy as jnp

    from sphericalsfm_tpu.ops.matching import nn_to_index_pairs, two_nn_plain
    from sphericalsfm_tpu.ops.pallas_matching import (
        two_nearest_neighbors_batched,
    )
    from sphericalsfm_tpu.pipeline.frontend import detect_features
    from sphericalsfm_tpu.pipeline.pairwise import all_pairs

    kernel = partial(two_nearest_neighbors_batched, interpret=interpret)
    feats = detect_features(gray, color, cfg.frontend)
    desc, valid = feats.descriptor_dev, feats.valid_dev
    pi, pj = all_pairs(len(gray))
    sel = np.linspace(0, len(pi) - 1, check_pairs).astype(int)
    a, b = jnp.asarray(pi[sel]), jnp.asarray(pj[sel])
    args = (desc[a], desc[b], valid[a], valid[b])
    check = _agreement("capture", jax.jit(kernel)(*args),
                       jax.jit(two_nn_plain)(*args), cfg.frontend.match_ratio,
                       dtol=BF16_D2_BOUND)

    M, r2 = cfg.frontend.max_matches_per_pair, cfg.frontend.match_ratio ** 2

    def sweep(two_nn):
        @jax.jit
        def one(desc, valid, a, b):
            m1, m2, nn = two_nn(desc[a], desc[b], valid[a], valid[b])
            ok = (m1 < r2 * m2) & valid[b] & jnp.isfinite(m1)
            return jax.vmap(lambda n, o: nn_to_index_pairs(
                n, o, desc.shape[1], M))(nn, ok)
        return one

    pad = -len(pi) % chunk
    ci = jnp.asarray(np.concatenate([pi, np.zeros(pad, pi.dtype)]))
    cj = jnp.asarray(np.concatenate([pj, np.zeros(pad, pj.dtype)]))
    ci, cj = ci.reshape(-1, chunk), cj.reshape(-1, chunk)
    fns = {"kernel": sweep(kernel),
           "xla_bf16": sweep(lambda *x: two_nn_plain(
               *x, compute_dtype="bfloat16"))}
    times = {k: [] for k in fns}
    for _ in range(reps + 1):  # the first round compiles and warms
        for name, fn in fns.items():
            t = time.perf_counter()
            jax.block_until_ready([fn(desc, valid, ci[c], cj[c])
                                   for c in range(ci.shape[0])])
            times[name].append(time.perf_counter() - t)
    return {"pairs": len(pi), "capture_check": check,
            **{k: statistics.median(v[1:]) for k, v in times.items()}}


def phase_uncalibrated(out_root: str, frames: int = 100, width: int = 640,
                       height: int = 480, focal: float = 400.0,
                       cfg=None) -> dict:
    """run_uncalibrated on a rendered circle whose true focal (400) is off
    the (W+H)/2 = 560 guess: windows matching, default focal search,
    general BA."""
    from sphericalsfm_tpu.config import PipelineConfig
    from sphericalsfm_tpu.pipeline.driver import run_uncalibrated

    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = _render(frames, focal, width, height, seed=17)
    setup_s = time.perf_counter() - t0
    if cfg is None:
        cfg = PipelineConfig()
        cfg.ba.solve_dtype = "float32"
        cfg.frontend.matching = "windows"
        cfg.general_ba = True
    out = os.path.join(out_root, "uncalibrated")
    t = time.perf_counter()
    m, f_est = run_uncalibrated(None, out, cfg, gray=gray, color=color)
    run_s = time.perf_counter() - t
    ferr = abs(f_est - focal) / focal
    err = _ate(m, cam_r, cam_t)
    rec = emit("uncalibrated", t0, frames=frames, setup_s=setup_s,
               run_s=run_s, focal_true=focal, focal_est=f_est,
               focal_rel_err=ferr, ate=err,
               stage_seconds=_read_stages(out))
    gate("uncalibrated_focal", ferr < 0.02, ferr)
    gate("uncalibrated_ate", err < 0.05, err)
    return rec


def phase_panorama(out_root: str, poses: str, color, focal: float,
                   **kw) -> dict:
    """make_stereo_panoramas on the calibrated phase's reconstruction at
    the CasualStereo defaults (nphi 9): flow + column synthesis."""
    from sphericalsfm_tpu.pipeline.stereo_panorama import make_stereo_panoramas

    t0 = time.perf_counter()
    H, W = color.shape[1:3]
    sph = make_stereo_panoramas(poses, color, (focal, W / 2.0, H / 2.0),
                                os.path.join(out_root, "panorama"), **kw)
    # A synthesized column is written whole, so a filled panorama column
    # shows in the spherical remap too.
    fill = [float((p.sum(axis=(0, 2)) > 0).mean()) for p in sph]
    mid = fill[len(fill) // 2]
    rec = emit("panorama", t0, panoramas=len(sph), width=sph[0].shape[1],
               fill_fraction=fill)
    gate("panorama_fill", mid > 0.8, mid)
    return rec


# Reached cost of 10 (5) f32 LM iterations on the ring scenes, against the
# same problem solved in f64 on the CPU at BAConfig's PCG settings (25
# iterations, rtol 1e-2) — the value each key maps to. Measured f32 runs
# land within 0.4% of it: 0.02% on one H100, 0.2-0.4% on CPUs of two hosts
# and on 4 virtual CPU devices (summation order). The 1% gate leaves room
# for that drift; the defect it guards against (a segment-sum precision
# loss that left the one-card solve at 3.6x the reference) is far outside.
BA_PCG_REFERENCE = {(2000, 520, 131072, 10): 157879.39752829107,
                    (600, 80, 12000, 5): 5744.09427656082}
BA_PCG_RTOL = 1e-2


def _ba_pcg_scene(C, W, P):
    from sphericalsfm_tpu.eval.synthetic import make_ring_scene

    return make_ring_scene(C=C, W=W, P=P)


def phase_ba_pcg(C: int = 2000, W: int = 520, P: int = 131072,
                 iters: int = 10) -> dict:
    """The 2000-camera / ~1.04M-observation ring scene through
    prepare_problem("auto") — which picks PCG above 512 cameras — for
    `iters` LM iterations in f32, gated against the f64 reference cost."""
    from sphericalsfm_tpu.config import BAConfig
    from sphericalsfm_tpu.optim.ba import bundle_adjust, prepare_problem

    ref = BA_PCG_REFERENCE[(C, W, P, iters)]
    t0 = time.perf_counter()
    prob = _ba_pcg_scene(C, W, P)
    obs = int(np.count_nonzero(np.asarray(prob.obs_w)))
    prob, solver = prepare_problem(prob, "auto")
    setup_s = time.perf_counter() - t0
    bc = BAConfig()
    t = time.perf_counter()
    res = bundle_adjust(prob, max_iters=iters, camera_solver=solver,
                        solve_dtype_name="float32", pcg_rtol=bc.pcg_rtol,
                        pcg_iters=bc.pcg_iters)
    c0, c1, it = float(res.initial_cost), float(res.cost), int(res.iterations)
    rel = abs(c1 - ref) / ref
    rec = emit("ba_pcg", t0, cameras=C, observations=obs, solver=solver,
               setup_s=setup_s, solve_s=time.perf_counter() - t,
               iterations=it, initial_cost=c0, final_cost=c1,
               reference_cost=ref, rel_diff_reference=rel,
               rtol=BA_PCG_RTOL)
    gate("ba_pcg_solver", C <= 512 or solver == "pcg", solver)
    gate("ba_pcg_finite", np.isfinite(c1), c1)
    gate("ba_pcg_decrease", it >= 1 and c1 < c0, (c0, c1, it))
    gate("ba_pcg_reference", rel <= BA_PCG_RTOL, (c1, ref, rel))
    return rec


# ------------------------------------------------------- four devices


def phase_multi_calibrated(out_root: str, n: int, frames: int = 64,
                           width: int = 640, height: int = 480,
                           focal: float = 512.0, cfg_fn=None) -> dict:
    """(a) run_calibrated with cfg.devices = n against cfg.devices = 0."""
    import jax.numpy as jnp

    from sphericalsfm_tpu.config import PipelineConfig
    from sphericalsfm_tpu.geometry.pose import Intrinsics
    from sphericalsfm_tpu.pipeline.driver import run_calibrated

    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = _render(frames, focal, width, height)
    intr = Intrinsics(jnp.asarray(focal), jnp.asarray(width / 2.0),
                      jnp.asarray(height / 2.0))
    ates, secs = {}, {}
    for devs in (0, n):
        cfg = cfg_fn() if cfg_fn else PipelineConfig()
        cfg.ba.solve_dtype = "float32"
        cfg.devices = devs
        t = time.perf_counter()
        m = run_calibrated(None, intr, os.path.join(out_root, f"mc_{devs}"),
                           cfg, gray=gray, color=color)
        secs[devs] = time.perf_counter() - t
        ates[devs] = _ate(m, cam_r, cam_t)
    d = abs(ates[n] - ates[0])
    rec = emit("multi_calibrated", t0, frames=frames, ate_single=ates[0],
               ate_mesh=ates[n], ate_diff=d, single_s=secs[0],
               mesh_s=secs[n])
    gate("multi_ate_single", ates[0] < 0.05, ates[0])
    gate("multi_ate_mesh", ates[n] < 0.05, ates[n])
    gate("multi_ate_diff", d < 0.02, d)
    return rec


# Relative reached-cost tolerance of n-shard against one-device f32 BA. The
# shards sum the reduced camera system in another order (psum of partial
# sums). The exact dense_pairs solve turns that into last-bit differences
# (3e-7 on four H100s, 1e-6 on 4 virtual CPU devices). The inexact f32 PCG
# solve turns them into slightly different LM steps: 0.17% apart on the
# 2000-camera ring and 0.23% on the 600-camera one on 4 virtual CPU
# devices, at BAConfig's PCG settings. The gate allows 4x the larger.
BA_PARITY_RTOL = {"dense_pairs": 1e-3, "pcg": 1e-2}


def phase_multi_ba(n: int, ring=(2000, 520, 131072), iters: int = 10) -> dict:
    """(b) distributed_bundle_adjust against single-device bundle_adjust
    at the same iteration counts: dense_pairs on the 64-camera scene, pcg on
    the ring scene at BAConfig's PCG settings; plus where the sharded
    observation arrays live."""
    from sphericalsfm_tpu.config import BAConfig
    from sphericalsfm_tpu.eval.synthetic import make_bench_scene
    from sphericalsfm_tpu.optim.ba import bundle_adjust, prepare_problem
    from sphericalsfm_tpu.parallel.sharded import (
        distributed_bundle_adjust, make_mesh, shard_ba_problem,
    )

    t0 = time.perf_counter()
    mesh = make_mesh(n)
    bc = BAConfig()
    out = {}
    for name, prob, kw in (
            ("dense_pairs", make_bench_scene(),
             dict(camera_solver="dense_pairs")),
            ("pcg", _ba_pcg_scene(*ring),
             dict(camera_solver="pcg", pcg_iters=bc.pcg_iters,
                  pcg_rtol=bc.pcg_rtol))):
        kw.update(max_iters=iters, solve_dtype_name="float32")
        single = bundle_adjust(prob, **kw)
        multi = distributed_bundle_adjust(mesh, prob, **kw)
        c1, cn = float(single.cost), float(multi.cost)
        placed = shard_ba_problem(
            mesh, prepare_problem(prob, kw["camera_solver"])[0])
        out[name] = dict(
            initial_cost=float(single.initial_cost), cost_single=c1,
            cost_mesh=cn, rel_diff=abs(cn - c1) / c1,
            iters_single=int(single.iterations),
            iters_mesh=int(multi.iterations),
            obs_devices=sorted(d.id for d in placed.obs_uv.sharding.device_set),
            obs_shard_rows=[s.data.shape[0]
                            for s in placed.obs_uv.addressable_shards],
        )
    rec = emit("multi_ba", t0, rtol=BA_PARITY_RTOL, **out)
    for name, r in out.items():
        gate(f"multi_ba_{name}_cost", r["rel_diff"] <= BA_PARITY_RTOL[name],
             r)
        gate(f"multi_ba_{name}_placement",
             len(r["obs_devices"]) == n
             and len(set(r["obs_shard_rows"])) == 1, r)
    return rec


def phase_multi_ring(n: int, frames: int = 32, K: int = 4000,
                     max_matches: int = 1024, seed: int = 1) -> dict:
    """(c) ring_match_pairs on the mesh against the single-device batched
    matcher, both f32: the accepted index sets must be identical."""
    import jax.numpy as jnp

    from sphericalsfm_tpu.ops.matching import match_pairs_compact_batched
    from sphericalsfm_tpu.parallel.ring_matching import ring_match_pairs
    from sphericalsfm_tpu.parallel.sharded import make_mesh

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    pool = sift_like(rng, (2 * K, 128))
    desc = np.empty((frames, K, 128), np.float32)
    for f in range(frames):  # each frame sees half the pool, re-quantized
        d = np.abs(pool[rng.permutation(2 * K)[:K]]
                   + rng.normal(size=(K, 128)).astype(np.float32) * 0.01)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        desc[f] = np.round(d * 512.0) / np.float32(512.0)
    valid = np.ones((frames, K), bool)
    valid[:, -5:] = False
    pi, pj, i0, i1, mk = ring_match_pairs(make_mesh(n), desc, valid,
                                          max_matches=max_matches)
    dj, vj = jnp.asarray(desc), jnp.asarray(valid)
    ref = []
    for s in range(0, len(pi), 64):
        sl = slice(s, s + 64)
        ref.append(tuple(map(np.asarray, match_pairs_compact_batched(
            dj[pi[sl]], dj[pj[sl]], vj[pi[sl]], vj[pj[sl]], max_matches,
            use_kernel=False))))
    r0, r1, rm = (np.concatenate(x) for x in zip(*ref))

    def triples(a, b, m):  # (pair, train feature, query feature)
        return set(zip(np.nonzero(m)[0].tolist(), a[m].tolist(),
                       b[m].tolist()))

    got, want = triples(i0, i1, mk), triples(r0, r1, rm)
    rec = emit("multi_ring", t0, frames=frames, keypoints=K, pairs=len(pi),
               matches_mesh=len(got), matches_single=len(want),
               symmetric_difference=len(got ^ want))
    gate("multi_ring_identical", got == want, len(got ^ want))
    gate("multi_ring_nonempty", len(want) > 0, len(want))
    return rec


# ----------------------------------------------------------------- main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device path and its "
                         "single-device comparison")
    args = ap.parse_args(argv)

    # The accelerator regime: float32/int32 arrays, f32 BA solves.
    os.environ["SPHERICALSFM_TPU_X64"] = "0"
    import jax

    import sphericalsfm_tpu  # noqa: F401

    phase_device(args.devices)
    print(json.dumps({"phase": "regime", "x64": bool(
        jax.config.jax_enable_x64), "ba_solve_dtype": "float32",
        "matcher": "pallas triton kernel, bf16 inputs, f32 accumulation",
        "compile_cache": jax.config.jax_compilation_cache_dir}), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
        if args.devices == 1:
            phase_matcher()
            cal = phase_calibrated(out_root)
            phase_uncalibrated(out_root)
            phase_panorama(out_root, cal["poses"], cal["color"], 512.0)
            phase_ba_pcg()
        else:
            phase_multi_calibrated(out_root, args.devices)
            phase_multi_ba(args.devices)
            phase_multi_ring(args.devices)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
