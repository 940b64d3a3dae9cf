"""Multi-chip sharding of the SfM pipeline over a jax.sharding.Mesh.

The reference is a single-process OpenMP program (SURVEY.md §2.5); its
parallel axes map onto a device mesh as:

  image pairs / RANSAC hypotheses → `data` axis (embarrassingly parallel;
      shard_map with zero collectives)
  BA observations and points      → `data` axis, cameras replicated; the
      reduced camera system is assembled locally per shard and `psum`-reduced
      across devices, the dense camera solve is replicated, and point
      back-substitution stays local to each shard
  focal hypotheses                → `data` axis (one vmap, sharded)

Everything works on a CPU mesh (`--xla_force_host_platform_device_count`)
for testing and on several GPUs unchanged. The mesh is 1-D and follows the
algorithm alone: the cards of a host reach each other all to all over
NVLink, so device order does not matter.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..optim.ba import BAProblem
from ..ransac.spherical import spherical_ransac


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devs)} devices are "
            f"visible (set XLA_FLAGS=--xla_force_host_platform_device_count "
            f"for a virtual CPU mesh)"
        )
    return Mesh(np.asarray(devs[:n]), (axis,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 over the mesh's (single) data axis."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_sharded(mesh: Mesh, *arrays):
    """device_put each array with axis 0 sharded over the mesh.

    The production chunk dispatchers (pipeline/{frontend,pairwise,sfm}.py)
    lay their fixed-shape chunk inputs out with this before calling the same
    module-level jitted kernels the single-device path uses — GSPMD
    partitions the vmapped per-item work along the data axis (the chunk
    sizes are multiples of the mesh size by construction).
    """
    spec = data_sharding(mesh)
    out = tuple(jax.device_put(a, spec) for a in arrays)
    return out[0] if len(out) == 1 else out


@partial(jax.jit, static_argnames=("mesh", "max_keypoints", "num_octaves"))
def sharded_detect(mesh, images, max_keypoints: int, num_octaves: int):
    """Frame-axis sharded DoG/SIFT detection (SURVEY.md §2.5 P1): the
    batched detection kernel under shard_map on the data axis — each device
    detects its resident block of frames, zero collectives. Replaces the
    per-frame OpenMP loop of the reference's detect_features
    (spherical_sfm_tools.cpp:271-307) with the mesh layout the survey names.

    images: (F, H, W) with F divisible by the mesh size.
    """
    from ..ops.features import detect_and_describe

    axis = mesh.axis_names[0]

    def body(imgs):
        return jax.vmap(
            lambda im: detect_and_describe(im, max_keypoints, num_octaves)
        )(imgs)

    return jax.shard_map(
        body, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis)
    )(images)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def sharded_pairwise_ransac(
    mesh: Mesh,
    keys: jax.Array,        # (P,) PRNG keys
    u: jnp.ndarray,         # (P, N, 3)
    v: jnp.ndarray,
    mask: jnp.ndarray,      # (P, N)
    sq_thresh,
    num_hypotheses: int = 512,
    inward: bool = False,
):
    """All image pairs across the mesh's data axis — no collectives needed.

    P must be a multiple of the mesh size (pad with masked pairs).
    """
    axis = mesh.axis_names[0]
    spec = NamedSharding(mesh, P(axis))

    def run(k, uu, vv, mm):
        return spherical_ransac(
            k, uu, vv, mm, sq_thresh=sq_thresh,
            num_hypotheses=num_hypotheses, inward=inward,
        )

    fn = jax.jit(
        jax.vmap(run),
        in_shardings=(spec, spec, spec, spec),
    )
    return fn(
        jax.device_put(keys, spec),
        jax.device_put(u, spec),
        jax.device_put(v, spec),
        jax.device_put(mask, spec),
    )


def sharded_retriangulate(
    mesh: Mesh,
    keys: jax.Array,        # (P,) PRNG keys, one per track
    rs: jnp.ndarray,        # (P, T, 3) per-track camera axis-angles
    ts: jnp.ndarray,        # (P, T, 3)
    uv: jnp.ndarray,        # (P, T, 2)
    mask: jnp.ndarray,      # (P, T) observation validity
    focal,
    sq_thresh: float = 4.0,
    num_hypotheses: int = 32,
):
    """Retriangulate every track with the point axis sharded over the mesh
    (SURVEY §2.5 P3: the reference's per-point `cv::parallel_for_` in
    sfm.cpp:156-192 maps to the data axis here). Embarrassingly parallel —
    zero collectives; each device RANSACs its slice of the track table.

    P must be a multiple of the mesh size (pad with mask=False tracks;
    `pad_to_multiple` on every array, fill False for mask).
    """
    from ..ransac.triangulation import triangulation_ransac

    axis = mesh.axis_names[0]
    spec = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    fn = jax.jit(
        jax.vmap(
            lambda k, a, b, c, d, f: triangulation_ransac(
                k, a, b, c, d, f, sq_thresh=sq_thresh,
                num_hypotheses=num_hypotheses,
            ),
            in_axes=(0, 0, 0, 0, 0, None),
        ),
        in_shardings=(spec, spec, spec, spec, spec, rep),
    )
    return fn(
        jax.device_put(keys, spec),
        jax.device_put(rs, spec),
        jax.device_put(ts, spec),
        jax.device_put(uv, spec),
        jax.device_put(mask, spec),
        jax.device_put(jnp.asarray(focal), rep),
    )


def shard_ba_problem(mesh: Mesh, p: BAProblem) -> BAProblem:
    """Lay a BAProblem out on the mesh: observations and points sharded on
    the data axis, cameras and scalars replicated.

    Note: obs/track tables must already be padded to multiples of the mesh
    size (use pad_to_multiple with obs_w/track_mask zero fills).
    """
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return BAProblem(
        focal=jax.device_put(p.focal, rep),
        cam_t=jax.device_put(p.cam_t, rep),
        cam_r=jax.device_put(p.cam_r, rep),
        points=jax.device_put(p.points, sh),
        obs_cam=jax.device_put(p.obs_cam, sh),
        obs_pt=jax.device_put(p.obs_pt, sh),
        obs_uv=jax.device_put(p.obs_uv, sh),
        obs_w=jax.device_put(p.obs_w, sh),
        track_obs=jax.device_put(p.track_obs, sh),
        track_mask=jax.device_put(p.track_mask, sh),
        focal_fixed=jax.device_put(p.focal_fixed, rep),
        rot_fixed=jax.device_put(p.rot_fixed, rep),
        trans_fixed=jax.device_put(p.trans_fixed, rep),
        point_fixed=jax.device_put(p.point_fixed, sh),
        cam_ptr=(
            None if p.cam_ptr is None else jax.device_put(p.cam_ptr, rep)
        ),
        pt_order=(
            None if p.pt_order is None else jax.device_put(p.pt_order, sh)
        ),
        pt_ptr=(
            None if p.pt_ptr is None else jax.device_put(p.pt_ptr, rep)
        ),
        # dense_pairs tables: the pair axis shards like the observations it
        # indexes (GSPMD turns the U/Hpp_inv gathers into cross-shard
        # collectives); the C²+1 segment bounds replicate like cam_ptr.
        cc_pair_a=(
            None if p.cc_pair_a is None else jax.device_put(p.cc_pair_a, sh)
        ),
        cc_pair_b=(
            None if p.cc_pair_b is None else jax.device_put(p.cc_pair_b, sh)
        ),
        cc_ptr=(
            None if p.cc_ptr is None else jax.device_put(p.cc_ptr, rep)
        ),
    )


def distributed_bundle_adjust(
    mesh: Mesh,
    p: BAProblem,
    max_iters: int = 10,
    solve_dtype_name: str = "float32",
    camera_solver: str = "dense",
    pcg_iters: int = 200,
    pcg_rtol: float = 1e-8,
):
    """Bundle adjustment with mesh-sharded observations/points.

    GSPMD partitions the per-observation Jacobian work and the per-point
    Schur blocks along `data`; the reduced camera system is assembled with
    cross-shard reductions (XLA inserts the psum) and solved replicated —
    dense Cholesky or (camera_solver="pcg") the matrix-free CG solve, whose
    per-iteration segment sums and gathers also partition along `data`.
    "dense_pairs" shards the observation-pair tables the same way (the pair
    gathers become cross-shard collectives), and "auto" resolves host-side
    exactly like the single-chip entry point before layout.
    """
    from ..optim.ba import bundle_adjust, prepare_problem

    # Resolve "auto" and build sort/pair indices on the host FIRST — the
    # prep fetches arrays, so it must not run on an already-sharded problem.
    p, camera_solver = prepare_problem(p, camera_solver)
    p_sharded = shard_ba_problem(mesh, p)
    with mesh:
        return bundle_adjust(
            p_sharded, max_iters=max_iters, solve_dtype_name=solve_dtype_name,
            camera_solver=camera_solver, pcg_iters=pcg_iters,
            pcg_rtol=pcg_rtol,
        )
