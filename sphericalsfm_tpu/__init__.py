"""sphericalsfm_tpu — a spherical structure-from-motion framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jonathanventura/spherical-sfm (C++/Ceres/OpenCV): structure-from-motion for
spherically-constrained camera motion (camera on a sphere, optical axis normal
to the surface), including

* minimal spherical essential-matrix solvers (3-pt; 5-pt/6-pt comparisons),
* batched vmapped LO-RANSAC,
* rotation averaging with loop closure,
* uncalibrated shared-focal pose-graph optimization (ICCV 2025),
* RANSAC triangulation and Levenberg-Marquardt bundle adjustment with
  Schur-complement elimination,
* feature detection/matching, COLMAP/OBJ/NeRF interop, and stereo-panorama
  synthesis.

Everything on the compute path is batched, functional, static-shape JAX,
sharded over a `jax.sharding.Mesh` when several devices are given.

Design reference (capabilities only, re-designed for accelerators):
/root/reference (jonathanventura/spherical-sfm @ 2025-11-14).
"""

import os as _os

import jax as _jax

# Geometry kernels (minimal solvers, normal equations) default to float64:
# the CPU parity tests and offline pipelines want it. The accelerator entry
# points (chip_smoke.py, bench.py, __graft_entry__.py) run the float32/int32
# regime instead by setting SPHERICALSFM_TPU_X64=0 before importing the
# package.
if _os.environ.get("SPHERICALSFM_TPU_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

_CHECKOUT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _compile_cache_dir(environ) -> str | None:
    """Where this package points JAX's persistent compilation cache, or
    None to leave JAX's own setting alone.

    The pipeline's kernels are shape-stable across runs, and first compiles
    dominate cold runs. JAX reads JAX_COMPILATION_CACHE_DIR itself, so when
    it is set nothing is set here. Otherwise the cache sits at one fixed,
    git-ignored path in the checkout (the path is part of the cache key, so
    it must not move). Opt out with SPHERICALSFM_TPU_NO_COMPILE_CACHE=1. Not
    used for CPU backends: XLA:CPU entries pin host machine features and can
    SIGILL when loaded under a different feature set.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if environ.get("SPHERICALSFM_TPU_NO_COMPILE_CACHE", "0") == "1":
        return None
    if "cpu" in environ.get("JAX_PLATFORMS", ""):
        return None
    return _CHECKOUT_CACHE


_cache = _compile_cache_dir(_os.environ)
if _cache is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"
