"""Test configuration: a virtual 8-device CPU mesh unless told otherwise.

Multi-device sharding tests run against `--xla_force_host_platform_device_count`
CPU devices standing in for several cards (SURVEY.md §4). The tests marked
`gpu` need a card; they skip on the CPU and run on the GPU with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# The driver/panorama/multihost e2e tests dominate the suite's wall time
# (rendered captures through the full pipeline). They are auto-marked
# `slow` so `pytest -m "not slow"` is the quick iteration tier; the full
# pyramid still runs by default.
_SLOW_MODULES = {
    "test_driver", "test_panorama", "test_multihost", "test_colmap_driver",
    "test_driver_mesh", "test_chip_smoke_rehearsal",
}
_SLOW_NAMES = ("pipeline_to_evaluator",)


def pytest_collection_modifyitems(items):
    for item in items:
        mod = item.module.__name__ if item.module else ""
        if mod in _SLOW_MODULES or any(s in item.name for s in _SLOW_NAMES):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_compile_cache():
    """Clear JAX's in-process caches after every test module.

    A monolithic `pytest tests/` run accumulates ~140 tests' worth of
    compiled executables across 8 virtual devices in one process; round 4's
    full run died ~29 min in with a fatal native error during a BA pjit
    compile (VERDICT r4 weak #5). Dropping the compilation cache at module
    boundaries bounds the per-process footprint; recompiles within a module
    are unaffected."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip. Decided when the test runs — never while
    modules are imported or collected, so every xdist worker collects the
    same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests -m gpu")
    return jax.devices()[0]
