"""Multi-host (multi-process) distribution entry point.

The reference is single-process (SURVEY.md §5.8: no MPI/NCCL — OpenMP only);
the framework scales across hosts with `jax.distributed`: each process
drives its local devices, the mesh spans every process, and the same
`psum`/`ppermute` collectives that run over NVLink within a host run over
the network across hosts. Nothing else in the package changes — `make_mesh()` built from
`jax.devices()` (the *global* device list after initialization) makes every
sharded entry point (distributed BA, pairwise sweep, ring matcher)
multi-host transparently.

Launch recipe (per process):

    SPHERICALSFM_COORDINATOR=host0:9911 \
    SPHERICALSFM_NUM_PROCESSES=2 \
    SPHERICALSFM_PROCESS_ID=<0|1> python my_run.py

with `initialize_distributed()` called before any other JAX use. Nothing
detects a cluster here: the three env vars are required.
"""

from __future__ import annotations

import os

import jax


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Env-driven `jax.distributed.initialize` bootstrap.

    Reads SPHERICALSFM_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID when
    arguments are not given. Returns True if distributed mode was
    initialized, False when running single-process (no coordinator set) —
    callers need no branches; `jax.devices()` is correct either way.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "SPHERICALSFM_COORDINATOR"
    )
    if not coordinator_address:
        return False
    if num_processes is None:
        env = os.environ.get("SPHERICALSFM_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("SPHERICALSFM_PROCESS_ID")
        process_id = int(env) if env else None
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def process_index() -> int:
    return jax.process_index()


def is_primary() -> bool:
    """True on the process that should write artifacts/logs."""
    return jax.process_index() == 0
