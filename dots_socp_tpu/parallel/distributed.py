"""Multi-process / multi-chip runtime initialization (SURVEY.md section 5.8).

The reference is single-process with no distributed backend; this module
adds one: `jax.distributed.initialize` for
multi-host runs plus a tiny mesh-shape grammar so the CLI can place the
solver on a ("time", "space") device mesh without writing Python.

Typical usage:

  single host, all local GPUs      : --mesh_shape 1x4   (or just "4")
  2 hosts x 4 GPUs, co-shard time  : --mesh_shape 2x4 --num_processes 2
                                     --process_id {0,1}
                                     --coordinator_address host0:1234

Every process runs the same program; `jax.devices()` sees the global device
set after initialization and the GSPMD partitioner inserts the collectives
(psum over KKT/norm reductions, all-gathers for the spectral time transform,
halo exchanges for the space-sharded incidence ops).
"""

from __future__ import annotations

import logging
import os

import jax

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    With all arguments None, relies on auto-detection from the cluster
    environment (COORDINATOR_ADDRESS / SLURM / Open MPI env vars), which is
    a no-op on a single host. Explicit arguments follow
    `jax.distributed.initialize` semantics.
    """
    global _initialized
    if _initialized:
        return
    explicit = coordinator_address is not None or num_processes is not None
    auto_env = any(
        key in os.environ
        for key in (
            "COORDINATOR_ADDRESS",
            "SLURM_JOB_ID",
            "OMPI_COMM_WORLD_SIZE",
        )
    )
    if not explicit and not auto_env:
        return  # single-process run; nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    logging.info(
        "Distributed runtime up: process %d/%d, %d local + %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """Parse a --mesh_shape string into (time, space) axis sizes.

    Grammar: "TxS" (e.g. "2x4") or a bare device count "S" meaning pure
    spatial sharding ("1xS"). Sizes must be positive.
    """
    text = str(spec).strip().lower()
    parts = text.split("x")
    if len(parts) == 1:
        sizes = (1, int(parts[0]))
    elif len(parts) == 2:
        sizes = (int(parts[0]), int(parts[1]))
    else:
        raise ValueError(f"mesh_shape must be 'TxS' or 'S', got {spec!r}")
    if min(sizes) < 1:
        raise ValueError(f"mesh_shape sizes must be positive, got {spec!r}")
    return sizes


def make_solver_mesh(mesh_shape: str | tuple[int, int]):
    """Build the solver's ("time", "space") Mesh from a shape spec.

    Accepts the CLI string form or an already-parsed (time, space) tuple;
    the product must not exceed the available global device count.
    """
    from dots_socp_tpu.parallel.mesh import make_mesh

    if isinstance(mesh_shape, str):
        time_axis, space_axis = parse_mesh_shape(mesh_shape)
    else:
        time_axis, space_axis = map(int, mesh_shape)
    n_devices = time_axis * space_axis
    available = jax.device_count()
    if n_devices > available:
        raise ValueError(
            f"mesh_shape {time_axis}x{space_axis} needs {n_devices} devices; "
            f"only {available} are available"
        )
    return make_mesh(n_devices, time_axis=time_axis)
