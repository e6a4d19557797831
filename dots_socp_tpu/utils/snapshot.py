"""Periodic on-disk snapshot / resume of the solver state.

The reference's only resume mechanism is the in-memory warm start
(`socp/solver_socp.py:38,239-250`); large-mesh runs are long-lived, so this adds
a crash-safe periodic snapshot of the full state pytree *plus* the host-side
schedule state (sigma cadence, adaptive-KKT cadence, converged mask), so a
resumed run continues the exact trajectory instead of restarting schedules.

Format: a single .npz (atomic rename on write). All device arrays are
fetched with one `jax.device_get` per snapshot; scalars of the host
schedule travel in a small JSON-encoded side field.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

SNAPSHOT_VERSION = 1

#: SolverState array fields, in NamedTuple order.
_STATE_FIELDS = (
    "phi", "A", "B", "lambda_c", "z_fst", "z_mid", "z_end",
    "mu", "E", "beta_fst", "beta_mid", "beta_end",
    "dt_phi", "dx_phi", "boundary",
    "r", "congestion", "constant_d", "norm_constant_d", "norm_boundary",
    "prim_scale", "dual_scale", "scale_z", "tau", "eps",
)


def save_snapshot(path: str, state, host_meta: dict) -> None:
    """Atomically write `state` (SolverState) and host schedule metadata."""
    import jax

    arrays = {f: np.asarray(a) for f, a in zip(_STATE_FIELDS, jax.device_get(tuple(state)))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"version": SNAPSHOT_VERSION, **host_meta}).encode(), dtype=np.uint8
    )
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_snapshot(path: str):
    """Return (state_arrays: dict[str, np.ndarray], host_meta: dict)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {meta.get('version')} != {SNAPSHOT_VERSION}"
            )
        arrays = {f: data[f] for f in _STATE_FIELDS}
    return arrays, meta


def state_from_arrays(arrays: dict, dtype, phi_dtype=None):
    """Rebuild a SolverState from saved arrays (cast to the run dtype;
    `phi` to phi_dtype when given -- mixed-precision refinement carries it
    in float64)."""
    import jax.numpy as jnp

    from dots_socp_tpu.solver.state import SolverState

    return SolverState(
        **{
            f: jnp.asarray(
                arrays[f],
                dtype=phi_dtype if f == "phi" and phi_dtype is not None else dtype,
            )
            for f in _STATE_FIELDS
        }
    )
