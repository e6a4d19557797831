"""DOTs-SOCP-TPU: dynamic optimal transport on triangulated surfaces, in JAX.

A from-scratch JAX/XLA re-architecture of the SOCP (second-order cone
programming) reformulation of dynamic optimal transport (Benamou-Brenier) on
discrete triangulated surfaces, solved with an inexact semi-proximal augmented
Lagrangian method (iALM).

Capability parity target: chlhnu/DOTs-SOCP (reference `dot_surface_socp/__init__.py`),
re-designed for one accelerator program per chunk of iterations:

  * The per-iteration hot loop (space-time Laplacian solve, batched SOC
    projections, closed-form q/lambda step, multiplier ascent) is a single
    fused XLA computation dispatched in multi-iteration chunks.
  * The spatial Laplacian solves run as dense matmuls through a generalized
    eigendecomposition (two large GEMMs per solve) instead of per-shift sparse
    LU factorizations; a matrix-free preconditioned-CG path covers meshes too
    large for the dense spectral factor.
  * Mesh gradient/divergence operators are gathers + padded incidence-table
    reductions (no sparse matrices on device).
  * Scaling: `jax.sharding.Mesh` + NamedSharding over the state pytree; XLA
    inserts the collectives (see `dots_socp_tpu.parallel`).

Public API mirrors the reference contract:
  solver(n_time, geometry, **kw) -> (SolutionDotData, RunningHistory)
"""

__version__ = "0.1.0"

_LAZY = {
    "solver": "dots_socp_tpu.solver",
    "solver_raw": "dots_socp_tpu.solver",
    "solver_socp": "dots_socp_tpu.solver",
    "run_dot_surface": "dots_socp_tpu.interface",
    "run_dot_surface_versus_exact": "dots_socp_tpu.interface",
    "print_example_info": "dots_socp_tpu.interface",
    "set_logging_level": "dots_socp_tpu.interface",
    "parse_args": "dots_socp_tpu.cli",
}


def __getattr__(name):
    # Lazy top-level API: keeps `import dots_socp_tpu.geometry` light (no JAX
    # compile machinery pulled in for host-only use).
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "solver_socp",      # SOCP-level solver: returns SolutionSocpData
    "solver_raw",       # SOCP -> DOT units (time-staggered grid)
    "solver",           # DOT solution on the time-centered grid
    "run_dot_surface",
    "run_dot_surface_versus_exact",
    "print_example_info",
    "set_logging_level",
    "parse_args",
]
