"""Pure-JAX device operators: mesh calculus, time stencils, cones, Laplacian.

Every function here is traceable (no data-dependent Python control flow) and
composes into the single fused iALM iteration in `dots_socp_tpu.solver.step`.

Importing this package configures two JAX defaults for the solver's compute
path (each overridable by setting the env var before import):

* ``jax_default_matmul_precision`` -> ``DOTS_SOCP_TPU_MATMUL_PRECISION``
  (default "highest"; "keep" leaves JAX's default). On the GPU, JAX's
  default runs float32 matmuls in TF32, which keeps ~3 decimal digits; this
  is a KKT-driven solver that stops at relative errors of 1e-4 and below,
  so full-f32 products are the correct default, not a tuning knob.
  `chip_smoke.py` measures what TF32 does to the spectral phi solve.
* ``jax_compilation_cache_dir`` -> ``JAX_COMPILATION_CACHE_DIR``, or, when
  that is unset, the fixed directory ``output/jax_cache`` inside the
  checkout (`output/` is git-ignored). The fused iteration and KKT graphs
  take tens of seconds to compile; the persistent cache lets every rerun of
  the CLI / replication harness start hot. The path is part of the cache
  key, so it must not move between runs.
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

_prec = _os.environ.get("DOTS_SOCP_TPU_MATMUL_PRECISION", "highest")
if _prec != "keep":
    _jax.config.update("jax_default_matmul_precision", _prec)

if getattr(_jax.config, "jax_compilation_cache_dir", None) is None:
    # JAX reads JAX_COMPILATION_CACHE_DIR itself; unset, a fixed path.
    _cache_dir = str(
        _Path(__file__).resolve().parents[2] / "output" / "jax_cache"
    )
    try:
        _os.makedirs(_cache_dir, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    except OSError:
        pass

from dots_socp_tpu.ops.mesh_ops import (
    SurfaceOps,
    build_surface_ops,
    grad_space,
    div_space,
    vertex_reduce,
    vertex_gather,
    laplacian_apply,
)
from dots_socp_tpu.ops.time_stencils import (
    grad_time,
    div_time,
    time_center_adjoint,
    decouple_space,
    decouple_space_adjoint,
)
from dots_socp_tpu.ops.cones import project_soc
from dots_socp_tpu.ops.laplacian import (
    SpectralFactor,
    build_spectral_factor,
    spectral_solve,
    build_time_laplacian,
)

__all__ = [
    "SurfaceOps",
    "build_surface_ops",
    "grad_space",
    "div_space",
    "vertex_reduce",
    "vertex_gather",
    "laplacian_apply",
    "grad_time",
    "div_time",
    "time_center_adjoint",
    "decouple_space",
    "decouple_space_adjoint",
    "project_soc",
    "SpectralFactor",
    "build_spectral_factor",
    "spectral_solve",
    "build_time_laplacian",
]
