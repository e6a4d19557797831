"""Surface calculus on device: gradient, divergence, vertex reductions.

Device replacements for the reference's SciPy sparse matrices
(`surface_pre_computations_socp.py:42-132`, applied at
`socp/solver_socp.py:898-921,1004-1025`):

  * gradient  = gather of the 3 corner values + a 3-term elementwise mul-sum
  * divergence / triangle->vertex maps = gather through a padded incidence
    table + masked sum (scatter-free: no atomics, deterministic sums)
  * cotan-Laplacian SpMV = div(area * grad), matrix-free (used by the CG
    fallback path and by tests)

All arrays live in a `SurfaceOps` NamedTuple (a pytree) passed through jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class SurfaceOps(NamedTuple):
    """Static per-problem arrays consumed by the device operators.

    tri        : (F, 3) int32   -- vertex index of corner k of triangle f
    grad_basis : (F, 3, 3)      -- gradient of hat function of corner k
    area_f     : (F,)           -- triangle areas
    av         : (V,)           -- vertex areas (one-ring area / 3)
    inc_table  : (V, D) int32   -- flat corner-slot indices f*3+k per vertex
    inc_mask   : (V, D)         -- 1.0 valid / 0.0 padding
    diag_soc   : (F, 3)         -- sqrt(area_f / av[tri[f,k]]) cone scaling
    """

    tri: jnp.ndarray
    grad_basis: jnp.ndarray
    area_f: jnp.ndarray
    av: jnp.ndarray
    inc_table: jnp.ndarray
    inc_mask: jnp.ndarray
    diag_soc: jnp.ndarray


def build_surface_ops(
    vertices: np.ndarray,
    triangles: np.ndarray,
    dtype=jnp.float32,
) -> SurfaceOps:
    """Host-side assembly of the SurfaceOps arrays (NumPy), moved to device."""
    from dots_socp_tpu.geometry.surface import (
        build_incidence_table,
        triangle_quantities,
        vertex_areas,
    )

    triangles = np.asarray(triangles)
    n_vertices = np.asarray(vertices).shape[0]
    area_f, _, grad_basis = triangle_quantities(np.asarray(vertices), triangles)
    av = vertex_areas(triangles, area_f, n_vertices) / 3.0
    table, mask = build_incidence_table(triangles, n_vertices)
    diag_soc = np.sqrt(area_f[:, None] / av[triangles])

    return SurfaceOps(
        tri=jnp.asarray(triangles, dtype=jnp.int32),
        grad_basis=jnp.asarray(grad_basis, dtype=dtype),
        area_f=jnp.asarray(area_f, dtype=dtype),
        av=jnp.asarray(av, dtype=dtype),
        inc_table=jnp.asarray(table),
        inc_mask=jnp.asarray(mask, dtype=dtype),
        diag_soc=jnp.asarray(diag_soc, dtype=dtype),
    )


def vertex_gather(ops: SurfaceOps, values, halo=None, mesh_axes=None, lead=()):
    """(..., V) vertex field -> (..., F, 3) per-corner values.

    halo / mesh_axes: when the problem is space-sharded with a blocked
    layout (`parallel.partition`), route through the shard-local halo
    implementation (`parallel.halo`); `lead` gives the PartitionSpec of the
    leading axes (e.g. ("time",) for (T, V) inputs).
    """
    if halo is not None:
        from dots_socp_tpu.parallel.halo import halo_gather

        return halo_gather(mesh_axes, halo, values, lead)
    return values[..., ops.tri]


def vertex_reduce(ops: SurfaceOps, values, halo=None, mesh_axes=None, lead=()):
    """Sum (..., F, 3) corner-slot data into vertices: (..., V).

    Adjoint of `vertex_gather`. Implemented as gather + masked sum through
    the padded incidence table (no scatter); shard-local halo variant when
    `halo` is given (see `vertex_gather`).
    """
    if halo is not None:
        from dots_socp_tpu.parallel.halo import halo_reduce

        return halo_reduce(mesh_axes, halo, ops.inc_mask, values, lead)
    flat = values.reshape(values.shape[:-2] + (-1,))
    gathered = flat[..., ops.inc_table]  # (..., V, D)
    return (gathered * ops.inc_mask).sum(-1)


def grad_space(ops: SurfaceOps, phi, halo=None, mesh_axes=None, lead=()):
    """P1 gradient: (..., V) -> (..., F, 3) tangent vectors per triangle.

    grad(phi)|_f = sum_k phi[tri[f,k]] * grad_basis[f,k].

    Written as broadcast-multiply + 3-term sum rather than einsum: the
    contraction axis is only 3 wide, so an einsum would become a dot with a
    tiny contraction that XLA fuses less well than elementwise work, and
    would inherit the global HIGHEST matmul precision for no accuracy gain
    (the elementwise sum is already full f32).
    """
    corners = vertex_gather(ops, phi, halo, mesh_axes, lead)  # (..., F, 3corner)
    return (corners[..., :, None] * ops.grad_basis).sum(axis=-2)


def div_space(ops: SurfaceOps, m, halo=None, mesh_axes=None, lead=()):
    """Divergence, the negative adjoint of grad_space under plain dot product:
    (..., F, 3) -> (..., V).

    div(m)[v] = -sum_{(f,k): tri[f,k]=v} <grad_basis[f,k], m[f]>.
    (Same elementwise mul-sum form as grad_space, for the same reason.)
    """
    contrib = -(m[..., None, :] * ops.grad_basis).sum(axis=-1)
    return vertex_reduce(ops, contrib, halo, mesh_axes, lead)


def laplacian_apply(ops: SurfaceOps, x, halo=None, mesh_axes=None, lead=()):
    """Cotan Laplacian SpMV, matrix-free: L x = div(area_f * grad(x)).

    Negative semidefinite; equals the assembled cotan matrix
    (`geometry.surface.cotan_laplacian`) applied to x.
    """
    grad = grad_space(ops, x, halo, mesh_axes, lead)
    return div_space(ops, ops.area_f[:, None] * grad, halo, mesh_axes, lead)


def triangle_mean_gather(ops: SurfaceOps, values, halo=None, mesh_axes=None, lead=()):
    """(..., V) -> (..., F): mean of the 3 corner values per triangle.

    Device equivalent of the reference's `map_decouple_space` (1/3-weighted
    vertex->triangle map, `socp/solver_socp.py:163-166`).
    """
    return vertex_gather(ops, values, halo, mesh_axes, lead).mean(axis=-1)


def weighted_vertex_reduce(ops: SurfaceOps, values):
    """Area-weighted triangle->vertex map: sum_f area_f * values[f, k] over
    incident slots (reference `map_triangle_to_vertice`,
    `socp/solver_socp.py:168`). values: (..., F, 3) -> (..., V)."""
    return vertex_reduce(ops, ops.area_f[:, None] * values)
