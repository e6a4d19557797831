"""One-time problem assembly: operators, Laplacian factor, KKT constants.

Everything here runs once per (mesh, n_time, eps, dtype) on the host, then
lives on device for the whole solve. The reference does the analogous work at
`socp/solver_socp.py:96-237` (sparse matrix assembly + SuperLU
factorizations); here it becomes SurfaceOps index tables and the spectral /
CG factor of the space-time Laplacian.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
from dots_socp_tpu.ops.laplacian import (
    CGOperator,
    SpectralFactor,
    build_cg_operator,
    build_spectral_factor,
)
from dots_socp_tpu.ops.mesh_ops import SurfaceOps, build_surface_ops
from dots_socp_tpu.utils.types import GeometryData


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Static (hashable) solver configuration; changing any field recompiles.

    n_vertices / n_triangles are the PADDED sizes (array shapes); the _real
    fields track the actual mesh for slicing results back. Padding keeps
    sharded dimensions divisible across the device mesh and lets meshes
    share bucketed shapes; dummy entries carry zero area / zero basis and
    stay identically at their fixed point (see `_pad_problem_arrays`).
    """

    n_time: int
    n_vertices: int
    n_triangles: int
    stepsize_time: float
    n_vertices_real: int = 0
    n_triangles_real: int = 0
    is_palm: bool = False
    laplacian_mode: str = "spectral"  # "spectral" | "cg"
    cg_max_iters: int = 200
    cg_rtol: float = 1e-9
    dtype: str = "float32"
    # Mixed-precision phi: state.phi is carried in float64 and the CG
    # phi-solve runs f64 iterative refinement around the f32 inner CG
    # (`ops.laplacian.cg_solve`); everything else stays in `dtype`.
    phi_refine: bool = False
    # (time, space) device-mesh axis sizes when the solve is sharded; with
    # space > 1 and a blocked layout, the incidence ops take the shard-local
    # halo path (`parallel.halo`).
    mesh_axes: Optional[tuple] = None

    def spmd_kwargs(self, data) -> dict:
        """kwargs routing the mesh ops through the halo path when active."""
        if (
            self.mesh_axes is not None
            and self.mesh_axes[1] > 1
            and data.halo is not None
        ):
            return {"halo": data.halo, "mesh_axes": self.mesh_axes}
        return {}

    @property
    def jnp_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32

    @property
    def phi_dtype(self):
        return jnp.float64 if self.phi_refine else self.jnp_dtype

    @property
    def np_dtype(self):
        import numpy as np

        return np.float64 if self.dtype == "float64" else np.float32


class ProblemData(NamedTuple):
    """Per-problem device arrays (a pytree passed through jit)."""

    ops: SurfaceOps
    spectral: Optional[SpectralFactor]
    cg_op: Optional[CGOperator]
    # Relative-KKT normalization constants (reference
    # `socp/solver_socp.py:303-313`): means of the weight arrays.
    c_prim_q: jnp.ndarray
    c_prim_z: jnp.ndarray
    c_dual_alpha: jnp.ndarray
    c_dual_beta: jnp.ndarray
    c_comp_rho: jnp.ndarray
    c_comp_m: jnp.ndarray
    # Shard-local halo-exchange tables (`parallel.halo.HaloTables`), present
    # only when the problem was built with space_partitions > 1.
    halo: Optional[tuple] = None
    # float64 SurfaceOps (shared int tables, f64 float leaves), present only
    # for space-sharded problems with phi_refine: the refinement's f64
    # true-residual matvec runs through the partitionable halo/incidence
    # form (the global ELL gather would all-gather x under GSPMD).
    ops_hi: Optional[SurfaceOps] = None


def host_device():
    """The host CPU device on which problem assembly runs, or None (the
    default device) when JAX was started without a CPU backend, as under
    JAX_PLATFORMS=cuda. Use as `jax.default_device(host_device())`."""
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def build_problem(
    n_time: int,
    geometry: GeometryData,
    eps: float = 0.0,
    is_palm: bool = False,
    laplacian_mode: str = "auto",
    max_dense_vertices: int = 16384,
    cg_max_iters: int = 200,
    cg_rtol: float = 1e-9,
    cg_deflation_k: int | None = None,
    dtype: str = "float32",
    pad_multiple: int = 1,
    space_partitions: int = 1,
    mesh_axes=None,
    phi_refine="auto",
):
    """Assemble (ProblemConfig, ProblemData) plus host-side constants.

    pad_multiple : pad the vertex and triangle counts to this multiple.
        Dummy vertices carry mean vertex area, zero density and no incident
        real triangles; dummy triangles carry zero area/basis and reference
        a dummy vertex, so the padded entries remain exactly at their fixed
        point throughout the solve. Padding serves divisibility for
        sharding over a device mesh and shape bucketing across meshes.
    space_partitions : number of space shards. With > 1, vertices and
        triangles are re-ordered into BFS-blocked per-shard chunks
        (`parallel.partition.blocked_layout`, replacing pad_multiple) and
        `data.halo` carries the shard-local exchange tables, so incidence
        gathers/reductions stay local to a device. Positions of the real
        entities are reported in extras["vertex_slot"/"triangle_slot"].
    mesh_axes : (time, space) device-mesh axis sizes, stored on the config
        to route the mesh ops (`ProblemConfig.spmd_kwargs`).
    max_dense_vertices : largest padded vertex count that takes the dense
        spectral factor. Its (V, V) eigenvector matrix costs 4 V^2 bytes in
        f32 (1 GiB at the default 16384); larger meshes take the matrix-free
        CG path. The crossover has not been raced on the GPU yet.
    phi_refine : "auto" | True | False -- mixed-precision phi (f64 state.phi
        + f64 iterative refinement around the f32 inner CG). auto enables it
        exactly where the f32 true-residual floor (~eps32/h^2) blocks
        convergence: the float32 CG path, sharded or not. A float64 CG
        solve runs plain f64 CG.

    Returns
    -------
    config : ProblemConfig
    data : ProblemData
    extras : dict with host floats {norm_constant_d, area_mesh}, NumPy
        av / area_f (real sizes), padded mu0/mu1 for state init, and the
        vertex/triangle placement maps.
    """
    vertices = np.asarray(geometry["vertices"], dtype=np.float64)
    triangles = np.asarray(geometry["triangles"])
    n_vertices = vertices.shape[0]
    n_triangles = triangles.shape[0]
    dt = 1.0 / n_time
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32

    from dots_socp_tpu.geometry.surface import (
        build_incidence_table,
        vertex_areas,
    )

    area_f, angles, grad_basis = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, n_vertices) / 3.0

    halo = None
    if space_partitions > 1:
        # Blocked shard-local layout: real entities scattered into per-shard
        # chunks (replaces pad_multiple).
        from dots_socp_tpu.parallel.halo import HaloTables
        from dots_socp_tpu.parallel.partition import blocked_layout

        layout = blocked_layout(triangles, n_vertices, space_partitions)
        v_pad = space_partitions * layout.v_chunk
        f_pad = space_partitions * layout.f_chunk
        vertex_slot = layout.vertex_slot.astype(np.int64)
        triangle_slot = layout.triangle_slot.astype(np.int64)
        tri_p = layout.tri_new.astype(np.int64)
        grad_basis_p = np.zeros((f_pad, 3, 3))
        grad_basis_p[triangle_slot] = grad_basis
        area_f_p = np.zeros(f_pad)
        area_f_p[triangle_slot] = area_f
        av_p = np.full(v_pad, av.mean() if av.size else 1.0)
        av_p[vertex_slot] = av
        table, mask = layout.inc_table, layout.inc_mask
        lap_triangles = vertex_slot[triangles]
        halo = HaloTables(
            vtx_export=jnp.asarray(layout.vtx_export),
            tri_local=jnp.asarray(layout.tri_local),
            slot_export=jnp.asarray(layout.slot_export),
            inc_local=jnp.asarray(layout.inc_local),
        )
    else:
        v_pad = _round_up(n_vertices, pad_multiple)
        f_pad = _round_up(n_triangles, pad_multiple)
        vertex_slot = np.arange(n_vertices, dtype=np.int64)
        triangle_slot = np.arange(n_triangles, dtype=np.int64)
        tri_p = np.concatenate(
            [
                triangles,
                np.full(
                    (f_pad - n_triangles, 3),
                    v_pad - 1 if v_pad > n_vertices else 0,
                ),
            ]
        ).astype(np.int64)
        grad_basis_p = np.concatenate(
            [grad_basis, np.zeros((f_pad - n_triangles, 3, 3))]
        )
        area_f_p = np.concatenate([area_f, np.zeros(f_pad - n_triangles)])
        av_p = np.concatenate(
            [av, np.full(v_pad - n_vertices, av.mean() if av.size else 1.0)]
        )
        # Incidence from REAL triangles only (dummy slots never reduced),
        # over the padded vertex range so dummy vertices get masked rows.
        table, mask = build_incidence_table(triangles, v_pad)
        lap_triangles = triangles

    diag_soc_p = np.sqrt(
        np.where(area_f_p[:, None] > 0, area_f_p[:, None], av_p[tri_p])
        / av_p[tri_p]
    )  # dummy triangles get diag 1 (avoids 0/0 in the cone step)

    from dots_socp_tpu.ops.mesh_ops import SurfaceOps

    ops = SurfaceOps(
        tri=jnp.asarray(tri_p, dtype=jnp.int32),
        grad_basis=jnp.asarray(grad_basis_p, dtype=jdtype),
        area_f=jnp.asarray(area_f_p, dtype=jdtype),
        av=jnp.asarray(av_p, dtype=jdtype),
        inc_table=jnp.asarray(table),
        inc_mask=jnp.asarray(mask, dtype=jdtype),
        diag_soc=jnp.asarray(diag_soc_p, dtype=jdtype),
    )

    lap = cotan_laplacian(lap_triangles, angles, v_pad)

    if laplacian_mode == "auto":
        laplacian_mode = "spectral" if v_pad <= max_dense_vertices else "cg"

    spectral = None
    cg_op = None
    if phi_refine in ("auto", None):
        # f32: refinement restores the f64-grade solve accuracy large-mesh
        # convergence needs -- sharded or not (the sharded path carries the
        # f64 true residual through the halo/incidence matvec). f64 keeps
        # the plain native-f64 CG.
        phi_refine = laplacian_mode == "cg" and dtype == "float32"
    elif phi_refine in ("on", "off"):
        phi_refine = phi_refine == "on"
    phi_refine = bool(phi_refine) and laplacian_mode == "cg"
    if laplacian_mode == "spectral":
        spectral = build_spectral_factor(n_time, dt, av_p, lap, eps=eps, dtype=jdtype)
    elif laplacian_mode == "cg":
        if cg_deflation_k is None:
            # Mesh-Laplacian eigenvalues grow ~linearly with index, so
            # deflating k modes cuts the Jacobi-CG condition number ~V/k:
            # scale k with the mesh (capped by the cost of the two thin
            # (T+1,V)x(V,k) preconditioner GEMMs per CG iteration).
            cg_deflation_k = int(min(256, max(64, v_pad // 256)))
        cg_op = build_cg_operator(
            n_time,
            dt,
            av_p,
            lap,
            eps=eps,
            dtype=jdtype,
            deflation_k=cg_deflation_k,
            rtol=cg_rtol,
            refine=phi_refine,
        )
    else:
        raise ValueError(f"unknown laplacian_mode: {laplacian_mode}")

    # Refinement on a space-sharded problem: the f64 true-residual matvec
    # runs through the halo/incidence form, which needs f64 float leaves
    # (f32-rounded matrix entries would cap the attainable phi accuracy at
    # ~cond * eps32 -- exactly the floor refinement exists to remove).
    # build_cg_operator(refine=True) above enabled x64, so the f64 arrays
    # hold. Int tables are shared with `ops`.
    ops_hi = None
    space_is_sharded = space_partitions > 1 or (
        mesh_axes is not None and mesh_axes[1] > 1
    )
    if phi_refine and space_is_sharded:
        ops_hi = SurfaceOps(
            tri=ops.tri,
            grad_basis=jnp.asarray(grad_basis_p, dtype=jnp.float64),
            area_f=jnp.asarray(area_f_p, dtype=jnp.float64),
            av=jnp.asarray(av_p, dtype=jnp.float64),
            inc_table=ops.inc_table,
            inc_mask=jnp.asarray(mask, dtype=jnp.float64),
            diag_soc=ops.diag_soc,
        )

    # KKT constants from the REAL mesh (padding must not bias them).
    mean_av = float(av.mean())
    mean_af = float(area_f.mean())
    scalar = lambda x: jnp.asarray(x, dtype=jdtype)

    config = ProblemConfig(
        n_time=n_time,
        n_vertices=v_pad,
        n_triangles=f_pad,
        stepsize_time=dt,
        n_vertices_real=n_vertices,
        n_triangles_real=n_triangles,
        is_palm=is_palm,
        laplacian_mode=laplacian_mode,
        cg_max_iters=cg_max_iters,
        cg_rtol=cg_rtol,
        dtype=dtype,
        mesh_axes=tuple(mesh_axes) if mesh_axes is not None else None,
        phi_refine=phi_refine,
    )
    data = ProblemData(
        ops=ops,
        spectral=spectral,
        cg_op=cg_op,
        c_prim_q=scalar((mean_av + mean_af) / 2.0),
        c_prim_z=scalar((mean_av + mean_af + mean_av) / 3.0),
        c_dual_alpha=scalar(mean_av),
        c_dual_beta=scalar((mean_av + mean_af) / 2.0),
        c_comp_rho=scalar(mean_av),
        c_comp_m=scalar(mean_af),
        halo=halo,
        ops_hi=ops_hi,
    )
    mu0 = np.zeros(v_pad)
    mu0[vertex_slot] = np.asarray(geometry["mu0"], dtype=np.float64)
    mu1 = np.zeros(v_pad)
    mu1[vertex_slot] = np.asarray(geometry["mu1"], dtype=np.float64)
    extras = {
        "area_mesh": float(area_f.sum()),
        "norm_constant_d": math.sqrt(2.0 * float(area_f.sum())),
        "av": av,
        "area_f": area_f,
        "mu0_padded": mu0,
        "mu1_padded": mu1,
        "vertex_slot": vertex_slot,
        "triangle_slot": triangle_slot,
    }
    return config, data, extras
