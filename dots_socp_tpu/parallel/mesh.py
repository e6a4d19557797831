"""Device mesh construction and sharding specs for the solver state.

Sharding layout (the CP/SP-equivalent design from SURVEY.md section 5.7):

  * "time"  axis: the staggered time grid. All cone/multiplier state is
    pointwise in t; time stencils need one-slice halo exchanges; the
    spectral time transform is a small (T+1)x(T+1) einsum (all-gather
    along time).
  * "space" axis: mesh vertices/triangles. The vertex<->triangle gathers
    and the (V, V) spectral GEMMs shard over this axis.

Everything is expressed as NamedShardings on the pytrees; jit + GSPMD
inserts the actual collectives. Works unchanged from 1 device to a
multi-host slice (jax.distributed.initialize upstream of make_mesh).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dots_socp_tpu.ops.laplacian import CGOperator, SpectralFactor
from dots_socp_tpu.ops.mesh_ops import SurfaceOps
from dots_socp_tpu.solver.problem import ProblemData
from dots_socp_tpu.solver.state import SolverState


def make_mesh(n_devices: int | None = None, time_axis: int | None = None) -> Mesh:
    """Build a ("time", "space") mesh over the first n_devices devices.

    time_axis: size of the time dimension of the mesh (default: 1, i.e.
    pure spatial sharding; pass >1 to co-shard the time grid).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if time_axis is None:
        time_axis = 1
    if n_devices % time_axis != 0:
        raise ValueError(f"{n_devices} devices not divisible by time_axis={time_axis}")
    grid = devices.reshape(time_axis, n_devices // time_axis)
    return Mesh(grid, ("time", "space"))


def state_shardings(mesh: Mesh) -> SolverState:
    """NamedSharding per SolverState field (scalars replicated)."""
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    rep = NamedSharding(mesh, P())
    # Staggered (T, ...) arrays co-shard time + space; centered (T+1, ...)
    # arrays shard space only (T and T+1 cannot both divide the time axis).
    tv_stag = s("time", "space")        # (T, V)
    tv_cent = s(None, "space")          # (T+1, V)
    tf3 = s(None, "space", None)        # (T+1, F, 3)
    mid = s("time", None, "space", None, None)  # (T, 2, F, 3, 3)
    return SolverState(
        phi=tv_cent,
        A=tv_stag,
        B=tf3,
        lambda_c=tv_stag,
        z_fst=tv_stag,
        z_mid=mid,
        z_end=tv_stag,
        mu=tv_stag,
        E=tf3,
        beta_fst=tv_stag,
        beta_mid=mid,
        beta_end=tv_stag,
        dt_phi=tv_stag,
        dx_phi=tf3,
        boundary=tv_cent,
        r=rep,
        congestion=rep,
        constant_d=rep,
        norm_constant_d=rep,
        norm_boundary=rep,
        prim_scale=rep,
        dual_scale=rep,
        scale_z=rep,
        tau=rep,
        eps=rep,
    )


def problem_shardings(mesh: Mesh, data: ProblemData) -> ProblemData:
    """NamedSharding per ProblemData field."""
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    rep = NamedSharding(mesh, P())

    ops = SurfaceOps(
        tri=s("space", None),
        grad_basis=s("space", None, None),
        area_f=s("space"),
        av=s("space"),
        inc_table=s("space", None),
        inc_mask=s("space", None),
        diag_soc=s("space", None),
    )
    # The f64 refinement ops (present on sharded phi_refine problems) carry
    # the same layout as the work-precision ops.
    ops_hi = ops if data.ops_hi is not None else None
    spectral = None
    if data.spectral is not None:
        spectral = SpectralFactor(
            u_time=rep,
            s=s("space"),
            # Contraction over Q's rows is local per space shard + psum;
            # the eigen-index dim aligns with "space" for the second GEMM.
            q=s("space", None),
            invfac=s(None, "space"),
        )
    cg_op = None
    if data.cg_op is not None:
        opt = lambda leaf, sh: sh if leaf is not None else None
        cg_op = CGOperator(
            shifts=rep,
            jacobi=s(None, "space"),
            null_row=rep,
            u_time=rep,
            av_unit=s("space"),
            s=s("space"),
            # Thin-GEMM contraction over V is local per space shard + psum.
            defl_q=s("space", None),
            defl_winv=rep,
            rtol=rep,
            # ELL SpMV operands: row-blocked over space; the neighbor
            # gather reaches across shards, which GSPMD resolves with an
            # all-gather of x (the blocked-layout/halo path avoids this).
            ell_idx=s("space", None),
            ell_w=s("space", None),
            # f64 refinement leaves (present when phi_refine engaged).
            ell_w_hi=opt(data.cg_op.ell_w_hi, s("space", None)),
            av_hi=opt(data.cg_op.av_hi, s("space")),
            shifts_hi=opt(data.cg_op.shifts_hi, rep),
            u_time_hi=opt(data.cg_op.u_time_hi, rep),
            real_mask=opt(data.cg_op.real_mask, s("space")),
        )
    halo = None
    if data.halo is not None:
        from dots_socp_tpu.parallel.halo import HaloTables

        halo = HaloTables(
            vtx_export=s("space", None),
            tri_local=s("space", None),
            slot_export=s("space", None),
            inc_local=s("space", None),
        )
    return ProblemData(
        ops=ops,
        spectral=spectral,
        cg_op=cg_op,
        c_prim_q=rep,
        c_prim_z=rep,
        c_dual_alpha=rep,
        c_dual_beta=rep,
        c_comp_rho=rep,
        c_comp_m=rep,
        halo=halo,
        ops_hi=ops_hi,
    )


def shard_state(mesh: Mesh, state: SolverState) -> SolverState:
    """device_put the state with its shardings."""
    return jax.device_put(state, state_shardings(mesh))


def shard_problem(mesh: Mesh, data: ProblemData) -> ProblemData:
    """device_put the problem arrays with their shardings."""
    return jax.device_put(data, problem_shardings(mesh, data))
