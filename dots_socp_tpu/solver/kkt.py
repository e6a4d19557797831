"""All seven relative KKT residuals, fused into one device computation.

The reference evaluates these lazily through a circular-queue validator with
early exit (`utils/condition_validator.py`,`socp/solver_socp.py:589-652`) --
worthwhile when each residual costs a fresh pass of NumPy temporaries. Fused
into one device computation, all seven together cost a few state-sized
passes (not measured on the GPU yet), and validation runs only
every `interval` iterations (adaptive cadence, host side), so we always
compute the full dual-valued set:

  column 0: error in ORIGINAL units  (reference's `org_kkt_errors`)
  column 1: error in SCALED units    (reference's `kkt_errors`); rows 4-6
            carry NaN (the reference reports None there).

Residual definitions follow `socp/solver_socp.py:433-559` exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dots_socp_tpu.ops.mesh_ops import (
    div_space,
    triangle_mean_gather,
    vertex_reduce,
)
from dots_socp_tpu.ops.time_stencils import (
    decouple_space,
    decouple_space_adjoint,
    div_time,
    time_center_adjoint,
)
from dots_socp_tpu.solver.problem import ProblemConfig, ProblemData
from dots_socp_tpu.solver.state import SolverState


def _norms(config: ProblemConfig, data: ProblemData):
    av = data.ops.av
    area_f = data.ops.area_f
    T = config.n_time

    def nst(a):  # (T, V), weight av, averaged over T slices
        return jnp.einsum("tv,v->", a * a, av) / T

    def nsc(a):  # (T+1, V), weight av, averaged over T+1 slices
        return jnp.einsum("tv,v->", a * a, av) / (T + 1)

    def nss(a):  # (T+1, F, 3), weight area_f, averaged over T+1
        return jnp.einsum("tfc,f->", a * a, area_f) / (T + 1)

    def nsd(a):  # (T, 2, F, 3, 3), weight area_f, averaged over T
        return jnp.einsum("tefkc,f->", a * a, area_f) / T

    return nst, nsc, nss, nsd


def kkt_table(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Return the (7, 2) KKT error table [original, scaled] (traceable;
    composed into the chunk dispatch by `step.run_chunk_kkt`)."""
    ops = data.ops
    spmd = config.spmd_kwargs(data)
    dt = config.stepsize_time
    nst, nsc, nss, nsd = _norms(config, data)
    s = state

    def dual_valued(resi, const, norm_sum, scale):
        return jnp.stack([resi / (const / scale + norm_sum), resi / (const + norm_sum)])

    # --- 0: primal feasibility (phi, q) -------------------------------------
    resi_mu = s.dt_phi - s.A - s.lambda_c
    resi_e = s.dx_phi - s.B
    norm_sum = (
        jnp.sqrt(nst(s.dt_phi) + nss(s.dx_phi))
        + jnp.sqrt(nst(s.A) + nss(s.B))
        + jnp.sqrt(nst(s.lambda_c))
    )
    prim_resi = jnp.sqrt(nst(resi_mu) + nss(resi_e))
    kkt0 = dual_valued(prim_resi, data.c_prim_q, norm_sum, s.prim_scale)

    # --- 1: primal feasibility (q, z) ---------------------------------------
    dec_b = decouple_space(s.B, s.scale_z)
    r_fst = s.z_fst + s.scale_z * s.A - s.constant_d
    r_mid = s.scale_z * (s.z_mid - dec_b)
    r_end = s.z_end - s.scale_z * s.A - s.constant_d
    prim_resi_z = jnp.sqrt(nst(r_fst) + nst(r_end) + nsd(r_mid))
    kkt1 = dual_valued(prim_resi_z, data.c_prim_z, s.norm_constant_d, s.prim_scale)

    # --- 2: dual feasibility (alpha) ----------------------------------------
    dual_aux = (s.r * dt) * (
        s.boundary
        + div_time(dt, s.mu * ops.av[None, :])
        + div_space(ops, s.E * ops.area_f[None, :, None], lead=(None,), **spmd)
    ) / ops.av[None, :]
    dual_resi = jnp.sqrt(nsc(dual_aux))
    kkt2 = dual_valued(dual_resi, data.c_dual_alpha, s.norm_boundary, s.dual_scale)

    # --- 3: dual feasibility (beta) -----------------------------------------
    aux1 = s.scale_z * (s.beta_end - s.beta_fst)
    aux2 = decouple_space_adjoint(s.beta_mid, s.scale_z)
    norm_sum3 = s.r * (
        jnp.sqrt(nst(s.mu) + nss(s.E)) + jnp.sqrt(nst(aux1) + nss(aux2))
    )
    resi3 = s.r * jnp.sqrt(nst(s.mu + aux1) + nss(s.E + aux2))
    kkt3 = dual_valued(resi3, data.c_dual_beta, norm_sum3, s.dual_scale)

    # --- 4: complementarity (rho, f(q)) -- original units only --------------
    mu_o = (s.dual_scale * s.r) * s.mu
    a_o = s.prim_scale * s.A
    b_o = s.prim_scale * s.B
    dec_b1 = decouple_space(b_o, 1.0)
    sq = (dec_b1 * dec_b1).sum(axis=(1, 4))  # (T, F, 3corner)
    resi_aux = a_o + 0.25 * vertex_reduce(
        ops, ops.area_f[:, None] * sq, lead=("time",), **spmd
    ) / ops.av[None, :]
    norm_sum4 = jnp.sqrt(nst(mu_o)) + jnp.sqrt(nst(resi_aux))
    proj_gap = jnp.maximum(0.0, resi_aux + mu_o) - mu_o
    resi4 = jnp.sqrt(nst(proj_gap))
    kkt4 = jnp.stack([resi4 / (data.c_comp_rho + norm_sum4), jnp.nan])

    # --- 5: complementarity (m, rho o B) -- original units only -------------
    m_o = (s.dual_scale * s.r) * s.E
    rho_adj = time_center_adjoint(mu_o)  # (T+1, V)
    rho_tri = triangle_mean_gather(ops, rho_adj, lead=(None,), **spmd)
    aux5 = rho_tri[:, :, None] * b_o
    norm_sum5 = jnp.sqrt(nss(m_o)) + jnp.sqrt(nss(aux5))
    resi5 = jnp.sqrt(nss(aux5 - m_o))
    kkt5 = jnp.stack([resi5 / (data.c_comp_m + norm_sum5), jnp.nan])

    # --- 6: complementarity (rho, congestion) -- original units only --------
    lam_o = s.prim_scale * s.lambda_c
    norm_sum6 = jnp.sqrt(nst(mu_o)) + jnp.sqrt(nst(lam_o))
    resi6 = jnp.sqrt(nst(s.congestion * mu_o - lam_o))
    kkt6 = jnp.stack([resi6 / (data.c_comp_rho + norm_sum6), jnp.nan])

    return jnp.stack([kkt0, kkt1, kkt2, kkt3, kkt4, kkt5, kkt6])


#: Standalone jitted entry (tests, final validation outside a chunk).
compute_kkt = partial(jax.jit, static_argnums=0)(kkt_table)


@partial(jax.jit, static_argnums=0)
def objective_functional(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Transport cost and Lagrangian value in original units
    (reference `solver_socp.py:417-431,773-774`)."""
    nst, _, _, _ = _norms(config, data)
    dt = config.stepsize_time
    phi = state.prim_scale * state.phi
    boundary = (state.dual_scale * state.r) * state.boundary
    trans_cost = dt * (
        jnp.vdot(phi[0], boundary[0]) + jnp.vdot(phi[-1], boundary[-1])
    )
    congestion_orig = state.congestion * state.prim_scale / state.dual_scale
    lam = state.prim_scale * state.lambda_c
    penalty = jnp.where(
        congestion_orig > 1e-10,
        1.0 / (2.0 * jnp.maximum(congestion_orig, 1e-10)) * nst(lam),
        0.0,
    )
    return trans_cost, trans_cost - penalty
