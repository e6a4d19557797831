"""The solver state pytree.

Everything the iALM iteration reads *and* writes lives here, including the
scalars the reference mutates in place through its scaling machinery
(`socp/solver_socp.py:324-412`): carrying them as 0-d arrays keeps every
schedule event (sigma updates, rescalings) from triggering recompilation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class SolverState(NamedTuple):
    """Primal/dual state + scaling scalars.

    Shapes: T = n_time, V vertices, F triangles. The decoupled cone arrays
    use the device layout (T, 2, F, 3corner, 3coord); see
    `ops.time_stencils.decouple_space`.
    """

    # Primal variables
    phi: jnp.ndarray        # (T+1, V) potential
    A: jnp.ndarray          # (T, V) time component of q
    B: jnp.ndarray          # (T+1, F, 3) spatial momentum component
    lambda_c: jnp.ndarray   # (T, V) congestion slack
    z_fst: jnp.ndarray      # (T, V) cone head
    z_mid: jnp.ndarray      # (T, 2, F, 3, 3) cone tail block
    z_end: jnp.ndarray      # (T, V) cone tail scalar
    # Dual variables
    mu: jnp.ndarray         # (T, V) transported density (dual)
    E: jnp.ndarray          # (T+1, F, 3) momentum (dual)
    beta_fst: jnp.ndarray   # (T, V)
    beta_mid: jnp.ndarray   # (T, 2, F, 3, 3)
    beta_end: jnp.ndarray   # (T, V)
    # Gradients of phi from the most recent step 2 (consumed by KKT)
    dt_phi: jnp.ndarray     # (T, V)
    dx_phi: jnp.ndarray     # (T+1, F, 3)
    # Boundary source term (rows 0 / -1 carry -/+ mu0/mu1 / (r dt))
    boundary: jnp.ndarray   # (T+1, V)
    # Scalars (0-d arrays)
    r: jnp.ndarray              # ALM penalty sigma
    congestion: jnp.ndarray     # congestion parameter (in scaled units)
    constant_d: jnp.ndarray     # cone offset d (scaled)
    norm_constant_d: jnp.ndarray
    norm_boundary: jnp.ndarray
    prim_scale: jnp.ndarray
    dual_scale: jnp.ndarray
    scale_z: jnp.ndarray
    tau: jnp.ndarray            # multiplier step size
    eps: jnp.ndarray            # proximal regularization of the phi step


def init_state(
    n_time: int,
    n_vertices: int,
    n_triangles: int,
    mu0,
    mu1,
    dt: float,
    grad_time_fn,
    grad_space_fn,
    decouple_adjoint_fn,
    init_solution: dict | None = None,
    congestion: float = 0.0,
    tau: float = 1.9,
    eps: float = 0.0,
    r: float = 1.0,
    norm_constant_d: float = 1.0,
    norm_boundary: float = 1.0,
    dtype=jnp.float32,
    phi_dtype=None,
) -> SolverState:
    """Build the initial state, optionally warm-starting from a previous
    solution (reference `socp/solver_socp.py:239-270`).

    phi_dtype : dtype for `phi` only (mixed-precision refinement carries
        phi in float64 while the rest of the state stays in `dtype`).
    """
    init = init_solution or {}
    phi_dtype = dtype if phi_dtype is None else phi_dtype

    def get(name, shape):
        if name in init and init[name] is not None:
            return jnp.asarray(init[name], dtype=dtype)
        return jnp.zeros(shape, dtype=dtype)

    T, V, F = n_time, n_vertices, n_triangles
    if init.get("phi") is not None:
        phi = jnp.asarray(init["phi"], dtype=phi_dtype)
    else:
        phi = jnp.zeros((T + 1, V), dtype=phi_dtype)
    A = (
        jnp.asarray(init["A"], dtype=dtype)
        if init.get("A") is not None
        else grad_time_fn(phi).astype(dtype)
    )
    B = (
        jnp.asarray(init["B"], dtype=dtype)
        if init.get("B") is not None
        else grad_space_fn(phi).astype(dtype)
    )
    lambda_c = get("lambda_c", (T, V))
    z_fst = get("z_fst", (T, V))
    z_end = get("z_end", (T, V))
    z_mid = get("z_mid", (T, 2, F, 3, 3))
    beta_fst = (1.0 / r) * get("beta_fst", (T, V))
    beta_end = (1.0 / r) * get("beta_end", (T, V))
    beta_mid = (1.0 / r) * get("beta_mid", (T, 2, F, 3, 3))
    if init.get("mu") is not None:
        mu = (1.0 / r) * jnp.asarray(init["mu"], dtype=dtype)
    else:
        mu = beta_fst - beta_end
    if init.get("E") is not None:
        E = (1.0 / r) * jnp.asarray(init["E"], dtype=dtype)
    else:
        E = -decouple_adjoint_fn(beta_mid, 1.0)

    boundary = jnp.zeros((T + 1, V), dtype=dtype)
    boundary = boundary.at[0].set(-jnp.asarray(mu0, dtype=dtype) / (r * dt))
    boundary = boundary.at[-1].set(jnp.asarray(mu1, dtype=dtype) / (r * dt))

    scalar = lambda x: jnp.asarray(x, dtype=dtype)
    return SolverState(
        phi=phi,
        A=A,
        B=B,
        lambda_c=lambda_c,
        z_fst=z_fst,
        z_mid=z_mid,
        z_end=z_end,
        mu=mu,
        E=E,
        beta_fst=beta_fst,
        beta_mid=beta_mid,
        beta_end=beta_end,
        dt_phi=grad_time_fn(phi).astype(dtype),
        dx_phi=grad_space_fn(phi).astype(dtype),
        boundary=boundary,
        r=scalar(r),
        congestion=scalar(congestion),
        constant_d=scalar(1.0),
        norm_constant_d=scalar(norm_constant_d),
        norm_boundary=scalar(norm_boundary),
        prim_scale=scalar(1.0),
        dual_scale=scalar(1.0),
        scale_z=scalar(1.0),
        tau=scalar(tau),
        eps=scalar(eps),
    )
