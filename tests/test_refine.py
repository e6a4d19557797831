"""Mixed-precision iterative refinement of the phi solve.

Finite-precision CG floors the TRUE residual ||b - A x|| at
~eps_work * ||A|| ||x|| regardless of the recursive-residual tolerance; at
V=46k that f32 floor (eps32/h^2 ~ 2e-3 relative) sits above the tol=1e-4
outer tolerance and stalled the round-3 large-mesh solves. These tests pin
the failure mode at CI scale and prove the refinement removes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dots_socp_tpu.geometry.generators import generate_plane_mesh
from dots_socp_tpu.geometry.surface import (
    cotan_laplacian,
    triangle_quantities,
    vertex_areas,
)
from dots_socp_tpu.ops.laplacian import build_cg_operator, cg_solve
from dots_socp_tpu.ops.mesh_ops import build_surface_ops


@pytest.fixture(scope="module")
def cg_problem():
    n_time = 7
    vertices, triangles, _ = generate_plane_mesh(n=40)
    v = vertices.shape[0]
    area_f, angles, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, v) / 3.0
    lap = cotan_laplacian(triangles, angles, v)
    ops = build_surface_ops(vertices, triangles, dtype=jnp.float32)

    # Smooth RHS (low spatial modes dominate the solution) -- this is the
    # regime where ||A|| ||x|| / ||b|| ~ cond(A) and the f32 floor bites.
    rng = np.random.default_rng(3)
    smooth = np.sin(2 * np.pi * vertices[:, 0]) * np.cos(
        2 * np.pi * vertices[:, 1]
    )
    rhs = np.outer(
        1.0 + 0.1 * rng.standard_normal(n_time + 1), smooth * av
    )
    rhs -= rhs.mean(axis=1, keepdims=True)  # consistent on the null row
    return n_time, av, lap, ops, jnp.asarray(rhs, dtype=jnp.float32)


def _true_residual(n_time, av, lap, x, rhs):
    """Aggregate f64 relative true residual over the shifted systems:
    sqrt(sum_a ||r_a||^2 / sum_a ||b_a||^2) -- the quantity the per-row
    capped-mean CG threshold guarantees <= sqrt(2) * rtol."""
    from dots_socp_tpu.ops.laplacian import build_time_laplacian

    lap_time = build_time_laplacian(n_time, 1.0 / n_time)
    lam, u = np.linalg.eigh(lap_time)
    xb = u.T @ np.asarray(x, dtype=np.float64)
    bb = u.T @ np.asarray(rhs, dtype=np.float64)
    dense = lap.toarray()
    r2 = b2 = 0.0
    for a in range(n_time + 1):
        mat = -(dense + lam[a] * np.diag(av))
        r = (-bb[a]) - mat @ xb[a]
        if abs(lam[a]) < 1e-9:  # singular row: compare deflated
            r -= r.mean()
        r2 += float(r @ r)
        b2 += float(bb[a] @ bb[a])
    return np.sqrt(r2 / b2)


def test_refined_cg_beats_f32_true_residual_floor(cg_problem):
    n_time, av, lap, ops, rhs = cg_problem
    rtol = 1e-7
    kw = dict(deflation_k=32, rtol=rtol)
    op_plain = build_cg_operator(n_time, 1.0 / n_time, av, lap, **kw)
    op_ref = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, refine=True, **kw
    )
    assert op_ref.ell_w_hi is not None and op_ref.ell_w_hi.dtype == jnp.float64

    x_plain = cg_solve(ops, op_plain, rhs, max_iters=3000)
    x_ref = cg_solve(ops, op_ref, rhs, max_iters=3000)
    assert x_plain.dtype == jnp.float32
    assert x_ref.dtype == jnp.float64

    res_plain = _true_residual(n_time, av, lap, x_plain, rhs)
    res_ref = _true_residual(n_time, av, lap, x_ref, rhs)

    # The refined solve meets the requested tolerance in TRUE residual...
    assert res_ref < 2 * rtol, res_ref
    # ...while plain f32 CG floors orders of magnitude above it (this is
    # the measured V=46k stall mechanism, reproduced at CI scale).
    assert res_plain > 50 * rtol, res_plain
    assert res_ref < res_plain / 10


def test_refined_f64_rhs_matches_plain_f64_cg(cg_problem):
    """f64 rhs on a refine-enabled operator runs the refined path (f32
    inner corrections wrapped in f64 true-residual refinement) and must
    reach the same f64-grade accuracy as a plain all-f64 CG."""
    n_time, av, lap, ops, rhs = cg_problem
    rtol = 1e-9
    rhs64 = jnp.asarray(np.asarray(rhs), dtype=jnp.float64)
    op_plain = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, dtype=jnp.float64, deflation_k=32,
        rtol=rtol,
    )
    op_ref = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, dtype=jnp.float64, deflation_k=32,
        rtol=rtol, refine=True,
    )
    x_plain = cg_solve(ops, op_plain, rhs64, max_iters=3000)
    x_ref = cg_solve(ops, op_ref, rhs64, max_iters=3000)
    assert x_plain.dtype == jnp.float64 and x_ref.dtype == jnp.float64

    res_plain = _true_residual(n_time, av, lap, x_plain, rhs64)
    res_ref = _true_residual(n_time, av, lap, x_ref, rhs64)
    assert res_ref < 2 * rtol, res_ref
    assert res_plain < 2 * rtol, res_plain


def test_refined_cg_warm_start(cg_problem):
    """Warm-started refinement (the production call shape: x0 = prev phi)."""
    n_time, av, lap, ops, rhs = cg_problem
    op_ref = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, deflation_k=32, rtol=1e-7, refine=True
    )
    x1, it_cold = cg_solve(ops, op_ref, rhs, max_iters=3000, return_iters=True)
    x2, it_warm = cg_solve(
        ops, op_ref, rhs, x0=x1, max_iters=3000, return_iters=True
    )
    res = _true_residual(n_time, av, lap, x2, rhs)
    assert res < 2e-7
    assert int(it_warm) <= max(int(it_cold) // 4, 2)


def test_solver_phi_refine_matches_plain_trajectory(plane_geometry):
    """phi_refine on vs off: same early trajectory (KKT within f32 noise),
    phi carried in f64, all other state in f32."""
    from dots_socp_tpu.solver import solver_socp

    kw = dict(
        nit=30,
        tol=1e-9,
        time_limit=600,
        precision="float32",
        laplacian_mode="cg",
        cg_rtol=1e-6,
        cg_deflation_k=16,
        max_chunk=16,
    )
    sol_off, hist_off = solver_socp(
        8, plane_geometry, phi_refine="off", **kw
    )
    sol_on, hist_on = solver_socp(8, plane_geometry, phi_refine="on", **kw)

    kkt_off = np.asarray(hist_off.get_current_kkt_errors(), dtype=float)
    kkt_on = np.asarray(hist_on.get_current_kkt_errors(), dtype=float)
    finite = np.isfinite(kkt_off) & np.isfinite(kkt_on)
    assert finite.any()
    np.testing.assert_allclose(
        kkt_on[finite], kkt_off[finite], rtol=2e-2, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(sol_on["mu"]), np.asarray(sol_off["mu"]),
        rtol=5e-3, atol=5e-6,
    )


def test_solver_phi_refine_state_dtypes(plane_geometry):
    from dots_socp_tpu.solver.problem import build_problem
    from dots_socp_tpu.solver.state import init_state
    from dots_socp_tpu.solver.step import run_chunk
    from dots_socp_tpu.ops.time_stencils import grad_time, decouple_space_adjoint
    from dots_socp_tpu.ops.mesh_ops import grad_space

    config, data, extras = build_problem(
        4, plane_geometry, dtype="float32", laplacian_mode="cg",
        cg_deflation_k=8, phi_refine=True,
    )
    assert config.phi_refine
    dt = config.stepsize_time
    state = init_state(
        4, config.n_vertices, config.n_triangles,
        extras["mu0_padded"], extras["mu1_padded"], dt,
        grad_time_fn=lambda p: grad_time(dt, p),
        grad_space_fn=lambda p: grad_space(data.ops, p),
        decouple_adjoint_fn=decouple_space_adjoint,
        dtype=config.jnp_dtype,
        phi_dtype=config.phi_dtype,
    )
    assert state.phi.dtype == jnp.float64
    out = run_chunk(config, data, state, np.int32(3))
    assert out.phi.dtype == jnp.float64
    for name in ("A", "B", "mu", "E", "dt_phi", "dx_phi", "z_mid", "beta_mid"):
        assert getattr(out, name).dtype == jnp.float32, name


def test_snapshot_roundtrip_preserves_phi_dtype(tmp_path):
    from dots_socp_tpu.utils.snapshot import (
        load_snapshot,
        save_snapshot,
        state_from_arrays,
        _STATE_FIELDS,
    )
    from dots_socp_tpu.solver.state import SolverState

    rng = np.random.default_rng(0)
    fields = {}
    for f in _STATE_FIELDS:
        if f == "phi":
            fields[f] = jnp.asarray(rng.standard_normal((3, 5)), jnp.float64)
        elif f in ("r", "congestion", "constant_d", "norm_constant_d",
                   "norm_boundary", "prim_scale", "dual_scale", "scale_z",
                   "tau", "eps"):
            fields[f] = jnp.asarray(1.0, jnp.float32)
        else:
            fields[f] = jnp.asarray(rng.standard_normal((3, 5)), jnp.float32)
    state = SolverState(**fields)
    path = str(tmp_path / "snap.npz")
    save_snapshot(path, state, {"n_time": 2, "iteration": 5, "elapsed": 1.0})
    arrays, meta = load_snapshot(path)
    restored = state_from_arrays(arrays, jnp.float32, phi_dtype=jnp.float64)
    assert restored.phi.dtype == jnp.float64
    assert restored.mu.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(restored.phi), arrays["phi"])


def _plane_cg_problem(n=40, **kw):
    """(config, data, extras, rhs_real) for a plane mesh CG problem."""
    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry
    from dots_socp_tpu.solver.problem import build_problem

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": n}
    )
    geometry, _ = normalize_geometry(geometry)
    config, data, extras = build_problem(
        6, geometry, dtype="float32", laplacian_mode="cg",
        cg_deflation_k=16, cg_rtol=1e-7, **kw,
    )
    rng = np.random.default_rng(0)
    v_real = np.asarray(geometry["vertices"]).shape[0]
    rhs_real = rng.standard_normal((7, v_real))
    rhs_real -= rhs_real.mean(axis=1, keepdims=True)
    return config, data, extras, rhs_real


def test_sharded_refined_cg_matches_unsharded():
    """The space-sharded refined phi solve (f64 true residual through the
    halo/incidence matvec, `ProblemData.ops_hi`) must reproduce the
    unsharded refined solve -- including the singular shift~0 row, whose
    consistency projection must account for the blocked layout's padding
    slots (zero them; subtract the REAL-vertex mean)."""
    from dots_socp_tpu.ops.laplacian import cg_solve
    from dots_socp_tpu.parallel.mesh import make_mesh, shard_problem

    cfg_u, data_u, ex_u, rhs_real = _plane_cg_problem(phi_refine=True)
    assert cfg_u.phi_refine and data_u.cg_op.ell_w_hi is not None
    rhs_u = np.zeros((7, cfg_u.n_vertices), np.float32)
    rhs_u[:, ex_u["vertex_slot"]] = rhs_real
    x_u = cg_solve(data_u.ops, data_u.cg_op, jnp.asarray(rhs_u), max_iters=2000)

    cfg_s, data_s, ex_s, _ = _plane_cg_problem(
        phi_refine=True, space_partitions=4, mesh_axes=(2, 4)
    )
    assert cfg_s.phi_refine, "phi_refine must engage on the sharded path"
    assert data_s.ops_hi is not None
    assert data_s.ops_hi.grad_basis.dtype == jnp.float64
    rhs_s = np.zeros((7, cfg_s.n_vertices), np.float32)
    rhs_s[:, ex_s["vertex_slot"]] = rhs_real
    data_sd = shard_problem(make_mesh(8, time_axis=2), data_s)
    x_s = cg_solve(
        data_sd.ops, data_sd.cg_op, jnp.asarray(rhs_s), max_iters=2000,
        halo=data_sd.halo, mesh_axes=(2, 4), ops_hi=data_sd.ops_hi,
    )
    assert x_u.dtype == jnp.float64 and x_s.dtype == jnp.float64

    a = np.asarray(x_u)[:, ex_u["vertex_slot"]]
    b = np.asarray(x_s)[:, ex_s["vertex_slot"]]
    scale = np.max(np.abs(a))
    assert np.max(np.abs(a - b)) / scale < 1e-5, np.max(np.abs(a - b)) / scale


def test_blocked_cg_singular_row_solved():
    """Regression: on the blocked layout (padding slots interleaved), plain
    f32 CG must still SOLVE the singular shift~0 system -- before the
    padding-aware consistency projection its residual stayed at 100%."""
    from dots_socp_tpu.ops.laplacian import build_time_laplacian, cg_solve
    from dots_socp_tpu.geometry.surface import (
        cotan_laplacian as _cotan,
        triangle_quantities as _triq,
        vertex_areas as _va,
    )
    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry
    from dots_socp_tpu.parallel.mesh import make_mesh, shard_problem

    cfg_s, data_s, ex_s, rhs_real = _plane_cg_problem(phi_refine=False,
        space_partitions=4, mesh_axes=(2, 4))
    assert cfg_s.n_vertices > rhs_real.shape[1]  # padding slots exist
    rhs_s = np.zeros((7, cfg_s.n_vertices), np.float32)
    rhs_s[:, ex_s["vertex_slot"]] = rhs_real
    data_sd = shard_problem(make_mesh(8, time_axis=2), data_s)
    x = np.asarray(cg_solve(
        data_sd.ops, data_sd.cg_op, jnp.asarray(rhs_s), max_iters=2000,
        halo=data_sd.halo, mesh_axes=(2, 4),
    ))[:, ex_s["vertex_slot"]]

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": 40}
    )
    geometry, _ = normalize_geometry(geometry)
    vtx = np.asarray(geometry["vertices"])
    tri = np.asarray(geometry["triangles"])
    area_f, angles, _ = _triq(vtx, tri)
    av = _va(tri, area_f, vtx.shape[0]) / 3.0
    lap = _cotan(tri, angles, vtx.shape[0]).toarray()
    lam, u = np.linalg.eigh(build_time_laplacian(6, 1.0 / 6.0))
    xb = u.T @ np.asarray(x, np.float64)
    bb = u.T @ rhs_real
    a_sing = int(np.argmin(np.abs(lam)))
    r = (-bb[a_sing]) - (-(lap + lam[a_sing] * np.diag(av))) @ xb[a_sing]
    r -= r.mean()
    assert np.linalg.norm(r) / np.linalg.norm(bb[a_sing]) < 1e-4
