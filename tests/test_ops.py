"""Device operator tests: adjointness, SpMV equivalence, cone projection,
spectral and CG Laplacian solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dots_socp_tpu.geometry.generators import generate_plane_mesh
from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
from dots_socp_tpu.ops.cones import project_soc
from dots_socp_tpu.ops.laplacian import (
    build_cg_operator,
    build_spectral_factor,
    build_time_laplacian,
    cg_solve,
    spectral_solve,
)
from dots_socp_tpu.ops.mesh_ops import (
    build_surface_ops,
    div_space,
    grad_space,
    laplacian_apply,
    vertex_gather,
    vertex_reduce,
)
from dots_socp_tpu.ops.time_stencils import (
    decouple_space,
    decouple_space_adjoint,
    div_time,
    grad_time,
    time_center_adjoint,
)

DT = jnp.float64


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(7)
    vertices, triangles, _ = generate_plane_mesh(n=7)
    vertices = vertices.copy()
    vertices[:, 2] = 0.03 * rng.standard_normal(vertices.shape[0])
    return vertices, triangles


@pytest.fixture(scope="module")
def ops(mesh):
    vertices, triangles = mesh
    return build_surface_ops(vertices, triangles, dtype=DT)


def test_grad_div_adjoint(ops):
    """<grad phi, m> = -<phi, div m> under the plain dot product."""
    rng = np.random.default_rng(2)
    V = ops.av.shape[0]
    F = ops.area_f.shape[0]
    phi = jnp.asarray(rng.standard_normal((4, V)))
    m = jnp.asarray(rng.standard_normal((4, F, 3)))
    lhs = jnp.sum(grad_space(ops, phi) * m)
    rhs = -jnp.sum(phi * div_space(ops, m))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_gather_reduce_adjoint(ops):
    rng = np.random.default_rng(3)
    V = ops.av.shape[0]
    F = ops.area_f.shape[0]
    x = jnp.asarray(rng.standard_normal((2, V)))
    y = jnp.asarray(rng.standard_normal((2, F, 3)))
    lhs = jnp.sum(vertex_gather(ops, x) * y)
    rhs = jnp.sum(x * vertex_reduce(ops, y))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_laplacian_apply_matches_cotan(mesh, ops):
    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, vertices.shape[0]))
    expected = (lap @ x.T).T
    got = np.asarray(laplacian_apply(ops, jnp.asarray(x)))
    np.testing.assert_allclose(got, expected, atol=1e-10)


def test_grad_of_linear_field_is_exact(mesh, ops):
    """P1 gradient of an affine function equals its true gradient."""
    vertices, triangles = mesh
    coeffs = np.array([0.3, -1.2, 0.7])
    phi = vertices @ coeffs
    g = np.asarray(grad_space(ops, jnp.asarray(phi[None, :])))[0]
    # The tangential projection of coeffs onto each triangle plane.
    _, _, basis = triangle_quantities(vertices, triangles)
    p = vertices[triangles]
    for f in range(0, triangles.shape[0], 17):
        e1 = p[f, 1] - p[f, 0]
        e2 = p[f, 2] - p[f, 0]
        # Compare tangential components only.
        np.testing.assert_allclose(g[f] @ e1, coeffs @ e1, atol=1e-10)
        np.testing.assert_allclose(g[f] @ e2, coeffs @ e2, atol=1e-10)


def test_time_stencil_adjoints():
    rng = np.random.default_rng(5)
    T, V = 6, 11
    dt = 1.0 / T
    phi = jnp.asarray(rng.standard_normal((T + 1, V)))
    m = jnp.asarray(rng.standard_normal((T, V)))
    # div_time is the NEGATIVE adjoint of grad_time:
    # <grad_t phi, m> = -<phi, div_t m>.
    lhs = jnp.sum(grad_time(dt, phi) * m)
    rhs = -jnp.sum(phi * div_time(dt, m))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)

    # time_center_adjoint is the adjoint of centered averaging.
    x = jnp.asarray(rng.standard_normal((T, V)))
    y = jnp.asarray(rng.standard_normal((T + 1, V)))
    avg_y = 0.5 * (y[:-1] + y[1:])
    lhs = jnp.sum(x * avg_y)
    rhs = jnp.sum(time_center_adjoint(x) * y)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_decouple_adjoint():
    rng = np.random.default_rng(6)
    T, F = 5, 9
    scale = 1.7
    b = jnp.asarray(rng.standard_normal((T + 1, F, 3)))
    x = jnp.asarray(rng.standard_normal((T, 2, F, 3, 3)))
    lhs = jnp.sum(decouple_space(b, scale) * x)
    rhs = jnp.sum(b * decouple_space_adjoint(x, scale))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def _naive_cone_projection(head, tail):
    """Project (head, tail) onto {(s, y): s >= ||y||}, closed form."""
    n = np.linalg.norm(tail)
    if head >= n:
        return head, tail
    if head <= -n:
        return 0.0, 0.0 * tail
    lam = 0.5 * (1.0 + head / n)
    return lam * n, lam * tail


def test_soc_projection_matches_naive(ops):
    rng = np.random.default_rng(8)
    V = ops.av.shape[0]
    F = ops.area_f.shape[0]
    T = 3
    to_fst = jnp.asarray(rng.standard_normal((T, V)))
    to_mid = jnp.asarray(rng.standard_normal((T, 2, F, 3, 3)))
    to_end = jnp.asarray(rng.standard_normal((T, V)))

    z_fst, z_mid, z_end = project_soc(ops, to_fst, to_mid, to_end)
    z_fst, z_mid, z_end = map(np.asarray, (z_fst, z_mid, z_end))
    tri = np.asarray(ops.tri)
    diag = np.asarray(ops.diag_soc)

    # Check a sample of cones against the naive projection.
    for t in range(T):
        for v in range(0, V, 13):
            slots = [(f, k) for f in range(F) for k in range(3) if tri[f, k] == v]
            tail = np.concatenate(
                [np.asarray(to_mid)[t, :, f, k, :].reshape(-1) for f, k in slots]
                + [[np.asarray(to_end)[t, v]]]
            )
            head_p, tail_p = _naive_cone_projection(float(np.asarray(to_fst)[t, v]), tail)
            np.testing.assert_allclose(z_fst[t, v], head_p, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(z_end[t, v], tail_p[-1], rtol=1e-10, atol=1e-12)
            # z_mid is returned in original z coordinates: x = diag * z.
            got = np.concatenate(
                [
                    (diag[f, k] * z_mid[t, :, f, k, :]).reshape(-1)
                    for f, k in slots
                ]
            )
            np.testing.assert_allclose(got, tail_p[:-1], rtol=1e-10, atol=1e-12)


def test_soc_projection_idempotent(ops):
    rng = np.random.default_rng(9)
    V = ops.av.shape[0]
    F = ops.area_f.shape[0]
    T = 2
    to_fst = jnp.asarray(rng.standard_normal((T, V)))
    to_mid = jnp.asarray(rng.standard_normal((T, 2, F, 3, 3)))
    to_end = jnp.asarray(rng.standard_normal((T, V)))
    z1 = project_soc(ops, to_fst, to_mid, to_end)
    # Re-project: feed z_mid back in cone coordinates (multiply by diag).
    mid_cone = z1[1] * np.asarray(ops.diag_soc)[None, None, :, :, None]
    z2 = project_soc(ops, z1[0], mid_cone, z1[2])
    np.testing.assert_allclose(np.asarray(z2[0]), np.asarray(z1[0]), atol=1e-10)
    np.testing.assert_allclose(np.asarray(z2[2]), np.asarray(z1[2]), atol=1e-10)


def test_soc_projection_zero_tail_no_nan(ops):
    """An all-zero cone tail must not produce NaN (0/0 in the lam formula):
    projecting (s, 0) gives (s, 0) for s >= 0 and the origin for s < 0."""
    V = ops.av.shape[0]
    F = ops.area_f.shape[0]
    T = 2
    to_fst = jnp.zeros((T, V))
    # Mix of positive / zero / negative heads on the zero tail.
    to_fst = to_fst.at[0, ::3].set(1.5).at[1, ::2].set(-2.0)
    to_mid = jnp.zeros((T, 2, F, 3, 3))
    to_end = jnp.zeros((T, V))

    z_fst, z_mid, z_end = map(
        np.asarray, project_soc(ops, to_fst, to_mid, to_end)
    )
    assert np.isfinite(z_fst).all() and np.isfinite(z_mid).all()
    assert np.isfinite(z_end).all()
    np.testing.assert_array_equal(z_fst, np.maximum(np.asarray(to_fst), 0.0))
    assert not z_mid.any() and not z_end.any()


def test_time_laplacian_eigen():
    T = 9
    dt = 1.0 / T
    lap = build_time_laplacian(T, dt)
    np.testing.assert_allclose(lap, lap.T)
    w = np.linalg.eigvalsh(lap)
    assert w.max() < 1e-8  # negative semidefinite
    np.testing.assert_allclose(lap @ np.ones(T + 1), 0.0, atol=1e-10)


def test_spectral_solve_residual(mesh, ops):
    """The spectral factor inverts the space-time Laplacian on range(A)."""
    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    T = 7
    dt = 1.0 / T
    av = np.asarray(ops.av)

    factor = build_spectral_factor(T, dt, av, lap, eps=0.0, dtype=DT)

    rng = np.random.default_rng(10)
    x_true = rng.standard_normal((T + 1, vertices.shape[0]))

    def apply_spacetime(x):
        lap_t = build_time_laplacian(T, dt)
        return (lap_t @ x) * av[None, :] + (lap @ x.T).T

    rhs = apply_spacetime(x_true)
    x = np.asarray(spectral_solve(factor, jnp.asarray(rhs)))
    # Solution agrees up to the null space (global constant).
    resid = apply_spacetime(x) - rhs
    assert np.abs(resid).max() < 1e-8
    diff = x - x_true
    assert np.std(diff) < 1e-8 or np.abs(diff - diff.mean()).max() < 1e-7


def test_cg_solve_matches_spectral(mesh, ops):
    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    T = 5
    dt = 1.0 / T
    av = np.asarray(ops.av)

    factor = build_spectral_factor(T, dt, av, lap, eps=0.0, dtype=DT)
    cg_op = build_cg_operator(T, dt, av, lap, eps=0.0, dtype=DT, deflation_k=16)

    rng = np.random.default_rng(11)
    rhs = rng.standard_normal((T + 1, vertices.shape[0]))
    # Make rhs consistent (orthogonal to the global constant null vector).
    rhs -= rhs.mean()

    x_spec = np.asarray(spectral_solve(factor, jnp.asarray(rhs)))
    x_cg = np.asarray(
        cg_solve(ops, cg_op, jnp.asarray(rhs), max_iters=500, rtol=1e-13)
    )
    diff = x_spec - x_cg
    assert np.abs(diff - diff.mean()).max() < 1e-6


def test_ell_matvec_matches_assembled_and_matrix_free(mesh, ops):
    """The padded-ELL SpMV inside the CG path must equal both the assembled
    cotan matrix and the matrix-free div(area * grad(x)) composition."""
    from dots_socp_tpu.ops.laplacian import ell_matvec
    from dots_socp_tpu.ops.mesh_ops import laplacian_apply

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    T = 5
    dt = 1.0 / T
    av = np.asarray(ops.av)
    cg_op = build_cg_operator(T, dt, av, lap, eps=0.0, dtype=DT, deflation_k=0)

    rng = np.random.default_rng(12)
    x = rng.standard_normal((T + 1, vertices.shape[0]))

    via_ell = np.asarray(ell_matvec(cg_op, jnp.asarray(x)))
    via_matrix = (lap @ x.T).T
    via_ops = np.asarray(laplacian_apply(ops, jnp.asarray(x)))
    np.testing.assert_allclose(via_ell, via_matrix, atol=1e-10)
    np.testing.assert_allclose(via_ell, via_ops, atol=1e-10)


def test_banded_matvec_matches_assembled(mesh, ops):
    """The RCM block-banded matmul SpMV must equal the assembled matrix."""
    from dots_socp_tpu.ops.laplacian import banded_matvec, build_banded_operator

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    band = build_banded_operator(lap, dtype=DT)
    assert band is not None

    rng = np.random.default_rng(13)
    x = rng.standard_normal((6, vertices.shape[0]))
    via_band = np.asarray(banded_matvec(band, jnp.asarray(x)))
    via_matrix = (lap @ x.T).T
    np.testing.assert_allclose(via_band, via_matrix, atol=1e-10)


def test_banded_operator_respects_storage_cap(mesh):
    """build_banded_operator must return None (ELL fallback) when the band
    would exceed the storage cap, instead of materializing it."""
    from dots_socp_tpu.ops.laplacian import build_banded_operator

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    assert build_banded_operator(lap, max_bytes=1024) is None


def test_cg_per_shift_stopping(mesh, ops):
    """Every shifted system must meet ITS OWN relative residual. An
    aggregate (batch-summed) stopping criterion lets a dominant-norm shift
    terminate the small-norm shifts under-converged."""
    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    T = 5
    dt = 1.0 / T
    av = np.asarray(ops.av)
    # eps > 0: every shifted system is nonsingular (no null-row deflation),
    # so per-shift residuals can be checked directly against the matrix.
    cg_op = build_cg_operator(
        T, dt, av, lap, eps=1e-2, dtype=DT, deflation_k=8
    )

    rng = np.random.default_rng(21)
    bh = rng.standard_normal((T + 1, vertices.shape[0]))
    bh[0] *= 1e6  # 6 orders of magnitude of per-shift norm imbalance
    u_time = np.asarray(cg_op.u_time)
    rhs = u_time @ bh  # so the solver's time transform recovers bh exactly

    rtol = 1e-6
    x = np.asarray(
        cg_solve(ops, cg_op, jnp.asarray(rhs), max_iters=3000, rtol=rtol)
    )
    xh = u_time.T @ x
    shifts = np.asarray(cg_op.shifts)
    lap_d = lap.toarray()
    # Guarantee: every row meets rtol relative to max(its own norm, the
    # mean row norm) -- dominant rows can no longer end the others early
    # (the old batch-summed criterion allowed a row residual up to
    # rtol * ||b_total||), and below-average rows meet the absolute
    # accuracy the aggregate solution needs.
    mean_b2 = np.mean([np.sum(bh[a] ** 2) for a in range(T + 1)])
    for a in range(T + 1):
        lhs = -(lap_d @ xh[a] + shifts[a] * av * xh[a])
        resid = np.linalg.norm(-bh[a] - lhs)
        bound = rtol * np.sqrt(max(np.sum(bh[a] ** 2), mean_b2))
        assert resid <= 5 * bound, (
            f"shift {a} under-converged: {resid:.3e} vs {bound:.3e}"
        )


def test_ritz_pairs_disk_cache(mesh, ops, tmp_path, monkeypatch):
    """Ritz pairs persist keyed by the exact (L, av, k): the second build of
    the same problem reads them from disk instead of rerunning LOBPCG."""
    from dots_socp_tpu.ops import laplacian as lap_mod

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(ops.av)
    monkeypatch.setenv("DOTS_SOCP_CACHE_DIR", str(tmp_path))

    calls = []
    orig = lap_mod._ritz_pairs

    def counting(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(lap_mod, "_ritz_pairs", counting)

    q1, w1 = lap_mod._ritz_pairs_cached(lap, av, 8)
    assert len(calls) == 1
    q2, w2 = lap_mod._ritz_pairs_cached(lap, av, 8)
    assert len(calls) == 1, "second build must hit the disk cache"
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(w1, w2)

    lap_mod._ritz_pairs_cached(lap, av, 4)  # different k -> different key
    assert len(calls) == 2


@pytest.mark.parametrize("n_time", [31, 128, 255])
def test_cg_solve_matches_scipy_across_time_grids(mesh, ops, n_time):
    """The ELL CG path has no cap on T+1 (32, 129, 256 here): every shifted
    system must match a SciPy direct solve, the singular shift-0 row in the
    CG's gauge (mean-zero solution of the mean-zero-projected system)."""
    from chip_smoke import shifted_solves, time_modes

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(ops.av)
    cg_op = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, dtype=DT, deflation_k=8
    )
    rng = np.random.default_rng(33)
    rhs = rng.standard_normal((n_time + 1, vertices.shape[0]))
    x = np.asarray(
        cg_solve(ops, cg_op, jnp.asarray(rhs), max_iters=2000, rtol=1e-12)
    )
    lam, u = time_modes(n_time)
    ref = u @ shifted_solves(lap, av, lam, u.T @ rhs, np.ones_like(av))
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-9


@pytest.mark.parametrize("eps", [0.0, 1e-2])
def test_refined_true_residual_is_native_f64(mesh, ops, eps):
    """f32 inner CG + native-f64 true residual: the refined solve must reach
    an f64-grade residual, checked by SciPy in f64 -- far below what any
    f32 evaluation of the residual could certify (~1e-6)."""
    from chip_smoke import time_modes

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(ops.av)
    T = 7
    op = build_cg_operator(
        T, 1.0 / T, av, lap, eps=eps, dtype=jnp.float32, deflation_k=8,
        refine=True,
    )
    assert op.ell_w_hi.dtype == jnp.float64
    rng = np.random.default_rng(34)
    rhs = rng.standard_normal((T + 1, vertices.shape[0])).astype(np.float32)
    x = cg_solve(ops, op, jnp.asarray(rhs), max_iters=2000, rtol=1e-12)
    assert x.dtype == jnp.float64

    lam, u = time_modes(T)
    bhat = u.T @ rhs.astype(np.float64)
    xhat = u.T @ np.asarray(x)
    r2 = b2 = 0.0
    for a in range(T + 1):
        b = bhat[a]
        if abs(lam[a] - eps) < 1e-9:  # singular row: consistent part of b
            b = b - b.mean()
        r = b - (lap @ xhat[a] + (lam[a] - eps) * av * xhat[a])
        r2 += float(r @ r)
        b2 += float(b @ b)
    assert np.sqrt(r2 / b2) <= 1e-10


def test_spectral_eigh_disk_cache(mesh, ops, tmp_path, monkeypatch):
    """The one-time host eigh persists keyed by (L, av, dtype); a second
    build reads it from disk (sweeps re-solving the same mesh at several
    congestion levels pay the O(V^3) eigh once)."""
    from dots_socp_tpu.ops import laplacian as lap_mod

    vertices, triangles = mesh
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(ops.av)
    s = 1.0 / np.sqrt(av)
    c = -(s[:, None] * lap.toarray() * s[None, :])
    c = 0.5 * (c + c.T)
    monkeypatch.setenv("DOTS_SOCP_CACHE_DIR", str(tmp_path))

    calls = []
    orig = np.linalg.eigh

    def counting(m):
        calls.append(1)
        return orig(m)

    monkeypatch.setattr(np.linalg, "eigh", counting)
    w1, q1 = lap_mod._spectral_eigh_cached(lap, av, c, DT, min_cache_v=1)
    assert len(calls) == 1
    w2, q2 = lap_mod._spectral_eigh_cached(lap, av, c, DT, min_cache_v=1)
    assert len(calls) == 1, "second build must hit the disk cache"
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(q1, q2)
