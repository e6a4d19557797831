"""chip_smoke.py's kernel checks (phase B) at small widths on the CPU: the
helpers must agree with their float64 references, so that a failure on the
GPU points at the device and not at the check."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke


@pytest.fixture(scope="module")
def plane():
    return chip_smoke.plane_problem(24)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.float64, 1e-12)])
def test_ell_matvec_check(plane, dtype, tol):
    _, lap, av = plane
    assert chip_smoke.check_ell_matvec(lap, av, 7, dtype) <= tol


def test_spectral_check_gauge_matches_solver(plane):
    """In f64 the spectral solve and the bordered SciPy solves (gauge av)
    must agree to rounding: a wrong gauge would show as an O(1) error."""
    import dots_socp_tpu.ops.laplacian as lap_mod
    from jax.lax import Precision

    _, lap, av = plane
    err = chip_smoke.check_spectral_solve(lap, av, 7, (Precision.HIGHEST,))
    assert err["highest"] <= 1e-5  # f32 factor
    factor = lap_mod.build_spectral_factor(7, 1 / 7, av, lap, dtype=jnp.float64)
    rhs = np.random.default_rng(5).standard_normal((8, av.shape[0]))
    lam, u = chip_smoke.time_modes(7)
    ref = u @ chip_smoke.shifted_solves(lap, av, lam, u.T @ rhs, av)
    got = np.asarray(lap_mod.spectral_solve(factor, jnp.asarray(rhs)))
    assert chip_smoke.rel(got, ref) <= 1e-9


def test_refined_cg_check(plane):
    geometry, lap, av = plane
    r = chip_smoke.check_refined_cg(geometry, lap, av, 7, rtol=1e-8)
    assert r["rel_residual"] <= 1e-7
    assert r["rel_err_vs_spsolve"] <= 1e-7 * r["cond"]
    assert r["cond"] > 1.0 and r["inner_iters"] > 0


def test_soc_check(plane):
    geometry, _, _ = plane
    assert chip_smoke.check_soc_projection(geometry, 3) <= 1e-6


def test_naive_soc_projection_branches():
    """Head inside, outside and opposite the cone: identity, scaled tail,
    origin -- the closed form the projection is checked against."""
    tri = np.array([[0, 1, 2]])
    diag = np.ones((1, 3))
    mid = np.zeros((3, 2, 1, 3, 3))
    mid[:, 0, 0, :, 0] = 3.0  # every vertex: tail (3, end)
    end = np.full((3, 3), 4.0)  # tail norm 5
    fst = np.array([[6.0] * 3, [1.0] * 3, [-6.0] * 3])
    z_fst, z_mid, z_end = chip_smoke.naive_soc_projection(tri, diag, fst, mid, end)
    np.testing.assert_allclose(z_fst[0], 6.0)
    np.testing.assert_allclose(z_end[0], 4.0)
    lam = 0.5 * (1 + 1 / 5)
    np.testing.assert_allclose(z_fst[1], lam * 5)
    np.testing.assert_allclose(z_end[1], lam * 4)
    np.testing.assert_allclose(z_mid[1, 0, 0, :, 0], lam * 3)
    assert not z_fst[2].any() and not z_end[2].any() and not z_mid[2].any()
