"""One pass of the solver's main path on an NVIDIA GPU, checked.

    python chip_smoke.py               # phases A-E on one GPU
    python chip_smoke.py --four-cards  # the space-sharded solve on four GPUs,
                                       # beside the same solve on one of them

Phases (each prints one JSON line on stdout; every line carries the card's
name and power limit as `nvidia-smi` reports them):

  A  device: JAX must find a GPU, else exit 1 with no result line.
  C  spectral path end to end through `run_dot_surface` (plane n64, f32).
     Runs before anything turns on JAX's x64 mode, as a CLI process would.
  B  kernels at real widths against plain float64 SciPy / NumPy references:
     the padded-ELL SpMV (f32 and f64), the spectral phi solve (HIGHEST
     and TF32), the refined CG phi solve, the SOC projection.
  D  CG + f64-refinement path end to end (plane n200, f32).
  E  f64 accuracy against the closed-form transport (plane n50), compared
     with a CPU run of the same command.

The last stdout line is {"ok": true, "device": {...}} only when every phase
passed; otherwise the script exits 1 without it. Solver logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

T = 31  # the reference protocol's time grid (Makefile --ntime=31)
STOP_SET = [0, 2, 4, 5]  # KKT rows the solver stops on

# Phase E's reference: the same versus-exact solve on the CPU, produced by
#   JAX_PLATFORMS=cpu python -m dots_socp_tpu.cli --example plane \
#     --n_space 50 --ntime 31 --tol 1e-4 --nit 20000 --precision float64 \
#     --versus_exact
# (its "Versus exact transportation" block).
# Result on a CPU host (JAX 0.9.0): converged in 1398 iterations.
E_CPU_REFERENCE = {"l1": 2.36e-3, "l2": 4.63e-3, "linf": 1.93e-2}


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


# ---------------------------------------------------------------- helpers ---
def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def plane_problem(n_space: int):
    """(geometry, lap, av) of the plane example exactly as `build_problem`
    sees it: normalized geometry, cotan Laplacian (CSR), vertex areas / 3."""
    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry
    from dots_socp_tpu.geometry.surface import (
        cotan_laplacian,
        triangle_quantities,
        vertex_areas,
    )

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": n_space}
    )
    geometry, _ = normalize_geometry(geometry)
    vertices = np.asarray(geometry["vertices"], np.float64)
    triangles = np.asarray(geometry["triangles"])
    area_f, angles, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, vertices.shape[0]) / 3.0
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    return geometry, lap, av


def time_modes(n_time: int):
    """Eigenpairs (lam, U) of the Neumann time Laplacian, float64."""
    from dots_socp_tpu.ops.laplacian import build_time_laplacian

    return np.linalg.eigh(build_time_laplacian(n_time, 1.0 / n_time))


def shifted_solves(lap, av, shifts, bhat, gauge):
    """x_a = (L + s_a diag(av))^-1 b_a for every row a, SciPy SuperLU, f64.

    A row with s_a ~ 0 is singular (the constants span L's null space); it
    is solved bordered, [[L, g], [g^T, 0]] [x; l] = [b; 0], which removes
    b's component along g and pins g^T x = 0 -- the choice the solver makes
    (g = av for the spectral factor, g = 1 for CG).
    """
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve

    v = av.shape[0]
    lap = sp.csr_matrix(lap)
    scale = np.abs(shifts).max() * av.max() + np.abs(lap.diagonal()).max()
    g = sp.csr_matrix(np.asarray(gauge, np.float64).reshape(-1, 1))
    x = np.empty(bhat.shape, np.float64)
    for a, s in enumerate(shifts):
        mat = lap + s * sp.diags(av)
        if abs(s) * av.max() < 1e-10 * scale:
            mat = sp.bmat([[mat, g], [g.T, None]], format="csc")
            x[a] = spsolve(mat, np.append(bhat[a], 0.0))[:v]
        else:
            x[a] = spsolve(mat.tocsc(), bhat[a])
    return x


def check_ell_matvec(lap, av, n_time: int, dtype) -> float:
    """Relative error of `ell_matvec` against SciPy CSR @ x (float64)."""
    import jax
    import jax.numpy as jnp

    from dots_socp_tpu.ops.laplacian import build_cg_operator, ell_matvec

    op = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, dtype=dtype, deflation_k=0
    )
    x = np.random.default_rng(0).standard_normal((n_time + 1, av.shape[0]))
    x = np.asarray(x, jnp.dtype(dtype))
    y = jax.jit(ell_matvec)(op, jnp.asarray(x))
    assert y.dtype == jnp.dtype(dtype), y.dtype
    return rel(y, (lap @ x.astype(np.float64).T).T)


def check_spectral_solve(lap, av, n_time: int, precisions) -> dict:
    """Relative error of the f32 `spectral_solve` against per-shift SciPy
    solves, once per matmul precision in `precisions`."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from dots_socp_tpu.ops.laplacian import build_spectral_factor, spectral_solve

    factor = build_spectral_factor(
        n_time, 1.0 / n_time, av, lap, eps=0.0, dtype=jnp.float32
    )
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((n_time + 1, av.shape[0])).astype(np.float32)
    lam, u = time_modes(n_time)
    x_ref = u @ shifted_solves(lap, av, lam, u.T @ rhs.astype(np.float64), av)
    out = {}
    for prec in precisions:
        fn = jax.jit(partial(spectral_solve, precision=prec))
        out[str(prec).split(".")[-1].lower()] = rel(
            fn(factor, jnp.asarray(rhs)), x_ref
        )
    return out


def check_refined_cg(geometry, lap, av, n_time: int, rtol: float) -> dict:
    """The refined CG phi solve (f32 inner CG, f64 true residual) against
    per-shift SciPy solves: the relative residual of its solution, and its
    distance from the direct solution next to the bound cond * residual."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    from dots_socp_tpu.ops.laplacian import build_cg_operator, cg_solve
    from dots_socp_tpu.ops.mesh_ops import build_surface_ops

    v = av.shape[0]
    ops = build_surface_ops(
        np.asarray(geometry["vertices"]), np.asarray(geometry["triangles"]),
        dtype=jnp.float32,
    )
    op = build_cg_operator(
        n_time, 1.0 / n_time, av, lap, dtype=jnp.float32,
        deflation_k=int(min(256, max(64, v // 256))), rtol=rtol, refine=True,
    )
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal((n_time + 1, v)).astype(np.float32)
    solve = jax.jit(
        lambda s, o, b: cg_solve(s, o, b, max_iters=2000, return_iters=True)
    )
    x, iters = solve(ops, op, jnp.asarray(rhs))
    assert x.dtype == jnp.float64, x.dtype
    lam, u = time_modes(n_time)
    bhat = u.T @ rhs.astype(np.float64)
    xhat = u.T @ np.asarray(x, np.float64)
    xhat_ref = shifted_solves(lap, av, lam, bhat, np.ones(v))

    # Residual per shift; on the singular row only b's consistent part.
    lap64 = sp.csr_matrix(lap)
    r2 = b2 = 0.0
    null = int(np.argmin(np.abs(lam)))
    for a in range(n_time + 1):
        b = bhat[a] - (bhat[a].mean() if a == null else 0.0)
        r = b - (lap64 @ xhat[a] + lam[a] * av * xhat[a])
        r2 += float(r @ r)
        b2 += float(b @ b)
    rel_res = float(np.sqrt(r2 / b2))

    # cond of the worst (singular) row: largest over smallest nonzero
    # eigenvalue of C = av^-1/2 (-L) av^-1/2.
    s = sp.diags(1.0 / np.sqrt(av))
    c = (s @ (-lap64) @ s).tocsc()
    w_max = float(eigsh(c, k=1, which="LA", return_eigenvectors=False)[0])
    delta = 1e-8 * w_max
    w_low = np.sort(eigsh(c, k=2, sigma=-delta, which="LM",
                          return_eigenvectors=False))
    cond = w_max / float(w_low[1])
    return {
        "rel_residual": rel_res,
        "rel_err_vs_spsolve": rel(xhat, xhat_ref),
        "cond": cond,
        "inner_iters": int(iters),
    }


def naive_soc_projection(tri, diag, to_fst, to_mid, to_end):
    """Closed-form projection onto the per-(t, v) cones in float64 NumPy.

    Tail norms are summed with np.bincount over the corner slots (not the
    solver's incidence table); returns (z_fst, z_mid, z_end) with z_mid in
    original coordinates (divided by diag), as `project_soc` does."""
    n_t, n_v = to_fst.shape
    flat = tri.reshape(-1)
    sq = (to_mid * to_mid).sum(axis=(1, 4))  # (T, F, 3)
    norm_sq = np.stack([
        np.bincount(flat, weights=sq[t].reshape(-1), minlength=n_v)
        for t in range(n_t)
    ]) + to_end * to_end
    norm = np.sqrt(norm_sq)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = np.where(
            to_fst >= norm, 1.0,
            np.where(to_fst <= -norm, 0.0, 0.5 * (1.0 + to_fst / norm)),
        )
    z_fst = np.where(lam >= 1.0, to_fst, lam * norm)
    z_end = lam * to_end
    lam_slots = lam[:, tri] / diag  # (T, F, 3)
    z_mid = lam_slots[:, None, :, :, None] * to_mid
    return z_fst, z_mid, z_end


def check_soc_projection(geometry, n_time: int) -> float:
    """Worst relative error of `project_soc` (f32) over its three outputs
    against `naive_soc_projection` (f64), over every cone of the mesh."""
    import jax
    import jax.numpy as jnp

    from dots_socp_tpu.ops.cones import project_soc
    from dots_socp_tpu.ops.mesh_ops import build_surface_ops

    ops = build_surface_ops(
        np.asarray(geometry["vertices"]), np.asarray(geometry["triangles"]),
        dtype=jnp.float32,
    )
    n_v, n_f = ops.av.shape[0], ops.area_f.shape[0]
    rng = np.random.default_rng(3)
    # Heads spread like the tail norms (~sqrt(37)), so all three branches
    # (inside, projected, origin) occur.
    to_fst = (6.0 * rng.standard_normal((n_time, n_v))).astype(np.float32)
    to_mid = rng.standard_normal((n_time, 2, n_f, 3, 3)).astype(np.float32)
    to_end = rng.standard_normal((n_time, n_v)).astype(np.float32)
    got = jax.jit(project_soc)(
        ops, jnp.asarray(to_fst), jnp.asarray(to_mid), jnp.asarray(to_end)
    )
    ref = naive_soc_projection(
        np.asarray(ops.tri), np.asarray(ops.diag_soc, np.float64),
        *(a.astype(np.float64) for a in (to_fst, to_mid, to_end)),
    )
    return max(rel(g, r) for g, r in zip(got, ref))


# ------------------------------------------------------------ end to end ---
class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, with end times."""

    def __init__(self):
        import jax

        self.events = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.events.append((time.perf_counter(), secs))

    def between(self, t0: float, t1: float) -> float:
        return float(sum(s for t, s in self.events if t0 <= t <= t1))


def cli_opts(*argv):
    """Options exactly as `python -m dots_socp_tpu.cli` parses them."""
    from dots_socp_tpu.cli import parse_args

    return parse_args(return_parser=True).parse_args(list(argv))


def solve_plane(clock, n_space, tol, *extra, versus_exact=False) -> dict:
    """One solve through the normal entry point; the numbers a user reads."""
    from dots_socp_tpu.interface import (
        run_dot_surface,
        run_dot_surface_versus_exact,
    )
    from dots_socp_tpu.utils.evaluate import (
        check_mass_conservation,
        check_negative_mass,
    )

    opts = cli_opts(
        "--example=plane", f"--n_space={n_space}", f"--ntime={T}",
        f"--tol={tol}", "--nit=20000", "--outdir=output/chip_smoke", *extra,
    )
    t0 = time.perf_counter()
    if versus_exact:
        solution, _, hist, err, _ = run_dot_surface_versus_exact(
            opts, solver_name="socp"
        )
    else:
        solution, _, hist = run_dot_surface(opts, solver_name="socp")
        err = None
    wall = time.perf_counter() - t0
    kkt = np.asarray(hist.get_current_kkt_errors(), np.float64)
    loop_t0 = hist._start_time
    loop_compile = clock.between(loop_t0, loop_t0 + hist.running_time)
    out = {
        "n_vertices": int(solution["mu"].shape[1]),
        "converged": bool(np.all(kkt <= tol)),
        "iterations": int(hist.last_record_it),
        "kkt": [float(k) for k in kkt],
        "stop_kkt": float(np.max(kkt[STOP_SET])),
        "first_stop_kkt": float(np.nanmax(hist.kkt_errors[0, STOP_SET])),
        "mass_violation": check_mass_conservation(
            np.asarray(solution["mu"]), verbose=False
        ),
        "negative_mass": check_negative_mass(
            np.asarray(solution["mu"]), verbose=False
        )[0],
        "wall_sec": wall,
        "compile_sec": clock.between(t0, t0 + wall),
        "solve_sec": hist.running_time - loop_compile,
    }
    if err is not None:
        out["error_vs_exact"] = {k: float(v) for k, v in err.items()}
    return out


def cg_histogram(n_space: int, laplacian_mode: str = "auto") -> dict:
    """State dtypes of the refined CG problem after a few fused iterations,
    and cold-start inner-CG iterations vs inner rtol on its first RHS."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from dots_socp_tpu.ops.laplacian import cg_solve
    from dots_socp_tpu.solver.step import laplacian_rhs, run_chunk

    config, data, state = graft._build(
        n_space, T, "float32", laplacian_mode=laplacian_mode
    )
    assert config.laplacian_mode == "cg" and config.phi_refine, config
    rhs = laplacian_rhs(config, data, state)
    after = run_chunk(config, data, state, np.int32(3))
    dtypes = {
        name: str(getattr(after, name).dtype)
        for name in ("phi", "A", "B", "mu", "E", "z_mid", "beta_mid")
    }
    solve = jax.jit(
        lambda d, b, t: cg_solve(
            d.ops, d.cg_op, b, rtol=t, max_iters=config.cg_max_iters,
            return_iters=True,
        )
    )
    hist = {}
    for rtol in (1e-3, 1e-4, 1e-5, 2e-6):
        _, iters = solve(data, rhs, jnp.float32(rtol))
        hist[f"{rtol:g}"] = int(iters)
    return {"state_dtypes": dtypes, "cg_iters_by_rtol_cold": hist}


# ----------------------------------------------------------------- phases ---
def phase_b(n_ell=200, n_spectral=64, n_cg=200, n_soc=200, n_time=T) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)  # the f64 checks need it
    hi, tf32 = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
    out = {}
    geometry, lap, av = plane_problem(n_ell)
    out["ell_f32"] = check_ell_matvec(lap, av, n_time, jnp.float32)
    out["ell_f64"] = check_ell_matvec(lap, av, n_time, jnp.float64)
    out["ell_n_vertices"] = int(av.shape[0])
    # f32 sums of <= 8 terms per row: ~8 eps32 relative; f64 likewise.
    ok = out["ell_f32"] <= 1e-5 and out["ell_f64"] <= 1e-12

    _, lap_s, av_s = plane_problem(n_spectral)
    spec = check_spectral_solve(lap_s, av_s, n_time, (hi, tf32))
    out["spectral_highest"] = spec["highest"]
    out["spectral_tf32"] = spec["default"]
    out["spectral_n_vertices"] = int(av_s.shape[0])
    # Bound: the protocol's KKT tolerance (1e-4); a phi error above it keeps
    # the KKT residuals from reaching it. TF32 is reported, not required.
    out["spectral_bound"] = 1e-4
    ok &= out["spectral_highest"] <= out["spectral_bound"]

    if n_cg != n_ell:
        geometry, lap, av = plane_problem(n_cg)
    rtol = 1e-8
    cg = check_refined_cg(geometry, lap, av, n_time, rtol)
    out["cg_refined"] = {"rtol": rtol, **cg}
    # The per-shift stopping rule guarantees sum r^2 <= 2 rtol^2 sum b^2 in
    # f64; 10 x rtol leaves room for the final f64 transforms. The distance
    # from the direct solve is bounded by cond x that residual.
    ok &= cg["rel_residual"] <= 10 * rtol
    ok &= cg["rel_err_vs_spsolve"] <= 10 * rtol * cg["cond"]

    if n_soc != n_cg:
        geometry, _, _ = plane_problem(n_soc)
    out["soc"] = check_soc_projection(geometry, n_time)
    # f32 sums of squares over <= ~40 tail entries, then one sqrt/divide.
    ok &= out["soc"] <= 1e-6
    out["ok"] = bool(ok)
    return out


# Mass conservation is the discrete continuity equation, which the solver
# meets to its primal-feasibility tolerance: at tol=1e-4 the CPU runs of
# phases C and E leave 1.6e-6 and 1.7e-6. Allowed: tol / 10. Negative mass
# is f32 rounding around zero densities (4.7e-8 on the CPU).
MASS_TOL = 1e-5
NEGATIVE_MASS_TOL = 1e-6


def mass_ok(r) -> bool:
    return (r["mass_violation"] <= MASS_TOL
            and r["negative_mass"] <= NEGATIVE_MASS_TOL)


def phase_c(clock, n_space=64) -> dict:
    r = solve_plane(clock, n_space, 1e-4, "--precision=float32")
    r["ok"] = bool(r["converged"] and mass_ok(r))
    return r


def phase_d(clock, n_space=200, laplacian_mode="auto") -> dict:
    r = solve_plane(
        clock, n_space, 1e-4, "--precision=float32",
        f"--laplacian_mode={laplacian_mode}",
    )
    r.update(cg_histogram(n_space, laplacian_mode))
    dt = dict(r["state_dtypes"])
    dtypes_ok = dt.pop("phi") == "float64" and set(dt.values()) == {"float32"}
    r["ok"] = bool(r["converged"] and dtypes_ok and mass_ok(r))
    return r


def phase_e(clock, n_space=50) -> dict:
    r = solve_plane(
        clock, n_space, 1e-4, "--precision=float64", versus_exact=True
    )
    ratios = {
        k: r["error_vs_exact"][k] / E_CPU_REFERENCE[k]
        for k in ("l1", "l2", "linf")
    }
    r["error_ratio_vs_cpu"] = ratios
    # Same f64 algorithm on both sides: only the summation order differs,
    # which moves the iterate at which tol is first met by a few iterations.
    r["ok"] = bool(
        r["converged"] and all(1 / 1.5 <= q <= 1.5 for q in ratios.values())
    )
    return r


def phase_four_cards(clock, n_space=200, laplacian_mode="auto") -> dict:
    """The space-sharded solve on a 1x4 mesh beside the one-card solve."""
    import jax

    import __graft_entry__ as graft
    from dots_socp_tpu.parallel import make_solver_mesh
    from dots_socp_tpu.parallel.mesh import shard_problem, shard_state

    opts = ("--precision=float32", f"--laplacian_mode={laplacian_mode}")
    one = solve_plane(clock, n_space, 1e-4, *opts)
    four = solve_plane(clock, n_space, 1e-4, *opts, "--mesh_shape=1x4")
    # Where the state lives: every field on all four cards, sharded ones
    # holding a quarter of the vertex/triangle axis each.
    config, data, state = graft._build(
        n_space, T, "float32", space_partitions=4, mesh_axes=(1, 4),
        laplacian_mode=laplacian_mode,
    )
    mesh = make_solver_mesh("1x4")
    state = shard_state(mesh, state)
    data = shard_problem(mesh, data)
    placement = {
        name: {
            "devices": len(arr.sharding.device_set),
            "shape": list(arr.shape),
            "shard": list(arr.addressable_shards[0].data.shape),
        }
        for name, arr in zip(state._fields, state)
        if arr.ndim >= 2
    }
    on_all = all(p["devices"] == 4 for p in placement.values()) and all(
        len(leaf.sharding.device_set) == 4 for leaf in jax.tree.leaves(data)
    )
    # Shards reduce in another order than one card, so the iterates differ
    # at rounding level and a validation can land a few iterations apart.
    close = abs(four["iterations"] - one["iterations"]) <= max(
        10, 0.05 * one["iterations"]
    )
    return {
        "one_card": one,
        "four_cards": four,
        "placement": placement,
        "ok": bool(one["converged"] and four["converged"] and close and on_all),
    }


# ------------------------------------------------------------------- main ---
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 1x4 space-sharded solve and the "
                    "one-card solve it is compared with (needs 4 GPUs)")
    args = ap.parse_args(argv)

    try:
        import jax

        import dots_socp_tpu.ops  # noqa: F401  (matmul precision, cache)
    except ImportError as exc:
        print(f"chip_smoke: cannot import the solver: {exc}", file=sys.stderr)
        return 1
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {backend!r}",
              file=sys.stderr)
        return 1
    devices = jax.devices()
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 1

    cards = card_lines()
    card = cards[0] if cards else "nvidia-smi unavailable"
    clock = CompileClock()
    results = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            rec = fn(*a)
        except Exception as exc:  # report the phase, run the others
            import traceback

            traceback.print_exc()
            rec = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        rec = {"phase": name, "card": card, **rec,
               "phase_sec": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        results.append(rec["ok"])

    run("A", lambda: {
        "ok": True,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "jax": jax.__version__,
        "cards": cards,
        "matmul_precision": str(jax.config.jax_default_matmul_precision),
    })
    if args.four_cards:
        run("four_cards", phase_four_cards, clock)
    else:
        run("C", phase_c, clock)
        run("B", phase_b)
        run("D", phase_d, clock)
        run("E", phase_e, clock)

    for line in cards[:n_cards]:
        print(line)
    if not all(results):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
