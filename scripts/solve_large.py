"""Large-mesh solve TO CONVERGENCE on the device (not an it/s proxy).

Runs the full production solver (auto -> matrix-free CG path with adaptive
inexact-ALM inner rtol and the padded-ELL SpMV) on a large plane mesh to
tol, reporting wall clock, iteration count, and the KKT trajectory through
the standard history blocks; then measures the CG inner-iteration count at
a grid of inner tolerances on the same problem (the "CG histogram").

Usage: python scripts/solve_large.py --n_space 200 --ntime 31 --tol 1e-4
"""

import argparse
import json
import os
import sys
import time

# Self-bootstrap: runnable without PYTHONPATH (round-3 lost a chip run to a
# bare `python scripts/...` invocation failing the package import).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--nit", type=int, default=20000)
    ap.add_argument("--time_limit", type=float, default=3000)
    ap.add_argument("--log_file", default=None)
    ap.add_argument("--skip_histogram", action="store_true")
    ap.add_argument("--snapshot", default=None,
                    help="crash-safe state snapshot path (resumes if present)")
    ap.add_argument("--snapshot_every", type=float, default=120.0,
                    help="seconds between snapshots; each one fetches the "
                    "whole state to the host (multi-GB at V>=195k)")
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "float64"],
                    help="solver dtype; at V>=46k the f32 roundoff floor "
                    "(~eps * 1/h^2) sits above tol=1e-4, so converged "
                    "large-mesh solves need float64")
    ap.add_argument("--phi_refine", default="auto",
                    choices=["auto", "on", "off"],
                    help="mixed-precision phi (f64 state.phi + f64 iterative "
                    "refinement around the f32 inner CG)")
    ap.add_argument("--cg_rtol", type=float, default=None,
                    help="fixed CG inner rtol (default: adaptive inexact-ALM "
                    "schedule tied to the current KKT error)")
    ap.add_argument("--sigma_freeze_error", type=float, default=None,
                    help="sticky sigma freeze threshold (see solver_socp)")
    ap.add_argument("--max_chunk", type=int, default=128,
                    help="iterations per device dispatch (bounds the "
                    "granularity of time_limit and snapshot checks)")
    args = ap.parse_args()

    import numpy as np

    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry
    from dots_socp_tpu.interface import set_logging_level
    from dots_socp_tpu.solver import solver_socp

    set_logging_level(log_level="kkt", log_file=args.log_file)

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": args.n_space}
    )
    geometry, _ = normalize_geometry(geometry)

    t0 = time.perf_counter()
    solution, history = solver_socp(
        args.ntime,
        geometry,
        nit=args.nit,
        tol=args.tol,
        time_limit=args.time_limit,
        precision=args.precision,
        phi_refine=args.phi_refine,
        cg_rtol=args.cg_rtol,
        sigma_freeze_error=args.sigma_freeze_error,
        max_chunk=args.max_chunk,
        snapshot_path=args.snapshot,
        snapshot_every=args.snapshot_every,
    )
    wall = time.perf_counter() - t0
    history.print_end_history()
    history.print_steps_time()

    kkt = history.get_current_kkt_errors()
    recorded = np.asarray(history.kkt_iteration)
    recorded = recorded[np.isfinite(recorded)]
    iterations = int(recorded[-1]) if recorded.size else 0
    result = {
        "metric": (
            f"large-mesh solve to tol={args.tol:g} "
            f"(plane n{args.n_space}, T={args.ntime}, "
            f"{'f64' if args.precision == 'float64' else 'f32/refine=' + args.phi_refine}, CG path)"
        ),
        "wall_sec": round(wall, 1),
        "iterations": iterations,
        "iters_per_sec": round(iterations / wall, 2),
        "kkt_stop_error": float(np.nanmax(np.asarray(kkt)[[0, 2, 4, 5]])),
        "converged": bool(np.all(np.asarray(kkt) < args.tol)),
    }

    if not args.skip_histogram:
        # CG inner-iteration count vs inner rtol on this problem: the first
        # outer iteration's RHS, cold-started (upper bound; warm starts in
        # the loop re-use the previous phi).
        import jax

        from dots_socp_tpu.ops.laplacian import cg_solve
        from dots_socp_tpu.ops.mesh_ops import grad_space
        from dots_socp_tpu.ops.time_stencils import (
            decouple_space_adjoint,
            grad_time,
        )
        from dots_socp_tpu.solver.problem import build_problem, host_device
        from dots_socp_tpu.solver.state import init_state
        from dots_socp_tpu.solver.step import laplacian_rhs

        with jax.default_device(host_device()):
            config, data, extras = build_problem(
                args.ntime, geometry, dtype="float32", laplacian_mode="cg",
            )
            dt = config.stepsize_time
            ops = data.ops
            state = init_state(
                args.ntime, config.n_vertices, config.n_triangles,
                extras["mu0_padded"], extras["mu1_padded"], dt,
                grad_time_fn=lambda p: grad_time(dt, p),
                grad_space_fn=lambda p: grad_space(ops, p),
                decouple_adjoint_fn=decouple_space_adjoint,
                dtype=config.jnp_dtype,
            )
        dev = jax.local_devices()[0]
        if dev.platform != "cpu":
            data, state = jax.device_put((data, state), dev)
        rhs = laplacian_rhs(config, data, state)
        hist = {}
        for rtol in (1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 2e-6):
            _, iters = jax.jit(
                lambda r, t: cg_solve(
                    data.ops, data.cg_op, r, rtol=t,
                    max_iters=400, return_iters=True,
                )
            )(rhs, np.float32(rtol))
            hist[f"{rtol:g}"] = int(iters)
        result["cg_iters_by_rtol_cold"] = hist

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
