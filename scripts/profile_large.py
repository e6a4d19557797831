"""Attribute the per-iteration cost of the large-mesh CG+refine solve.

This driver times each component of the fused iteration on the device as
dependent chains in single dispatches (warmed up, timed to
block_until_ready), and (optionally) captures a jax.profiler trace of the
production chunk.

Components (see solver/step.py::iteration):
  iteration       the whole fused iALM step (the production unit)
  laplacian_rhs   RHS assembly (div_time + div_space of weighted residuals)
  cg_solve        step 1a phi solve: refine pass(es) around the f32 ELL CG
  proj_soc        step 1b batched SOC projection over (T,2,3,F,3)
  q_dual          steps 2-3: gradients, closed-form q/lambda, dual ascent
  kkt_table       the fused 7-residual dual-valued KKT table

Usage: python scripts/profile_large.py --n_space 200 --ntime 31
"""

import argparse
import json
import os
import sys
import time

# Self-bootstrap: runnable without PYTHONPATH.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--profile_dir", default=None,
                    help="also capture a jax.profiler trace of the "
                    "production run_chunk here")
    ap.add_argument("--cg_rtol", type=float, default=None,
                    help="pin the inner CG rtol for the component chains "
                    "(production adapts 0.05*KKT-error in [2e-6, 1e-3]; "
                    "the build default 1e-9 over-solves)")
    ap.add_argument("--cg_deflation_k", type=int, default=None,
                    help="override the Ritz-deflation rank (default: "
                    "min(256, max(64, V/256)))")
    ap.add_argument("--cg_slope", action="store_true",
                    help="measure the per-inner-CG-iteration cost: time "
                    "fixed-iteration-count solves at max_iters 5 vs 30 "
                    "(unreachable rtol) and difference")
    ap.add_argument("--f64_solve_race", action="store_true",
                    help="also time the f64 phi solve: refined (f32 ELL "
                    "inner CG) vs plain all-f64 ELL CG")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as graft
    from dots_socp_tpu.solver.kkt import kkt_table
    from dots_socp_tpu.solver.step import (
        iteration,
        laplacian_rhs,
        solve_laplacian,
        solve_proj_soc,
        solve_q_lambda,
    )
    from dots_socp_tpu.ops.mesh_ops import grad_space
    from dots_socp_tpu.ops.time_stencils import grad_time
    from dots_socp_tpu.solver.problem import host_device

    build_kw = {}
    if args.cg_deflation_k is not None:
        build_kw["cg_deflation_k"] = args.cg_deflation_k
    config, data, state = graft._build(
        args.n_space, args.ntime, "float32", **build_kw
    )
    if args.cg_rtol is not None and data.cg_op is not None:
        data = data._replace(
            cg_op=data.cg_op._replace(
                rtol=jnp.asarray(args.cg_rtol, dtype=config.jnp_dtype)
            )
        )
    v_real = config.n_vertices_real

    def timed_chain(fn, label, iters=None):
        """Time `iters` dependent applications of fn(state)->state in one
        warmed-up dispatch."""
        iters = iters or args.iters

        @jax.jit
        def chain(d, s, n):
            return jax.lax.fori_loop(0, n, lambda _, x: fn(d, x), s)

        jax.block_until_ready(chain(data, state, np.int32(iters)))
        t0 = time.perf_counter()
        jax.block_until_ready(chain(data, state, np.int32(iters)))
        ms = (time.perf_counter() - t0) / iters * 1e3
        print(f"  {label:14s}: {ms:8.2f} ms", flush=True)
        return round(ms, 3)

    eps = 1e-30  # keeps the chain dependent without changing magnitudes

    def it_fn(d, s):
        return iteration(config, d, s)

    def rhs_fn(d, s):
        rhs = laplacian_rhs(config, d, s)
        return s._replace(mu=s.mu + eps * rhs[1:])

    def cg_fn(d, s):
        phi = solve_laplacian(config, d, s)
        return s._replace(phi=phi, mu=s.mu + eps * phi[1:].astype(s.mu.dtype))

    def soc_fn(d, s):
        z_fst, z_mid, z_end = solve_proj_soc(config, d, s)
        return s._replace(
            z_fst=z_fst, z_mid=z_mid, z_end=z_end, A=s.A + eps * z_fst
        )

    def q_dual_fn(d, s):
        # Steps 2-3 at fixed phi: gradients + closed-form q/lambda + ascent.
        wd = config.jnp_dtype
        dt_phi = grad_time(config.stepsize_time, s.phi).astype(wd)
        dx_phi = grad_space(d.ops, s.phi, lead=(None,)).astype(wd)
        A, B, lambda_c = solve_q_lambda(config, s, dt_phi, dx_phi)
        mu = s.mu + s.tau * (dt_phi - A - lambda_c)
        E = s.E + s.tau * (dx_phi - B)
        return s._replace(A=A, B=B, lambda_c=lambda_c, mu=mu, E=E)

    def kkt_fn(d, s):
        table = kkt_table(config, d, s)
        return s._replace(mu=s.mu + eps * table[0, 0])

    # Settle the state a little first so CG warm starts resemble production.
    from dots_socp_tpu.solver.step import run_chunk

    state = run_chunk(config, data, state, np.int32(20))
    np.asarray(state.phi)[0, 0]

    print(f"per-component times (V={v_real}, T={args.ntime}, f32+refine, "
          f"{args.iters}-chain):", flush=True)
    results = {}
    results["iteration_ms"] = timed_chain(it_fn, "iteration")
    results["cg_solve_ms"] = timed_chain(cg_fn, "cg_solve")
    results["proj_soc_ms"] = timed_chain(soc_fn, "proj_soc")
    results["laplacian_rhs_ms"] = timed_chain(rhs_fn, "laplacian_rhs")
    results["q_dual_ms"] = timed_chain(q_dual_fn, "q_dual")
    results["kkt_table_ms"] = timed_chain(kkt_fn, "kkt_table")
    results["unattributed_ms"] = round(
        results["iteration_ms"]
        - results["cg_solve_ms"]
        - results["proj_soc_ms"]
        - results["q_dual_ms"],
        3,
    )

    if args.cg_slope and data.cg_op is not None:
        from dots_socp_tpu.ops.laplacian import cg_solve

        rhs0 = laplacian_rhs(config, data, state)
        times = {}
        for m in (5, 30):
            @jax.jit
            def fixed(d, b, m=m):
                # refine off (x0/rtol force the plain path): pin the inner
                # pcg cost alone. rtol unreachable -> always m iterations.
                op = d.cg_op._replace(
                    ell_w_hi=None, av_hi=None, shifts_hi=None, u_time_hi=None
                )
                return cg_solve(
                    d.ops, op, b, max_iters=m,
                    rtol=jnp.asarray(1e-12, b.dtype),
                )

            np.asarray(fixed(data, rhs0))[0, 0]
            t0 = time.perf_counter()
            for _ in range(5):
                np.asarray(fixed(data, rhs0))[0, 0]
            times[m] = (time.perf_counter() - t0) / 5
        slope_ms = (times[30] - times[5]) / 25 * 1e3
        fixed_ms = times[5] * 1e3 - 5 * slope_ms
        results["cg_inner_iter_ms"] = round(slope_ms, 3)
        results["cg_fixed_overhead_ms"] = round(fixed_ms, 3)
        print(f"  cg inner-iter : {slope_ms:8.3f} ms/iter, "
              f"fixed {fixed_ms:.2f} ms", flush=True)

    if args.f64_solve_race:
        from dots_socp_tpu.ops.laplacian import build_cg_operator, cg_solve
        from dots_socp_tpu.geometry.surface import (
            cotan_laplacian,
            triangle_quantities,
        )
        from dots_socp_tpu.data.loader import load_example
        from dots_socp_tpu.geometry.normalize import normalize_geometry

        # The race compares f64 solves: x64 must be on BEFORE rhs64 is
        # created (the main _build only enables it when phi_refine engaged;
        # in spectral / refine-off configs rhs64 would silently downcast to
        # f32 and the "plain_f64_ell" lane would time an f32 solve).
        jax.config.update("jax_enable_x64", True)

        _, geometry, _ = load_example(
            example_name="plane",
            kwargs_generating_mesh={"n": args.n_space},
        )
        geometry, _ = normalize_geometry(geometry)
        vtx = np.asarray(geometry["vertices"])
        tri = np.asarray(geometry["triangles"])
        _, angles, _ = triangle_quantities(vtx, tri)
        lap = cotan_laplacian(tri, angles, vtx.shape[0])
        av = np.asarray(data.ops.av)[: vtx.shape[0]]
        rhs64 = jnp.asarray(
            np.asarray(laplacian_rhs(config, data, state))[:, : vtx.shape[0]],
            dtype=jnp.float64,
        )
        assert rhs64.dtype == jnp.float64, rhs64.dtype
        ops64 = None
        race = {}
        for name, kw in (
            ("refined_f32_ell", dict(refine=True)),
            ("plain_f64_ell", dict(refine=False)),
        ):
            with jax.default_device(host_device()):
                op = build_cg_operator(
                    args.ntime, config.stepsize_time, av, lap,
                    dtype=jnp.float64, deflation_k=128, rtol=1e-8, **kw,
                )
            op = jax.device_put(op, jax.devices()[0])
            from dots_socp_tpu.ops.mesh_ops import build_surface_ops

            if ops64 is None:
                with jax.default_device(host_device()):
                    ops64 = build_surface_ops(vtx, tri, dtype=jnp.float64)
                ops64 = jax.device_put(ops64, jax.devices()[0])

            @jax.jit
            def solve(o, b):
                return cg_solve(ops64, o, b, max_iters=400, rtol=1e-8)

            np.asarray(solve(op, rhs64))[0, 0]
            t0 = time.perf_counter()
            for _ in range(3):
                np.asarray(solve(op, rhs64))[0, 0]
            race[name] = round((time.perf_counter() - t0) / 3 * 1e3, 1)
            print(f"  f64 solve {name}: {race[name]} ms", flush=True)
        results["f64_solve_race_ms"] = race

    if args.profile_dir:
        with jax.profiler.trace(args.profile_dir):
            s = run_chunk(config, data, state, np.int32(20))
            np.asarray(s.phi)[0, 0]
        results["profile_dir"] = args.profile_dir

    print(json.dumps(
        {
            "metric": f"per-iteration attribution (plane n{args.n_space}, "
            f"V={v_real}, T={args.ntime}, CG+refine path)",
            **results,
        }
    ), flush=True)


if __name__ == "__main__":
    main()
