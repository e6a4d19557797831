"""Measure the SPACE-SHARDED large-mesh CG path on a virtual device mesh.

Two layouts of one full CG phi-solve:

  (a) halo_blocked : BFS-blocked layout, halo-exchange incidence matvec
  (b) gspmd_raw : raw-order GSPMD layout (partitionable incidence form)

The compiled program's collective bytes per solve are the layout truth;
virtual-mesh wall time only bounds relative cost.

Runs on CPU with XLA_FLAGS=--xla_force_host_platform_device_count=N
(set by this script before importing jax).

Usage: python scripts/bench_sharded_cg.py --n_space 200 --n_devices 8
"""

import argparse
import json
import os
import re
import sys
import time

# Self-bootstrap + virtual mesh BEFORE jax import.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--n_devices", type=int, default=8)
    ap.add_argument("--cg_rtol", type=float, default=1e-4)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.n_devices}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry
    from dots_socp_tpu.ops.laplacian import cg_solve
    from dots_socp_tpu.ops.mesh_ops import grad_space
    from dots_socp_tpu.ops.time_stencils import decouple_space_adjoint, grad_time
    from dots_socp_tpu.parallel.mesh import make_mesh, shard_problem, shard_state
    from dots_socp_tpu.solver.problem import build_problem
    from dots_socp_tpu.solver.state import init_state
    from dots_socp_tpu.solver.step import laplacian_rhs

    width = {"f64": 8, "f32": 4, "s32": 4, "u32": 4, "pred": 1, "s64": 8}

    def collective_bytes(txt):
        total = 0
        for kind in ("all-gather", "all-reduce", "all-to-all",
                     "collective-permute", "reduce-scatter"):
            for m in re.finditer(
                r"(\w+)\[([\d,]*)\][^=]*\b" + kind + r"\(", txt
            ):
                n = 1
                for d in m.group(2).split(","):
                    if d:
                        n *= int(d)
                total += n * width.get(m.group(1), 8)
        return total

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": args.n_space}
    )
    geometry, _ = normalize_geometry(geometry)
    mesh = make_mesh(args.n_devices, time_axis=1)

    results = {}
    for label, kwargs in (
        ("halo_blocked",
         dict(space_partitions=args.n_devices, pad_multiple=1,
              mesh_axes=(1, args.n_devices))),
        ("gspmd_raw",
         dict(space_partitions=1, pad_multiple=8 * args.n_devices,
              mesh_axes=(1, args.n_devices))),
    ):
        config, data, extras = build_problem(
            args.ntime, geometry, dtype="float32", laplacian_mode="cg",
            cg_rtol=args.cg_rtol, **kwargs,
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
        data = shard_problem(mesh, data)
        state = shard_state(mesh, state)
        spmd = config.spmd_kwargs(data)
        space_sharded = not spmd  # raw layout: no halo tables

        def solve(data, state):
            rhs = laplacian_rhs(config, data, state)
            return cg_solve(
                data.ops, data.cg_op, rhs, x0=state.phi,
                max_iters=config.cg_max_iters, rtol=None,
                space_sharded=space_sharded, return_iters=True,
                ops_hi=data.ops_hi, **spmd,
            )

        fn = jax.jit(solve)
        lowered = fn.lower(data, state)
        compiled = lowered.compile()
        bytes_total = collective_bytes(compiled.as_text())

        x, iters = fn(data, state)  # warm
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            x, iters = fn(data, state)
            jax.block_until_ready(x)
        per_solve = (time.perf_counter() - t0) / args.repeats
        inner = int(iters)

        results[label] = {
            "collective_bytes_per_cg_solve": int(bytes_total),
            "wall_sec_per_cg_solve_virtual_cpu_mesh": round(per_solve, 4),
            "inner_iterations": inner,
            "wall_ms_per_matvec_virtual_cpu_mesh": round(
                per_solve / max(inner, 1) * 1e3, 3
            ),
            "v_padded": config.n_vertices,
        }
        print(json.dumps({label: results[label]}), flush=True)

    halo = results["halo_blocked"]["collective_bytes_per_cg_solve"]
    raw = results["gspmd_raw"]["collective_bytes_per_cg_solve"]
    print(
        json.dumps(
            {
                "metric": (
                    f"sharded CG phi-solve (plane n{args.n_space}, "
                    f"T={args.ntime}, f32, 1x{args.n_devices} virtual mesh)"
                ),
                "layouts": results,
                "halo_vs_raw_collective_bytes": round(halo / max(raw, 1), 4),
                }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
