"""Race the Laplacian SpMV implementations on the GPU.

Variants (all computing L_space @ x for x of shape (T+1, V)):
  graddiv : matrix-free div(area * grad(x)) through triangle incidence
  ell     : padded-ELL row-layout neighbor gather (the CG path's matvec)
  banded  : RCM block-banded dense tiles, shifted batched matmuls

Each variant is timed as a chain of `iters` dependent applications
y <- x0 + c * (L @ y) inside one dispatch (c = 1/(4 max|L_ii|) keeps the
chain bounded; XLA fuses the axpy into the matvec), warmed up first and
timed to block_until_ready. The chain is unrolled in the program: a
`fori_loop` with a traced trip count is a while loop, and on the GPU each
trip waits ~50 us for its predicate to reach the host, which would swamp a
matvec of a few tens of us. The ELL variant also reports its HBM bytes per
application (indices, weights, x0, y in and out) and the least time they
take at the H100's 3.35 TB/s, and the bytes its neighbour-row gathers touch
(mostly served from L2). Last, the mixed-precision refinement's fixed work
per pass (`cg_solve` with f64 leaves): the f64 true-residual matvec and the
pair of f64 (T+1)x(T+1) time transforms.

Usage: python scripts/bench_matvec.py --n_space 200 --n_time 31 --iters 50
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HBM_GBS = 3350.0  # H100 SXM data sheet; the floor below divides by it

# Self-bootstrap: runnable without PYTHONPATH (round-3 lost a chip run to a
# bare `python scripts/...` invocation failing the package import).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--n_time", type=int, default=31)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--skip", default="", help="comma-separated variants")
    args = ap.parse_args()

    import jax

    # Must precede building the operator pytrees: f64 leaves created while
    # x64 is off silently downcast to f32 (build_cg_operator enables the
    # flag itself, but by then build_surface_ops has already materialized
    # its leaves).
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from dots_socp_tpu.geometry.generators import generate_plane_mesh
    from dots_socp_tpu.geometry.surface import (
        cotan_laplacian,
        triangle_quantities,
    )
    from dots_socp_tpu.ops.laplacian import (
        banded_matvec,
        build_banded_operator,
        build_cg_operator,
        ell_matvec,
    )
    from dots_socp_tpu.ops.mesh_ops import build_surface_ops, laplacian_apply
    from dots_socp_tpu.solver.problem import host_device

    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64
    vertices, triangles, _ = generate_plane_mesh(n=args.n_space)
    v = vertices.shape[0]
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, v)

    skip = set(filter(None, args.skip.split(",")))
    with jax.default_device(host_device()):
        ops = build_surface_ops(vertices, triangles, dtype=dtype)
        cg_op = build_cg_operator(
            args.n_time, 1.0 / args.n_time, np.asarray(ops.av), lap,
            dtype=dtype, deflation_k=0, refine=True,
        )
        band = (
            None if "banded" in skip
            else build_banded_operator(lap, dtype=dtype)
        )
    dev = jax.devices()[0]
    ops, cg_op, band = jax.device_put((ops, cg_op, band), dev)

    rng = np.random.default_rng(0)
    x0 = jax.device_put(
        jnp.asarray(
            rng.standard_normal((args.n_time + 1, v)), dtype=dtype
        ),
        dev,
    )

    # (operator pytree, matvec). The operator is a jit ARGUMENT, not a
    # closure capture: captured arrays would be baked into the program as
    # constants.
    variants = {
        "graddiv": (ops, laplacian_apply),
        "ell": (cg_op, lambda o, y: ell_matvec(o, y)),
        "banded": (band, lambda o, y: banded_matvec(o, y)),
    }
    for name in skip:
        variants.pop(name, None)
    c = 0.25 / float(np.abs(lap.diagonal()).max())

    def time_chain(op_tree, step, x0):
        """us per application of y <- step(o, x0, y) chained `iters` times."""
        @jax.jit
        def chain(o, y0):
            y = y0
            for _ in range(args.iters):
                y = step(o, y0, y)
            return y

        jax.block_until_ready(chain(op_tree, x0))
        t0 = time.perf_counter()
        jax.block_until_ready(chain(op_tree, x0))
        return (time.perf_counter() - t0) / args.iters * 1e6

    results = {}
    for name, (op_tree, mv) in variants.items():
        results[name] = time_chain(
            op_tree, lambda o, y0, y, mv=mv: y0 + c * mv(o, y), x0
        )

    extra = {}
    if "ell" in results:
        item = np.dtype(args.dtype).itemsize
        width = int(cg_op.ell_idx.shape[1])
        lanes = args.n_time + 1
        hbm = v * width * (4 + item) + 3 * v * lanes * item
        floor_us = hbm / (HBM_GBS * 1e3)
        extra["ell"] = {
            "width": width,
            "hbm_bytes": hbm,
            "gathered_bytes": v * width * lanes * item,
            "floor_us": floor_us,
            "share_of_floor": floor_us / results["ell"],
        }

    def residual_f64(o, y0, y):
        lap_y = ell_matvec(o, y, weights=o.ell_w_hi)
        return y0 + c * (lap_y + o.shifts_hi[:, None] * o.av_hi[None, :] * y)

    def transforms_f64(o, y0, y):
        return o.u_time_hi.T @ (o.u_time_hi @ y)

    x64 = x0.astype(jnp.float64)
    extra["refine_fixed_cost_us"] = {
        "true_residual_matvec_f64": time_chain(cg_op, residual_f64, x64),
        "time_transform_pair_f64": time_chain(cg_op, transforms_f64, x64),
    }

    # Cross-check the variants agree numerically (one application each).
    outs = [
        np.asarray(
            jax.jit(lambda o, y, f=mv: f(o, y))(op_tree, x0)
        )
        for op_tree, mv in variants.values()
    ]
    agree = max(
        (float(np.max(np.abs(outs[0] - o))) for o in outs[1:]), default=0.0
    )
    print(
        json.dumps(
            {
                "metric": f"Laplacian SpMV time (V={v}, T={args.n_time}, "
                f"{args.dtype})",
                "unit": "us/matvec",
                "variants": results,
                "max_disagreement": agree,
                "band_diagonals": int(band.blocks.shape[0]) if band else None,
                **extra,
                "device": jax.devices()[0].device_kind,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
