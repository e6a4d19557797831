"""Large-mesh throughput benchmark for the matrix-free CG Laplacian path.

The spectral path densifies the (V, V) eigenbasis and hits an O(V^2) memory
wall around V ~ 16k; beyond that the solver switches to the batched
preconditioned-CG path (`ops/laplacian.py:build_cg_operator`). This script
measures sustained fused-iteration throughput of that path on a large plane
mesh (V chosen via --n_space) on the device, and prints one JSON line.

Usage: python scripts/bench_large.py --n_space 290 --n_time 31 --iters 200
"""

import argparse
import json
import logging
import os
import sys
import time

# Self-bootstrap: runnable without PYTHONPATH (round-3 lost a chip run to a
# bare `python scripts/...` invocation failing the package import).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(n_space: int, n_time: int, dtype: str, cg_max_iters: int):
    # One construction path: __graft_entry__._build threads every state
    # field (incl. the f64 phi under phi_refine) so this script cannot
    # drift from the production iteration it benchmarks.
    logging.disable(logging.CRITICAL)
    import __graft_entry__ as graft

    return graft._build(
        n_space,
        n_time,
        dtype,
        laplacian_mode="cg",
        cg_max_iters=cg_max_iters,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=290)
    ap.add_argument("--n_time", type=int, default=31)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--cg_max_iters", type=int, default=30)
    args = ap.parse_args()

    import numpy as np

    t_setup = time.perf_counter()
    config, data, state = build(
        args.n_space, args.n_time, args.dtype, args.cg_max_iters
    )
    t_setup = time.perf_counter() - t_setup

    import jax

    from dots_socp_tpu.solver.kkt import compute_kkt
    from dots_socp_tpu.solver.step import run_chunk

    t_compile = time.perf_counter()
    state = jax.block_until_ready(run_chunk(config, data, state, np.int32(2)))
    t_compile = time.perf_counter() - t_compile

    t0 = time.perf_counter()
    state = jax.block_until_ready(
        run_chunk(config, data, state, np.int32(args.iters))
    )
    elapsed = time.perf_counter() - t0

    kkt = np.asarray(compute_kkt(config, data, state))
    assert np.all(np.isfinite(kkt[:, 0])), f"diverged: {kkt}"

    print(
        json.dumps(
            {
                "metric": (
                    f"iALM iterations/s, CG path (plane n{args.n_space}: "
                    f"V={config.n_vertices_real}, F={config.n_triangles_real}, "
                    f"T={args.n_time}, {args.dtype}, "
                    f"cg_max_iters={args.cg_max_iters})"
                ),
                "value": round(args.iters / elapsed, 3),
                "unit": "iter/s",
                "sec_per_iter": round(elapsed / args.iters, 5),
                "setup_sec": round(t_setup, 1),
                "compile_sec": round(t_compile, 1),
                "kkt_stop_error": float(np.max(kkt[[0, 2, 4, 5], 0])),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
