"""Benchmark: iALM iteration throughput on the standard config, one GPU.

Runs the flagship problem (plane example at replication scale: ntime=31,
comparable vertex count to the reference benchmark meshes) and measures
fused-iteration throughput, then prints ONE JSON line:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

vs_baseline compares against the reference implementation's measured
per-iteration wall time on this host's CPU (same problem, same iteration
count), i.e. value / reference_iterations_per_sec. The reference runs via
the dependency shims in tests/reference_shims (numexpr -> numpy eval).

Refuses to run (exit 1, no result line) when JAX finds no GPU: a CPU
number is never reported under a device metric.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

N_SPACE = 64          # plane mesh: ~4.8k vertices, ~9.3k triangles
N_TIME = 31           # replication protocol (Makefile --ntime=31)
BENCH_ITERS = 5000    # measured fused iterations, one device dispatch
REF_ITERS = 12        # reference iterations to time (CPU, slow)


def build(n_space=N_SPACE, n_time=N_TIME, dtype="float32"):
    import logging

    logging.disable(logging.CRITICAL)
    import __graft_entry__ as graft

    return graft._build(n_space, n_time, dtype)


def timed_chunk(config, data, state, n_iters):
    """Run `n_iters` fused iterations; (state, seconds until done)."""
    import jax

    from dots_socp_tpu.solver.step import run_chunk

    t0 = time.perf_counter()
    state = jax.block_until_ready(run_chunk(config, data, state, np.int32(n_iters)))
    return state, time.perf_counter() - t0


def bench_flagship():
    from dots_socp_tpu.solver.kkt import compute_kkt

    config, data, state = build()
    # Warm up / compile (the trip count is traced: one program for all n).
    state, _ = timed_chunk(config, data, state, 2)
    _ = np.asarray(compute_kkt(config, data, state))

    state, elapsed = timed_chunk(config, data, state, BENCH_ITERS)
    kkt = np.asarray(compute_kkt(config, data, state))
    assert np.all(np.isfinite(kkt[:, 0])), f"bench run diverged: {kkt}"
    return BENCH_ITERS / elapsed, config


LARGE_N_SPACE = 200   # plane n200: V=46,431 -- the CG-path size
LARGE_ITERS = 200     # fixed fused-iteration window
MATVEC_ITERS = 50


def bench_large():
    """Sustained it/s of the production CG+refine path at V=46k, plus the
    padded-ELL SpMV us/matvec (the CG inner loop's matvec)."""
    import jax
    import jax.numpy as jnp

    from dots_socp_tpu.ops.laplacian import ell_matvec

    config, data, state = build(LARGE_N_SPACE, N_TIME)
    assert config.laplacian_mode == "cg", config.laplacian_mode

    state, _ = timed_chunk(config, data, state, 2)
    state, elapsed = timed_chunk(config, data, state, LARGE_ITERS)
    result = {
        "iters_per_sec": round(LARGE_ITERS / elapsed, 3),
        "n_vertices": config.n_vertices_real,
        "phi_refine": bool(config.phi_refine),
    }

    op = data.cg_op
    rng = np.random.default_rng(0)
    x0 = jax.device_put(
        jnp.asarray(
            rng.standard_normal((N_TIME + 1, config.n_vertices)),
            dtype=jnp.float32,
        ),
        jax.devices()[0],
    )

    @jax.jit
    def chain(o, y, n):
        def body(_, y):
            y = ell_matvec(o, y, weights=o.ell_w.astype(jnp.float32))
            return y * jax.lax.rsqrt(jnp.sum(y * y) + 1e-30)

        return jax.lax.fori_loop(0, n, body, y)

    jax.block_until_ready(chain(op, x0, np.int32(MATVEC_ITERS)))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(op, x0, np.int32(MATVEC_ITERS)))
    result["ell_matvec_us"] = round(
        (time.perf_counter() - t0) / MATVEC_ITERS * 1e6, 1
    )
    return result


def bench_reference_cpu():
    """Time the reference solver's per-iteration cost on the same problem.

    Measured at BOTH of the reference's threading configs and reported as
    the best (fair-baseline) rate:
      * is_multi_threads=True -- the documented default: 2-way step overlap
        (Laplacian solve || SOC projection on Python threads,
        `socp/solver_socp.py:674-696`) + numexpr on min(4, cores//2)
        threads (`:131`);
      * is_multi_threads=False -- no overlap, numexpr on min(8, cores).
    The numexpr shim (tests/reference_shims) honors set_num_threads with
    real chunked thread parallelism, so both configs exercise the CPU the
    way real numexpr would.

    Returns {"iters_per_sec": best, "per_config": {...}} or None.
    """
    shim_dir = Path(__file__).parent / "tests" / "reference_shims"
    ref_dir = Path("/root/reference")
    if not ref_dir.exists():
        return None
    sys.path.insert(0, str(shim_dir))
    sys.path.insert(0, str(ref_dir))
    try:
        import logging

        logging.disable(logging.CRITICAL)
        from dot_surface_socp.socp.solver_socp import solver_socp as ref_solver

        from dots_socp_tpu.data.loader import load_example
        from dots_socp_tpu.geometry.normalize import normalize_geometry

        _, geometry, _ = load_example(
            example_name="plane", kwargs_generating_mesh={"n": N_SPACE}
        )
        geometry, _ = normalize_geometry(geometry)

        # Difference two runs at nit=2 and nit=2+REF_ITERS so the
        # reference's one-time setup (factorizations, weight assembly)
        # cancels and only the per-iteration loop remains.
        def run(nit, multi_threads):
            t0 = time.perf_counter()
            ref_solver(
                N_TIME,
                geometry,
                nit=nit,
                tol=1e-14,
                time_limit=600,
                is_multi_threads=multi_threads,
            )
            return time.perf_counter() - t0

        per_config = {}
        for multi_threads in (True, False):
            t_short = run(2, multi_threads)
            t_long = run(2 + REF_ITERS, multi_threads)
            rate = REF_ITERS / max(t_long - t_short, 1e-9)
            per_config[f"is_multi_threads={multi_threads}"] = round(rate, 4)
        return {
            "iters_per_sec": max(per_config.values()),
            "per_config": per_config,
        }
    except Exception:
        return None


def main():
    import jax

    if jax.default_backend() != "gpu":
        print(
            f"bench.py needs a GPU; JAX found {jax.default_backend()!r}",
            file=sys.stderr,
        )
        sys.exit(1)
    devices = jax.devices()
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }

    iters_per_sec, config = bench_flagship()
    large = bench_large()

    ref_file = Path(__file__).parent / ".bench_reference_cpu.json"
    ref_info = None
    if ref_file.exists():
        ref_info = json.loads(ref_file.read_text())
        if "per_config" not in ref_info:
            ref_info = None  # stale single-config cache; re-measure fairly
    if ref_info is None:
        ref_info = bench_reference_cpu()
        if ref_info is not None:
            ref_file.write_text(json.dumps(ref_info))
    ref_iters_per_sec = ref_info["iters_per_sec"] if ref_info else None

    vs_baseline = (
        iters_per_sec / ref_iters_per_sec if ref_iters_per_sec else float("nan")
    )
    print(
        json.dumps(
            {
                "metric": f"iALM iterations/s (plane n{N_SPACE}: "
                f"V={config.n_vertices_real}, F={config.n_triangles_real}, "
                f"T={N_TIME}, f32)",
                "value": round(iters_per_sec, 3),
                "unit": "iter/s",
                "vs_baseline": round(vs_baseline, 3)
                if vs_baseline == vs_baseline
                else None,
                # Methodology: one warmed dispatch of BENCH_ITERS fused
                # iterations, timed to block_until_ready.
                # Fair baseline: best of the reference's two threading
                # configs with a thread-honoring numexpr shim (see
                # bench_reference_cpu docstring).
                "reference_iters_per_sec": round(ref_iters_per_sec, 4)
                if ref_iters_per_sec
                else None,
                "reference_per_config": ref_info.get("per_config")
                if ref_info
                else None,
                # The large-mesh CG+refine path (plane n200, V=46k):
                # sustained it/s over a fixed 200-iteration window + the ELL
                # SpMV us/matvec. The CPU reference sustains 0.111 it/s on
                # this problem (1162 iterations / 10,509 s,
                # artifacts/round3/reference_v46k.stdout).
                "large_mesh": large,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
