"""Run the REFERENCE solver on the large plane mesh (CPU, f64, exact
Laplacian solves) to establish the ground-truth convergence behavior for
the V=46k configuration.

Our solve of plane n200 plateaus with KKT prim(q)/dual(alpha)
oscillating in the 1e-3..1e-2 band under the sigma limit cycle; this run
answers whether the reference algorithm itself (float64 + SuperLU exact
inner solves, `dot_surface_socp/socp/solver_socp.py`) descends past that
band on the same mesh, or whether the plateau is intrinsic to the
iALM/sigma schedule at this problem size.

Usage: python scripts/reference_large.py --n_space 200 --ntime 31 \
    --tol 1e-4 --time_limit 10800 --log_file artifacts/round3/reference_v46k.log
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--nit", type=int, default=50000)
    ap.add_argument("--time_limit", type=float, default=10800)
    ap.add_argument("--log_file", default=None)
    args = ap.parse_args()

    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "tests" / "reference_shims"))
    sys.path.insert(0, "/root/reference")
    sys.path.insert(0, str(repo))

    from dot_surface_socp import set_logging_level
    from dot_surface_socp.socp.solver_socp import solver_socp as ref_solver

    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry

    set_logging_level(log_level="kkt", log_file=args.log_file)

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": args.n_space}
    )
    geometry, _ = normalize_geometry(geometry)

    t0 = time.perf_counter()
    solution, history = ref_solver(
        args.ntime,
        geometry,
        nit=args.nit,
        tol=args.tol,
        time_limit=args.time_limit,
        is_multi_threads=True,
    )
    wall = time.perf_counter() - t0
    history.print_end_history()
    history.print_steps_time()
    print(json.dumps({"metric": "reference large-mesh solve",
                      "wall_sec": round(wall, 1)}), flush=True)


if __name__ == "__main__":
    main()
