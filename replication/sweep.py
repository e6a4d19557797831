"""In-process replication sweep: every example x congestion level.

The reference Makefile runs one Python process per (example, congestion)
pair (`Makefile:56-91`); on an accelerator that would pay a fresh XLA
compile per mesh shape per process. This driver instead:

  * pads all meshes into shared shape buckets (--pad_multiple, default
    4096), so the 14 surrogate meshes collapse into 3 padded shapes and
    XLA compiles ONE solver graph per bucket;
  * absorbs each bucket's one-time compile in an unlogged warmup solve, so
    the tables' "Time [seconds]" column is pure solve time;
  * appends the standard log blocks per run (same format `log2table`
    parses) plus a `Converged: yes|time-capped` annotation line, surfaced
    as a "Converged" table column;
  * emits the three per-congestion comparison tables the reference's
    `make main` produces.

Usage (what `make main` runs):
  python replication/sweep.py --ntime=31 --nit=10000 --tol=1e-4 \
      --time_limit=300 --outdir=output/main --congestions 0.00 0.01 0.05 \
      --examples airplane refined_airplane ...
"""

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np

root_of_import = Path(__file__).parent.parent
if str(root_of_import) not in sys.path:
    sys.path.insert(0, str(root_of_import))
if str(Path(__file__).parent) not in sys.path:
    sys.path.insert(0, str(Path(__file__).parent))

from log2table import log2table  # noqa: E402

from dots_socp_tpu.cli import parse_args as cli_parse_args  # noqa: E402
from dots_socp_tpu.config import LOG_LEVELS  # noqa: E402
from dots_socp_tpu.interface import (  # noqa: E402
    print_example_info,
    run_dot_surface,
    set_logging_level,
)

DEFAULT_EXAMPLES = [
    "airplane", "refined_airplane", "armadillo", "refined_armadillo",
    "hand", "refined_hand", "punctured_ball", "refined_punctured_ball",
    "bunny", "refined_bunny", "ring", "knots_3", "knots_5", "hills",
]


def padded_shape(example: str, pad: int):
    from dots_socp_tpu.data.loader import load_example

    _, geometry, _ = load_example(example_name=example)
    rup = lambda x: -(-x // pad) * pad
    return (rup(geometry["vertices"].shape[0]),
            rup(geometry["triangles"].shape[0]))


def build_opts(parser, args, example: str, congestion: float):
    argv = [
        f"--example={example}",
        f"--ntime={args.ntime}",
        f"--nit={args.nit}",
        f"--tol={args.tol}",
        f"--time_limit={args.time_limit}",
        f"--congestion={congestion}",
        f"--outdir={args.outdir}",
    ]
    if example == "hills":
        argv.append("--power_perceptual=0.5")
    opts = parser.parse_args(argv)
    opts.pad_multiple = args.pad_multiple
    return opts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--nit", type=int, default=10000)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--time_limit", type=float, default=300,
                    help="per-run wall budget; runs that hit it are marked "
                    "'time-capped' in the Converged column")
    ap.add_argument("--outdir", default="output/main")
    ap.add_argument("--congestions", nargs="+", type=float,
                    default=[0.0, 0.01, 0.05])
    ap.add_argument("--examples", nargs="+", default=DEFAULT_EXAMPLES)
    ap.add_argument("--pad_multiple", type=int, default=4096)
    ap.add_argument("--no_warmup", action="store_true")
    args = ap.parse_args()

    parser = cli_parse_args(return_parser=True)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    # Group examples by padded shape so same-bucket runs are consecutive
    # (the in-process jit cache then reuses the compiled graph directly).
    shapes = {ex: padded_shape(ex, args.pad_multiple) for ex in args.examples}
    buckets = {}
    for ex in args.examples:
        buckets.setdefault(shapes[ex], []).append(ex)
    ordered = [ex for bucket in buckets.values() for ex in bucket]
    print(f"[sweep] {len(args.examples)} examples in {len(buckets)} "
          f"shape bucket(s): "
          + ", ".join(f"{s}x{len(exs)}" for s, exs in buckets.items()),
          flush=True)

    if not args.no_warmup:
        # One throwaway 2-iteration solve per bucket absorbs the XLA
        # compile; stdout only (no file handler yet), so no table row.
        set_logging_level("info", log_file=None)
        for shape, exs in buckets.items():
            t0 = time.perf_counter()
            opts = build_opts(parser, args, exs[0], args.congestions[0])
            opts.nit = 2
            opts.time_limit = 600
            run_dot_surface(opts=opts)
            print(f"[sweep] warmup {shape} ({exs[0]}): "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)

    for congestion in args.congestions:
        tag = f"{congestion:.2f}".replace(".", "_")
        c_dir = outdir / f"congestion_{tag}"
        c_dir.mkdir(parents=True, exist_ok=True)
        log_file = c_dir / "info.log"
        set_logging_level("info", log_file=str(log_file))
        for example in ordered:
            print(f"[sweep] === {example} congestion={congestion}", flush=True)
            opts = build_opts(parser, args, example, congestion)
            opts.outdir = str(c_dir)
            t0 = time.perf_counter()
            print_example_info(opts)  # the block header log2table splits on
            _, _, history = run_dot_surface(opts=opts)
            errors = np.asarray(history.get_current_kkt_errors(), dtype=float)
            converged = bool(np.all(errors < args.tol))
            logging.log(
                LOG_LEVELS["info"],
                f"Converged: {'yes' if converged else 'time-capped'}",
            )
            print(f"[sweep] --- {example}: "
                  f"{'converged' if converged else 'TIME-CAPPED'} in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        set_logging_level("info", log_file=None)  # release the file handler
        log2table(
            str(log_file),
            [str(c_dir / "comparison_table.tex"),
             str(c_dir / "comparison_table.html")],
        )

    print("[sweep] done", flush=True)


if __name__ == "__main__":
    main()
