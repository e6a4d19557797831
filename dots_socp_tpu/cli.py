"""Command-line interface.

Same flags, defaults and groups as the reference CLI (`cli.py:27-156`), plus
solver extras (--precision, --laplacian_mode, --phi_refine, ...). Run as
``python -m dots_socp_tpu.cli --example plane --n_space 40``.
"""

from __future__ import annotations

import argparse

from numpy import inf as np_inf


class CheckArgsRangeTau(argparse.Action):
    def __call__(self, arg_parser, namespace, values, option_string=None):
        if not (0.0 < float(values) < 2.0):
            raise argparse.ArgumentError(
                self, f"tau must be in range (0.0, 2.0), but got {values}"
            )
        setattr(namespace, self.dest, values)


class CheckArgsPowerPerceptual(argparse.Action):
    def __call__(self, arg_parser, namespace, values, option_string=None):
        if not float(values) > 0.0:
            raise argparse.ArgumentError(
                self, f"power_perceptual must be > 0.0, but got {values}"
            )
        setattr(namespace, self.dest, values)


def parse_args(parser=None, return_parser=False):
    """Build (and optionally return) the argument parser."""
    if parser is None:
        parser = argparse.ArgumentParser(
            description="Solve dynamic optimal transport on a triangulated surface and animate the transported density."
        )

    example_group = parser.add_argument_group(
        "Example configuration",
        "Pick a built-in problem with --example, or supply your own mesh and "
        "density settings with --mesh_file/--setting_file.",
    )
    example_group.add_argument(
        "--example",
        default=None,
        type=str,
        help="Name of a built-in problem (plane, airplane, armadillo, hand, "
        "bunny, sphere, ring, punctured_ball, knots_3, knots_5, hills, "
        "robot, eight, face, audi, square_regular, and their refined_* "
        "variants)",
    )
    example_group.add_argument(
        "--mesh_file", default=None, type=str, help="Path to a surface mesh in .off format"
    )
    example_group.add_argument(
        "--setting_file", default=None, type=str, help="Path to a density-settings module (.py defining get_mu)"
    )
    example_group.add_argument(
        "--congestion", default=0.0, type=float, help="Congestion penalty weight; 0 disables the congestion term"
    )
    example_group.add_argument(
        "--ntime", default=31, type=int, help="Number of time steps on the staggered grid"
    )

    algo_group = parser.add_argument_group("Algorithm parameters")
    algo_group.add_argument(
        "--tau",
        type=float,
        default=None,
        action=CheckArgsRangeTau,
        help="Over-relaxation step size for the multiplier ascent, in (0, 2)",
    )
    algo_group.add_argument("--nit", default=10**3, type=int, help="Iteration cap for the iALM loop")
    algo_group.add_argument(
        "--eps",
        default=0.0,
        type=float,
        help="Proximal regularization added to the phi-step Laplacian",
    )
    algo_group.add_argument(
        "--tol", default=10 ** (-3), type=float, help="Relative KKT error at which the solve stops"
    )
    algo_group.add_argument(
        "--time_limit",
        default=np_inf,
        type=float,
        help="Abort after this many seconds, returning the best iterate",
    )
    algo_group.add_argument(
        "--precision",
        default=None,
        choices=["float32", "float64"],
        help="Solver dtype (default: float64 when JAX x64 is enabled, "
        "else float32)",
    )
    algo_group.add_argument(
        "--laplacian_mode",
        default=None,
        choices=["auto", "spectral", "cg"],
        help="Space-time Laplacian solver: dense spectral factor or "
        "matrix-free CG (default: auto by mesh size)",
    )
    algo_group.add_argument(
        "--phi_refine",
        default="auto",
        choices=["auto", "on", "off"],
        help="Mixed-precision phi: f64 state.phi + f64 iterative refinement "
        "around the f32 inner CG (auto: on for the float32 CG path, where "
        "the f32 true-residual floor blocks tight tolerances)",
    )

    output_group = parser.add_argument_group("Output options")
    output_group.add_argument(
        "--show", default=False, action="store_true", help="Open an interactive window with the density animation"
    )
    output_group.add_argument(
        "--save", default=False, action="store_true", help="Write the density animation to the output directory"
    )
    output_group.add_argument(
        "--cmap", default=None, type=str, help="Colormap name used when rendering the density"
    )
    output_group.add_argument(
        "--power_perceptual",
        default=1.0,
        type=float,
        action=CheckArgsPowerPerceptual,
        help="Exponent applied to densities before coloring (1.0 = linear)",
    )
    output_group.add_argument(
        "--detail_runhist",
        default=False,
        action="store_true",
        help="Validate KKT and record the objective every iteration (slow)",
    )
    output_group.add_argument(
        "--show_kkt_it",
        "--show_kkt",
        default=False,
        action="store_true",
        help="Plot the KKT residuals against the iteration count",
    )
    output_group.add_argument(
        "--save_kkt_it",
        "--save_kkt",
        default=False,
        action="store_true",
        help="Write the KKT-vs-iteration plot to the output directory",
    )
    output_group.add_argument(
        "--show_kkt_time",
        default=False,
        action="store_true",
        help="Plot the KKT residuals against wall-clock time",
    )
    output_group.add_argument(
        "--save_kkt_time",
        default=False,
        action="store_true",
        help="Write the KKT-vs-time plot to the output directory",
    )
    output_group.add_argument(
        "-o", "--outdir", default="output/undated", type=str, help="Directory for saved animations, plots and tables"
    )
    output_group.add_argument(
        "--log_file", default=None, type=str, help="Also tee the log to this file (log2table input)"
    )

    dist_group = parser.add_argument_group(
        "Distributed execution",
        "Place the solver on a ('time', 'space') device mesh; multi-host "
        "runs launch one process per host with the same command line plus "
        "--process_id.",
    )
    dist_group.add_argument(
        "--mesh_shape",
        default=None,
        type=str,
        help="Device mesh as TxS (e.g. 2x4) or a bare device count S "
        "(= 1xS, pure spatial sharding); default: single device",
    )
    dist_group.add_argument(
        "--coordinator_address",
        default=None,
        type=str,
        help="host:port of process 0 for jax.distributed.initialize "
        "(multi-host only)",
    )
    dist_group.add_argument(
        "--num_processes",
        default=None,
        type=int,
        help="Total process count of the multi-host run",
    )
    dist_group.add_argument(
        "--process_id",
        default=None,
        type=int,
        help="This process's rank in [0, num_processes)",
    )

    exp_group = parser.add_argument_group("Experimental features")
    exp_group.add_argument(
        "--log_level",
        type=str,
        choices=["debug", "kkt", "scaling", "info"],
        default="info",
        help="Verbosity: info < scaling < kkt < debug (each adds detail)",
    )
    exp_group.add_argument(
        "--versus_exact",
        default=False,
        action="store_true",
        help="After solving, measure errors against the closed-form transport "
        "(settings module must define get_exact_transportation)",
    )
    exp_group.add_argument(
        "--checkpoints",
        default=None,
        nargs="+",
        type=float,
        help="KKT levels at which intermediate solutions are snapshotted for "
        "the --versus_exact error table",
    )
    exp_group.add_argument(
        "--n_space",
        type=int,
        default=None,
        help="Resolution parameter n for procedurally generated meshes "
        "(e.g. the plane example)",
    )
    exp_group.add_argument(
        "--sigma_freeze_error",
        type=float,
        default=None,
        help="Freeze sigma adjustments (sticky) once the KKT stop error "
        "first drops below this level; breaks the sigma limit cycle on "
        "large meshes (try 20*tol). Default: never freeze",
    )
    exp_group.add_argument(
        "--snapshot",
        dest="snapshot_path",
        type=str,
        default=None,
        help="Path to a .npz state snapshot: written periodically during the "
        "solve, and resumed from if it already exists",
    )
    exp_group.add_argument(
        "--snapshot_every",
        type=float,
        default=300.0,
        help="Seconds between periodic snapshots (with --snapshot)",
    )
    exp_group.add_argument(
        "--profile_dir",
        type=str,
        default=None,
        help="Capture a jax.profiler device trace of the solve into this "
        "directory (inspect with TensorBoard or xprof)",
    )
    exp_group.add_argument(
        "--pad_multiple",
        type=int,
        default=None,
        help="Pad vertex/triangle counts to this multiple (default: 1, no "
        "padding). Bucketing meshes to shared padded shapes lets a sweep "
        "reuse one compiled graph across examples",
    )
    exp_group.add_argument(
        "--max_dense_vertices",
        type=int,
        default=None,
        help="Largest padded vertex count solved with the dense spectral "
        "factor; larger problems take the matrix-free CG path",
    )

    if return_parser:
        return parser
    return parser.parse_args()


def main():
    from dots_socp_tpu.interface import (
        print_example_info,
        run_dot_surface,
        run_dot_surface_versus_exact,
        set_logging_level,
    )

    args = parse_args()
    set_logging_level(log_level=args.log_level, log_file=args.log_file)
    print_example_info(args)

    if not args.versus_exact:
        run_dot_surface(solver_name="socp", opts=args)
    else:
        run_dot_surface_versus_exact(solver_name="socp", opts=args)


if __name__ == "__main__":
    main()
