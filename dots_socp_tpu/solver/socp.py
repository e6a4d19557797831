"""solver_socp: the iALM orchestration loop (host side).

Same contract as the reference solver (`socp/solver_socp.py:25-871`):
``solver_socp(n_time, geometry, **kw) -> (SolutionSocpData, RunningHistory)``
with identical defaults, schedules and stopping semantics. The execution
model differs, built around one accelerator program per chunk:

  * iterations run on device in multi-iteration chunks (`step.run_chunk`);
    the host plans chunk boundaries so they land exactly on the iterations
    where the reference would act (KKT validation per the adaptive cadence,
    sigma adjustments, rescaling triggers), then syncs once per chunk;
  * all 7 dual-valued KKT residuals are computed fused on device at
    validation points (the circular-queue early-exit would save nothing
    once the evaluation is a single fused kernel);
  * the scaling machinery mutates a carried state pytree through jitted
    transforms instead of in-place NumPy writes.

`is_multi_threads` is accepted for API parity and ignored: the reference
uses two Python threads to overlap the Laplacian solve and the cone
projection (`solver_socp.py:674-696`); here both live in one XLA program.
"""

from __future__ import annotations

import logging
import os
import time
from math import exp, sqrt

import jax
import numpy as np

from dots_socp_tpu.config import LOG_LEVELS
from dots_socp_tpu.ops.time_stencils import grad_time
from dots_socp_tpu.ops.mesh_ops import grad_space
from dots_socp_tpu.ops.time_stencils import decouple_space_adjoint
from dots_socp_tpu.solver.kkt import compute_kkt, objective_functional
from dots_socp_tpu.solver.problem import build_problem, host_device
from dots_socp_tpu.solver.scaling import (
    apply_penalty_factor,
    apply_prim_dual_scale,
    apply_z_scale,
    compute_var_norms,
)
from dots_socp_tpu.solver.schedule import AdaptiveKKTCadence, SigmaSchedule
from dots_socp_tpu.solver.state import init_state
from dots_socp_tpu.solver.step import (
    ADAPTIVE_HEADER,
    ADAPTIVE_REC_SIZE,
    run_chunk,
    run_chunk_adaptive,
    run_chunk_kkt,
)
from dots_socp_tpu.utils.history import RunningHistory
from dots_socp_tpu.utils.types import (
    CheckpointDotData,
    GeometryData,
    SolutionSocpData,
)

KKT_LABELS = [
    "SOC & Org : Primal Feasibility (q)",
    "SOC       : Primal Feasibility (z)",
    "SOC & Org : Dual Feasibility (alpha)",
    "SOC       : Dual Feasibility (beta)",
    "      Org : ||rho - Pi+(rho + Fq)||",
    "      Org : ||m - rho o B||",
    "      Org : ||cong. rho - lambda_c||",
]
KKT_SHORT_LABELS = [
    "Prim(phi, q)",
    "Prim(q, z)",
    "Dual(alpha)",
    "Dual(beta)",
    "Comp(rho, f(q))",
    "Comp(m, rho o B)",
    "Comp(rho, cong.)",
]

KKT_STOP_CONDITION = [0, 2, 4, 5]
KKT_PRIM_POS = [0, 1]
KKT_DUAL_POS = [2, 3]

STEP_TAG = "Fused iALM step (Lap + SOC + Q + Mult)"
KKT_TAG = "KKT validation"


def _nanmax(values) -> float:
    vals = np.asarray(values, dtype=float)
    finite = vals[~np.isnan(vals)]
    return float(finite.max()) if finite.size else float("nan")


def _fetch_global(arr) -> np.ndarray:
    """np.asarray that also handles multi-process global arrays.

    Under `jax.distributed` a sharded array is not fully addressable from
    any one process; all-gather it so every host recovers the full solution
    (single-process arrays take the plain np.asarray path).
    """
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    return np.asarray(arr)


def solver_socp(
    n_time,
    geometry: GeometryData,
    congestion=0.0,
    nit=1000,
    eps=0.0,
    tol=1e-4,
    tau=1.90,
    is_palm=False,
    is_multi_threads=True,
    is_z_scaling=True,
    is_constant_scaling=False,
    check_kkt_step_by_step=False,
    init_solution=None,
    tol_checkpoints=None,
    time_limit=1000,
    precision=None,
    laplacian_mode="auto",
    max_dense_vertices=16384,
    cg_max_iters=200,
    cg_rtol=None,
    cg_deflation_k=None,
    max_chunk=512,
    pad_multiple=None,
    mesh=None,
    snapshot_path=None,
    snapshot_every=300.0,
    sigma_freeze_error=None,
    phi_refine="auto",
):
    """Solve the SOCP reformulation of DOT on a discrete surface.

    Parameters mirror the reference solver; accelerator-specific extras:

    precision : "float32" | "float64" | None
        None picks float64 when JAX x64 is enabled, else float32.
    laplacian_mode : "auto" | "spectral" | "cg"
        auto selects the dense spectral factor up to `max_dense_vertices`
        vertices, the matrix-free CG path beyond.
    cg_rtol : float | None
        Inner relative tolerance for the CG phi-solve. None (default)
        enables inexact-ALM scheduling: the tolerance starts loose and is
        tightened to a fraction of the measured outer KKT error at every
        validation point (a traced scalar -- no recompilation).
    cg_deflation_k : int | None
        Ritz pairs in the CG spectral preconditioner (0 disables; None
        scales with the mesh: min(256, max(64, V_pad // 256))).
    max_chunk : int
        Upper bound on iterations dispatched per device call (bounds the
        granularity of the time_limit check). Each dispatch pays one
        host<->device round trip and one host sync; 512 iterations per
        dispatch amortizes it while still checking time_limit between
        dispatches.
    pad_multiple : int | None
        Pad vertex/triangle counts to this multiple (None: 1, raised to a
        multiple of the mesh "space" axis size when sharding).
    mesh : jax.sharding.Mesh | None
        Shard state and operators over this ("time", "space") device mesh;
        XLA inserts the collectives. None = single device.
    snapshot_path : str | None
        Crash-safe periodic snapshot of the state pytree + host schedule
        state to this .npz path; if the file already exists, the run RESUMES
        from it (same n_time/mesh required). Tolerance checkpoints recorded
        before the snapshot are not replayed on resume.
    snapshot_every : float
        Seconds between periodic snapshots (a final one is always written
        on loop exit when snapshot_path is set).
    sigma_freeze_error : float | None
        Tail rule for the sigma schedule: once the stop-set KKT error first
        drops below this threshold, sigma adjustments stop for the rest of
        the run (sticky). The reference's gap-table schedule keeps kicking
        sigma by 10-35% every 43 iterations even when the prim/dual ratio
        merely dances around the 1.2 dead-zone edge; at large V this
        sustains a limit cycle that blocks convergence (measured: plane
        n200/V=46k oscillates in the 1e-3..1e-2 band for 10k+ iterations,
        with or without tight CG). Freezing sigma near convergence restores
        the fixed-penalty ALM descent. None disables (exact reference
        parity).
    phi_refine : "auto" | True | False
        Mixed-precision phi: carry state.phi in float64 and solve the phi
        system by f64 iterative refinement around the f32 inner CG (every
        inner iteration stays in f32). Fixes the
        float32 true-residual floor eps32 * cond(L) ~ eps32/h^2, which at
        V >= 46k sits at ~2e-3 -- above tol=1e-4 -- and stalls KKT dual
        feasibility there regardless of the CG tolerance (the round-3
        tight-CG control measured exactly this). auto = on for every f32 CG
        path (sharded runs carry the f64 true residual through the
        halo/incidence matvec -- `ProblemData.ops_hi`); f64 CG runs plain
        native-f64 CG. The reference needs no analogue:
        it is float64 throughout with exact SuperLU solves
        (`socp/solver_socp.py:276-299`, `utils/laplacian_inverse_socp.py:34-59`).
    """
    logging.basicConfig(level=LOG_LEVELS["info"], format="%(message)s")

    # --- checkpoint list validation (reference `solver_socp.py:85-94`) ------
    checkpoint_solutions = []
    if tol_checkpoints is not None:
        if not isinstance(tol_checkpoints, list) or not tol_checkpoints:
            raise ValueError("tol_checkpoints must be a non-empty list")
        for i, cp in enumerate(tol_checkpoints):
            if not (isinstance(cp, (int, float)) and 0 < cp < 1):
                raise ValueError(f"invalid checkpoint at index {i}: {cp}")
            if cp < tol:
                raise ValueError(f"checkpoint ({cp}) < tol ({tol})")
        tol_checkpoints = sorted(tol_checkpoints, reverse=True)

    if precision is None:
        precision = "float64" if jax.config.jax_enable_x64 else "float32"
    elif precision == "float64" and not jax.config.jax_enable_x64:
        # Without x64, float64 arrays silently downcast to float32; the
        # requested precision is part of the solver contract, so flip the
        # global (it only widens types and is trace-time safe).
        jax.config.update("jax_enable_x64", True)
    nit = int(nit)

    r = 1.0
    dt = 1.0 / n_time

    # --- problem assembly ---------------------------------------------------
    # With a space-sharded mesh the layout is BFS-blocked per shard
    # (space_partitions replaces pad_multiple); otherwise no padding unless
    # asked for.
    mesh_axes = None
    space_size = 1
    if mesh is not None:
        space_size = mesh.shape.get("space", 1)
        mesh_axes = (mesh.shape.get("time", 1), space_size)
    if pad_multiple is None:
        pad_multiple = 1
    if mesh is not None and space_size > 1 and pad_multiple % space_size != 0:
        pad_multiple *= space_size  # only reached when space_partitions == 1

    # Setup runs on the host CPU backend when there is one: it is a swarm of
    # tiny ops, each of which would otherwise pay a compile + dispatch to
    # the accelerator; the finished pytrees transfer to the device once
    # below. Without a CPU backend (JAX_PLATFORMS=cuda) it runs on the
    # default device.
    t_setup = time.perf_counter()
    cpu0 = host_device()
    cg_rtol_adaptive = cg_rtol is None
    cg_rtol_floor = 1e-12 if precision == "float64" else 2e-6
    sigma_freeze = (
        float(sigma_freeze_error) if sigma_freeze_error is not None else -np.inf
    )
    sigma_frozen = False
    with jax.default_device(cpu0):
        config, data, extras = build_problem(
            n_time,
            geometry,
            eps=eps,
            is_palm=is_palm,
            laplacian_mode=laplacian_mode,
            max_dense_vertices=max_dense_vertices,
            cg_max_iters=cg_max_iters,
            cg_rtol=cg_rtol if cg_rtol is not None else 1e-3,
            cg_deflation_k=cg_deflation_k,
            dtype=precision,
            pad_multiple=pad_multiple,
            space_partitions=space_size,
            mesh_axes=mesh_axes,
            phi_refine=phi_refine,
        )
    if config.phi_refine:
        logging.log(
            LOG_LEVELS["kkt"],
            "Mixed-precision phi: f64 state.phi + f64 iterative refinement "
            "around the f32 inner CG",
        )
    logging.debug(
        "---- Laplace matrix ".ljust(42, "-")
        + f"\nFactorizing the Laplace matrix: {time.perf_counter() - t_setup:.2f}s."
    )
    # Compare the freeze threshold at device precision on the host too: the
    # device segment tests err < np_dtype(sigma_freeze) (step.py aux cast),
    # and a float64 host threshold could latch on one side only.
    sigma_freeze = float(config.np_dtype(sigma_freeze))

    n_vertices = config.n_vertices
    n_triangles = config.n_triangles
    vertex_slot = extras["vertex_slot"]
    triangle_slot = extras["triangle_slot"]

    logging.log(
        LOG_LEVELS["kkt"],
        "---- Experiment info ".ljust(42, "-") + "\n"
        f"Congestion parameter: {congestion}"
        f"Number of discretization points in time: {n_time}\n"
        f"Number of discretization vertices: {n_vertices}\n"
        f"Number of discretization triangles: {n_triangles}\n"
        f"Stepsize: {tau}\n"
        f"Is multiple threads: {is_multi_threads}",
    )

    # --- normalization constants -------------------------------------------
    av = extras["av"]
    mu0 = np.asarray(geometry["mu0"], dtype=np.float64)
    mu1 = np.asarray(geometry["mu1"], dtype=np.float64)
    # norm_boundary = r*dt*sqrt(nsc(boundary/av)) with boundary rows
    # -/+ mu_b/(r dt): only the two boundary rows contribute.
    norm_boundary = (
        r * dt * sqrt((np.sum(mu0**2 / av) + np.sum(mu1**2 / av)) / (r * dt) ** 2 / (n_time + 1))
    )
    norm_constant_d = extras["norm_constant_d"]

    ops = data.ops
    with jax.default_device(cpu0):
        state = init_state(
            n_time,
            config.n_vertices,
            config.n_triangles,
            extras["mu0_padded"],
            extras["mu1_padded"],
            dt,
            grad_time_fn=lambda p: grad_time(dt, p),
            grad_space_fn=lambda p: grad_space(ops, p),
            decouple_adjoint_fn=decouple_space_adjoint,
            init_solution=_pad_init_solution(
                init_solution or {}, config, extras
            ),
            congestion=congestion,
            tau=tau,
            eps=eps,
            r=r,
            norm_constant_d=norm_constant_d,
            norm_boundary=norm_boundary,
            dtype=config.jnp_dtype,
            phi_dtype=config.phi_dtype,
        )

    # --- resume from an on-disk snapshot ------------------------------------
    resumed = None
    if snapshot_path is not None and os.path.exists(snapshot_path):
        from dots_socp_tpu.utils.snapshot import load_snapshot, state_from_arrays

        arrays, resumed = load_snapshot(snapshot_path)
        if resumed["n_time"] != n_time or arrays["phi"].shape[1] != n_vertices:
            raise ValueError(
                f"snapshot at {snapshot_path} was written for n_time="
                f"{resumed['n_time']}, V={arrays['phi'].shape[1]}; this run has "
                f"n_time={n_time}, V={n_vertices}"
            )
        state = state_from_arrays(
            arrays, config.jnp_dtype, phi_dtype=config.phi_dtype
        )
        logging.log(
            LOG_LEVELS["info"],
            f"Resuming from snapshot {snapshot_path} "
            f"(iteration {resumed['iteration']}, {resumed['elapsed']:.1f}s elapsed)",
        )

    if mesh is not None:
        from dots_socp_tpu.parallel.mesh import shard_problem, shard_state

        data = shard_problem(mesh, data)
        state = shard_state(mesh, state)
    else:
        # One bulk transfer host -> accelerator (setup built on CPU above).
        exec_device = jax.local_devices()[0]
        if exec_device.platform != "cpu":
            data, state = jax.device_put((data, state), exec_device)

    run_history = RunningHistory(
        max_record_numbers=nit + 2,
        kkt_labels=KKT_LABELS,
        kkt_short_labels=KKT_SHORT_LABELS,
        name="SOCP",
    )
    sched = SigmaSchedule()
    cadence = AdaptiveKKTCadence()
    prim_gap = 1.0 + 1.0 * exp(-100 * congestion)
    converged_mask = np.zeros(7, dtype=bool)

    run_history.start()
    run_history.create_tol_progress(target_tol=tol)

    # --- initial scalings (already baked into a resumed state) --------------
    if resumed is None:
        if is_z_scaling:
            logging.log(LOG_LEVELS["scaling"], "Initially scale z with z factor: 2.0")
            state = apply_z_scale(state, 2.0)

        if is_constant_scaling:
            state = _initial_constant_scaling(config, data, state, n_time)

    # --- main loop ----------------------------------------------------------
    def fetch_kkt(state):
        t0 = time.perf_counter()
        table = _fetch_global(compute_kkt(config, data, state))
        run_history.add_step_time(KKT_TAG, time.perf_counter() - t0)
        return table[:, 0], table[:, 1]

    def snapshot_checkpoint(state, iteration, org):
        scale = float(state.r) * float(state.dual_scale)
        return CheckpointDotData(
            mu=scale * _fetch_global(state.mu)[:, vertex_slot],
            E=scale * _fetch_global(state.E)[:, triangle_slot],
            iteration=iteration,
            time=run_history.get_running_time(),
            kkt=list(org),
        )

    it = 0
    it_done = -1
    error = None
    is_org_kkt = False
    org = np.full(7, np.inf)
    scaled = np.full(7, np.nan)
    start_time = time.perf_counter()
    passed = False

    if resumed is not None:
        it = int(resumed["iteration"]) + 1
        it_done = int(resumed["iteration"])
        sched.last_adjust_it = int(resumed["last_adjust_it"])
        sched.z_scale_count = int(resumed["z_scale_count"])
        cadence.current_interval = int(resumed["cadence_interval"])
        cadence.counter = int(resumed["cadence_counter"])
        converged_mask[:] = np.asarray(resumed["converged_mask"], dtype=bool)
        is_org_kkt = bool(resumed["is_org_kkt"])
        if resumed.get("tol_checkpoints") is not None:
            tol_checkpoints = list(resumed["tol_checkpoints"])
        sigma_frozen = bool(resumed.get("sigma_frozen", False))
        start_time -= float(resumed["elapsed"])  # time_limit spans the whole run

    def host_schedule_meta(iteration):
        return {
            "n_time": n_time,
            "iteration": int(iteration),
            "last_adjust_it": int(sched.last_adjust_it),
            "z_scale_count": int(sched.z_scale_count),
            "cadence_interval": int(cadence.current_interval),
            "cadence_counter": int(cadence.counter),
            "converged_mask": [bool(b) for b in converged_mask],
            "is_org_kkt": bool(is_org_kkt),
            "sigma_frozen": bool(sigma_frozen),
            "tol_checkpoints": tol_checkpoints,
            "elapsed": time.perf_counter() - start_time,
        }

    def maybe_snapshot(iteration, force=False):
        nonlocal last_snapshot_time
        if snapshot_path is None:
            return
        if not force and (time.perf_counter() - last_snapshot_time) < snapshot_every:
            return
        from dots_socp_tpu.utils.snapshot import save_snapshot

        save_snapshot(snapshot_path, state, host_schedule_meta(iteration))
        last_snapshot_time = time.perf_counter()

    last_snapshot_time = time.perf_counter()

    while it < nit:
        # ---- pre-iteration events at iteration `it` ------------------------
        if is_constant_scaling and SigmaSchedule.is_to_scale(it):
            prim, dual = map(np.asarray, compute_var_norms(config, data, state))
            pr, dr = SigmaSchedule.compute_scale_factor(
                prim, dual, msg=f"Var Norm at iteration {it}"
            )
            if max(pr, dr) / min(pr, dr) > 2.0:
                logging.log(
                    LOG_LEVELS["scaling"],
                    f"Scale/Rescale with (prim, dual) factor: {1.0/pr}, {1.0/dr}",
                )
                state = apply_prim_dual_scale(state, pr, dr)

        if is_z_scaling and sched.is_to_scale_matrix(
            it, run_history.get_current_kkt_errors()
        ):
            kkt_now = run_history.get_current_kkt_errors()
            rescale_z = prim_gap * sqrt(kkt_now[1] / kkt_now[0])
            if rescale_z > 1.25:
                logging.log(
                    LOG_LEVELS["scaling"],
                    f"Rescale z at iteration {it} with z factor: {rescale_z}",
                )
                state = apply_z_scale(state, rescale_z)

        # ---- shared per-validation bookkeeping -----------------------------
        def process_validation(
            org, scaled, check_it, whether_adjust, sigma_on_device=False
        ):
            """Record one validated KKT table and run every host schedule
            that keys off it (cadence interval, progress, checkpoints,
            is_org_kkt switch, sigma update). Mutates loop state.
            sigma_on_device: the adaptive segment already applied the sigma
            update in-dispatch; skip the host-side application."""
            nonlocal passed, error, is_org_kkt, state, data, sigma_frozen
            passed = bool(np.all(org < tol))
            if check_kkt_step_by_step:
                cost, lagrangian = map(
                    float, objective_functional(config, data, state)
                )
                run_history.record(
                    current_it=check_it,
                    kkt_errors=org,
                    history={
                        "Transportation cost": cost,
                        "Objective value": lagrangian,
                    },
                )
            else:
                run_history.record(current_it=check_it, kkt_errors=org)

            error = _nanmax(org[KKT_STOP_CONDITION])
            if not sigma_frozen and np.isfinite(error) and error < sigma_freeze:
                sigma_frozen = True
                logging.log(
                    LOG_LEVELS["scaling"],
                    f"Sigma frozen at iteration {check_it} "
                    f"(error {error:.2e} < {sigma_freeze:.2e})",
                )
            if np.isfinite(error):
                cadence.set_error_and_tolerance(error, tol)
                # Inexact-ALM inner-tolerance scheduling: the CG phi-solve
                # only needs to be as accurate as the current outer error.
                # op.rtol is a traced leaf of `data`; no recompilation.
                if cg_rtol_adaptive and config.laplacian_mode == "cg":
                    new_rtol = float(
                        np.clip(0.05 * min(error, 1.0), cg_rtol_floor, 1e-3)
                    )
                    if new_rtol != float(data.cg_op.rtol):
                        logging.log(
                            LOG_LEVELS["kkt"],
                            f"CG inner rtol -> {new_rtol:.2e} "
                            f"at iteration {check_it}",
                        )
                    data = data._replace(
                        cg_op=data.cg_op._replace(
                            rtol=np.asarray(new_rtol, dtype=config.np_dtype)
                        )
                    )

            if not whether_adjust or check_kkt_step_by_step:
                newly = [
                    i
                    for i in range(7)
                    if np.isfinite(org[i]) and org[i] <= tol and not converged_mask[i]
                ]
                converged_mask[newly] = True
                run_history.show_tol_progress(
                    check_it,
                    error,
                    active_idx=[i for i in range(7) if not converged_mask[i]],
                    converged_idx=newly or None,
                )

            # Checkpoints at first crossing of each tolerance level (only on
            # the per-validation dispatch path, where `state` is the state at
            # check_it). Compare at device precision: the adaptive segment
            # tests err <= np_dtype(checkpoint), and a mismatched host-side
            # float64 threshold would leave the popped list out of sync with
            # the in-dispatch early exit (wasting a dispatch).
            while (
                tol_checkpoints
                and np.isfinite(error)
                and error <= float(config.np_dtype(tol_checkpoints[0]))
            ):
                checkpoint_solutions.append(
                    snapshot_checkpoint(state, check_it, org)
                )
                tol_checkpoints.pop(0)

            if passed:
                return

            if _nanmax(scaled) < 5 * tol:
                is_org_kkt = True

            if whether_adjust and not sigma_on_device and not sigma_frozen:
                col = org if is_org_kkt else scaled
                prim_error = _nanmax(col[KKT_PRIM_POS])
                dual_error = _nanmax(col[KKT_DUAL_POS])
                if (
                    np.isfinite(prim_error)
                    and np.isfinite(dual_error)
                    and dual_error > 0
                ):
                    gap = prim_error / dual_error
                    r_now = float(state.r)
                    factor = sched.updated_sigma(r_now, gap) / r_now
                    if factor != 1.0:
                        state = apply_penalty_factor(state, factor)

        # The adaptive device-resident path runs iterations AND validations
        # on device up to the next host-side event (one round trip per
        # segment). Tolerance checkpoints are served by an in-dispatch early
        # exit at the crossing validation (the host then snapshots the
        # segment-end state, which IS the state at the crossing); only
        # step-by-step mode needs host access at every iteration.
        use_adaptive = not check_kkt_step_by_step

        # ---- plan the next dispatch segment --------------------------------
        if check_kkt_step_by_step:
            stop_after = it
        else:
            stop_after = min(nit - 1, it + max_chunk - 1)
            if not use_adaptive:
                # Segment must break at sigma-adjust boundaries and
                # validation points so the host can act between dispatches.
                stop_after = min(
                    stop_after,
                    sched.next_adjust_iteration(it),
                    it + cadence.iterations_until_next() - 1,
                )
            stop_after = min(stop_after, _next_pre_event(it, is_constant_scaling,
                                                         is_z_scaling, sched) - 1)
            stop_after = max(stop_after, it)
        k = stop_after - it + 1

        if use_adaptive:
            # Iterations + validations + sigma updates all run on device;
            # one dispatch and one packed transfer per segment.
            aux = np.asarray(
                [
                    float(sched.last_adjust_it),
                    float(is_org_kkt),
                    tol,
                    # -inf sentinel: err <= -inf never fires (inf would
                    # fire at EVERY validation and change chunk boundaries).
                    tol_checkpoints[0] if tol_checkpoints else -np.inf,
                    # Sigma tail-freeze threshold: -inf when disabled (err
                    # < -inf never fires); +inf once sticky-frozen host-side.
                    np.inf if sigma_frozen else sigma_freeze,
                ],
                dtype=config.np_dtype,
            )
            t0 = time.perf_counter()
            state, packed_dev = run_chunk_adaptive(
                config,
                data,
                state,
                np.int32(it),
                np.int32(k),
                np.int32(cadence.iterations_until_next()),
                aux,
                max_chunk,
            )
            packed = _fetch_global(packed_dev)
            run_history.add_step_time(STEP_TAG, time.perf_counter() - t0)

            n_checks = int(packed[0])
            it_total = int(packed[1])
            sched.last_adjust_it = int(packed[2])
            is_org_kkt = bool(packed[3] > 0.5)
            recs = packed[ADAPTIVE_HEADER:].reshape(max_chunk, ADAPTIVE_REC_SIZE)

            it_done = it + it_total - 1
            it = it_done + 1
            is_time_up = (time.perf_counter() - start_time) > time_limit

            prev_offset = 0
            for ci in range(n_checks):
                offset = int(recs[ci, 0])
                adjusted = recs[ci, 1] > 0.5
                factor = float(recs[ci, 2])
                table = recs[ci, ADAPTIVE_REC_SIZE - 14:].reshape(7, 2)
                check_it = it - it_total + offset - 1
                cadence.advance(offset - prev_offset - 1)
                prev_offset = offset
                cadence.tick(forced=adjusted)
                if adjusted and factor != 1.0:
                    logging.log(
                        LOG_LEVELS["scaling"],
                        f"Adjust sigma at iteration {check_it} "
                        f"with factor: {factor}",
                    )
                process_validation(
                    table[:, 0], table[:, 1], check_it, adjusted,
                    sigma_on_device=True,
                )
                if passed:
                    break

            maybe_snapshot(it_done)
            if passed or is_time_up:
                break
            continue

        # ---- per-validation dispatch path ----------------------------------
        # Predict (host-side, before dispatch) whether this chunk ends on a
        # validation point; if so, compute the KKT table fused into the same
        # device dispatch -- one round trip instead of two.
        will_validate = (
            check_kkt_step_by_step
            or stop_after == sched.next_adjust_iteration(it)
            or (cadence.counter + k - 1) % cadence.current_interval == 0
        )

        t0 = time.perf_counter()
        if will_validate:
            state, kkt_dev = run_chunk_kkt(config, data, state, np.int32(k))
        else:
            state = run_chunk(config, data, state, np.int32(k))
            kkt_dev = None
        jax.block_until_ready(state.phi)
        run_history.add_step_time(STEP_TAG, time.perf_counter() - t0)
        it_done = stop_after
        it = stop_after + 1

        # ---- post-iteration processing for iteration `it_done` -------------
        is_time_up = (time.perf_counter() - start_time) > time_limit
        whether_adjust = sched.is_to_adjust(it_done) or is_time_up
        cadence.advance(k - 1)
        validated = cadence.tick(forced=whether_adjust or check_kkt_step_by_step)

        if not validated:
            continue

        if kkt_dev is not None:
            t0 = time.perf_counter()
            table = _fetch_global(kkt_dev)
            run_history.add_step_time(KKT_TAG, time.perf_counter() - t0)
            org, scaled = table[:, 0], table[:, 1]
        else:  # time_limit fired off-schedule; fetch in a second dispatch
            org, scaled = fetch_kkt(state)

        process_validation(org, scaled, it_done, whether_adjust)
        maybe_snapshot(it_done)

        if passed or is_time_up:
            break

    counter_main = it_done if it_done >= 0 else -1
    maybe_snapshot(counter_main, force=True)

    # --- final validation + recovery ---------------------------------------
    org, scaled = fetch_kkt(state)
    cost, lagrangian = map(float, objective_functional(config, data, state))
    run_history.record(
        current_it=max(counter_main, 0),
        kkt_errors=org,
        history={"Transportation cost": cost, "Objective value": lagrangian},
    )
    run_history.end()

    solution = _recover_solution(
        state, checkpoint_solutions, config, vertex_slot, triangle_slot
    )

    congestion_norm = float(
        np.linalg.norm(
            np.asarray(solution["lambda_c"])
            - float(state.congestion) * np.asarray(solution["mu"])
        )
    )
    logging.log(
        LOG_LEVELS["info"],
        "---- Overview of solution ".ljust(42, "-") + "\n"
        f"Congestion norm: {congestion_norm:.2f}\n"
        f"Number of iterations: {counter_main}\n"
        f"Iteration time: {run_history.running_time:.2f}",
    )

    return solution, run_history


def _next_pre_event(it, is_constant_scaling, is_z_scaling, sched) -> int:
    """Smallest iteration > it at which a pre-iteration event could fire."""
    candidates = [2**62]
    if is_constant_scaling:
        for target in (10, 50):
            if target > it:
                candidates.append(target)
        nxt = ((it - 50) // 100 + 1) * 100 + 50
        if nxt > it:
            candidates.append(nxt)
    if is_z_scaling and sched.z_scale_count < 1:
        # The z-rescale can fire at any iteration >= 100 once the recorded
        # KKT drops below 5e-3; the recorded KKT only changes at validation
        # points, which are chunk boundaries anyway, so crossing iteration
        # 100 is the only boundary to respect here.
        if it < 100:
            candidates.append(100)
    return int(min(candidates))


def _initial_constant_scaling(config, data, state, n_time):
    """is_constant_scaling startup rescale (reference
    `solver_socp.py:574-586`)."""
    import jax.numpy as jnp

    from dots_socp_tpu.solver.kkt import _norms

    nst, nsc, nss, _ = _norms(config, data)
    bt = state.r * state.boundary / data.ops.av[None, :]
    norm_c = float(jnp.sqrt(nsc(bt)))
    norm_ac = float(
        jnp.sqrt(
            nst(grad_time(config.stepsize_time, bt))
            + nss(grad_space(data.ops, bt))
        )
    )
    dual_init = sqrt(n_time) * norm_c**2 / norm_ac
    prim_init = float(state.norm_constant_d)
    if max(prim_init, dual_init) / min(prim_init, dual_init) > 2.0:
        logging.log(
            LOG_LEVELS["scaling"],
            f"Var Norm at initial scaling with (prim, dual) factor: "
            f"{1.0/prim_init}, {1.0/dual_init}",
        )
        state = apply_prim_dual_scale(state, prim_init, dual_init)
    state = apply_penalty_factor(state, 1.0 / float(state.r))
    return state


def _pad_init_solution(init_solution: dict, config, extras) -> dict:
    """Place a real-sized warm-start solution into the padded (possibly
    blocked) problem layout; already-padded arrays pass through."""
    if not init_solution:
        return init_solution
    v_pad, f_pad = config.n_vertices, config.n_triangles

    def place(arr, axis, target, slot):
        arr = np.asarray(arr)
        if arr.shape[axis] == target:
            return arr  # already laid out
        if arr.shape[axis] != slot.shape[0]:
            raise ValueError(
                f"warm-start axis {axis} has size {arr.shape[axis]}; expected "
                f"{slot.shape[0]} (real) or {target} (padded)"
            )
        out = np.zeros(arr.shape[:axis] + (target,) + arr.shape[axis + 1 :],
                       dtype=arr.dtype)
        idx = [slice(None)] * arr.ndim
        idx[axis] = slot
        out[tuple(idx)] = arr
        return out

    v_slot, f_slot = extras["vertex_slot"], extras["triangle_slot"]
    v_keys = {"phi": 1, "A": 1, "lambda_c": 1, "z_fst": 1, "z_end": 1,
              "mu": 1, "beta_fst": 1, "beta_end": 1}
    f_keys = {"B": 1, "E": 1, "z_mid": 2, "beta_mid": 2}
    out = dict(init_solution)
    for key, axis in v_keys.items():
        if out.get(key) is not None:
            out[key] = place(out[key], axis, v_pad, v_slot)
    for key, axis in f_keys.items():
        if out.get(key) is not None:
            out[key] = place(out[key], axis, f_pad, f_slot)
    return out


def _recover_solution(
    state, checkpoint_solutions, config, vertex_slot, triangle_slot
) -> SolutionSocpData:
    """Undo the prim/dual/z/r scalings (reference
    `recorver_scaled_solution`, `solver_socp.py:397-412`) and gather the
    padded (possibly blocked) arrays back to the real mesh ordering."""
    ps = float(state.prim_scale)
    ds = float(state.dual_scale)
    sz = float(state.scale_z)
    r = float(state.r)
    v, f = vertex_slot, triangle_slot
    return SolutionSocpData(
        phi=ps * _fetch_global(state.phi)[:, v],
        A=ps * _fetch_global(state.A)[:, v],
        B=ps * _fetch_global(state.B)[:, f],
        lambda_c=ps * _fetch_global(state.lambda_c)[:, v],
        z_fst=(ps / sz) * _fetch_global(state.z_fst)[:, v],
        z_mid=(ps / sz) * _fetch_global(state.z_mid)[:, :, f],
        z_end=(ps / sz) * _fetch_global(state.z_end)[:, v],
        mu=(r * ds) * _fetch_global(state.mu)[:, v],
        E=(r * ds) * _fetch_global(state.E)[:, f],
        beta_fst=(r * sz * ds) * _fetch_global(state.beta_fst)[:, v],
        beta_mid=(r * sz * ds) * _fetch_global(state.beta_mid)[:, :, f],
        beta_end=(r * sz * ds) * _fetch_global(state.beta_end)[:, v],
        checkpoints=checkpoint_solutions if checkpoint_solutions else None,
    )
