"""Smoke tests for the experiment scripts (VERDICT round-3 weak item 3).

Round 3 lost two chip runs to script bugs a 10-second CI exercise would
have caught (a missing PYTHONPATH and a `history.n_records` typo). Each
script is run as a subprocess on tiny shapes on CPU, WITHOUT PYTHONPATH,
to prove both the self-bootstrap and the full post-solve reporting path.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _run(args, timeout=600):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the scripts must self-bootstrap
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable] + args,
        cwd="/tmp",  # not the repo root: import must come from sys.path fix
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, (
        f"script failed\nstdout:\n{proc.stdout[-3000:]}\n"
        f"stderr:\n{proc.stderr[-3000:]}"
    )
    return proc.stdout


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in output:\n{stdout[-2000:]}")


def test_solve_large_smoke():
    out = _run(
        [
            os.path.join(SCRIPTS, "solve_large.py"),
            "--n_space", "12", "--ntime", "4", "--nit", "3",
            "--time_limit", "60", "--tol", "1e-2",
        ]
    )
    result = _last_json(out)
    assert result["iterations"] >= 0
    assert "wall_sec" in result and "converged" in result
    assert "cg_iters_by_rtol_cold" in result  # histogram path exercised


def test_steady_state_configs_smoke():
    out = _run(
        [
            os.path.join(SCRIPTS, "steady_state_configs.py"),
            "--configs", "smoke",
        ]
    )
    result = _last_json(out)
    cfg = result["config_smoke"]
    assert cfg["iterations"] > 0
    assert cfg["solve_sec"] > 0


def test_bench_matvec_smoke():
    out = _run(
        [
            os.path.join(SCRIPTS, "bench_matvec.py"),
            "--n_space", "12", "--n_time", "4", "--iters", "3",
            # the chain timing loop is what matters here; keep the smoke
            # fast by racing two variants.
            "--skip", "banded",
        ]
    )
    result = _last_json(out)
    assert "variants" in result
    assert result["max_disagreement"] < 1e-3


def test_bench_sharded_cg_smoke():
    out = _run(
        [
            os.path.join(SCRIPTS, "bench_sharded_cg.py"),
            "--n_space", "16", "--ntime", "4", "--n_devices", "4",
            "--repeats", "1",
        ]
    )
    result = _last_json(out)
    assert "layouts" in result
    halo = result["layouts"]["halo_blocked"]
    assert halo["collective_bytes_per_cg_solve"] > 0
    assert result["halo_vs_raw_collective_bytes"] < 1.0


def test_profile_large_smoke():
    out = _run(
        [
            os.path.join(SCRIPTS, "profile_large.py"),
            "--n_space", "12", "--ntime", "4", "--iters", "2",
            "--f64_solve_race",
        ]
    )
    result = _last_json(out)
    assert "iteration_ms" in result and "cg_solve_ms" in result
    assert "f64_solve_race_ms" in result
    assert set(result["f64_solve_race_ms"]) == {
        "refined_f32_ell", "plain_f64_ell",
    }


def test_bench_large_smoke():
    """Full tiny-shape run (not just --help): the imports and the
    phi_refine-carrying run_chunk path live inside build()/main(), which
    --help never reaches -- a bench_large crash slipped through CI that
    way in round 4."""
    out = _run(
        [
            os.path.join(SCRIPTS, "bench_large.py"),
            "--n_space", "12", "--n_time", "4", "--iters", "3",
            "--cg_max_iters", "5",
        ]
    )
    result = _last_json(out)
    assert result["value"] > 0
    assert "kkt_stop_error" in result


@pytest.mark.parametrize("script", ["reference_large.py"])
def test_other_scripts_importable(script):
    """The remaining experiment drivers at least parse and show --help."""
    path = os.path.join(SCRIPTS, script)
    if not os.path.exists(path):
        pytest.skip(f"{script} absent")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, path, "--help"],
        cwd="/tmp",
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
