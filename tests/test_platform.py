"""What the solver assumes of its host and device: no backend branches, no
cluster variables of another platform, the compile cache location, and the
GPU smoke entry point refusing to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_updates=(), env_drop=(), cwd=REPO, args=()):
    env = dict(os.environ)
    for key in env_drop:
        env.pop(key, None)
    env.update(dict(env_updates))
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    return subprocess.run(
        cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


_PRINT_CACHE_DIR = (
    "import jax, dots_socp_tpu.ops; print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_follows_env(tmp_path):
    target = str(tmp_path / "cache")
    proc = _python(_PRINT_CACHE_DIR, {"JAX_COMPILATION_CACHE_DIR": target})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == target


def test_compile_cache_defaults_inside_checkout(tmp_path):
    # Run from elsewhere: the default must not follow the working directory.
    proc = _python(
        _PRINT_CACHE_DIR, env_drop=("JAX_COMPILATION_CACHE_DIR",),
        cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == os.path.join(
        REPO, "output", "jax_cache"
    )


def test_chip_smoke_refuses_cpu():
    proc = _python(None, args=[os.path.join(REPO, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_build_problem_defaults_do_not_depend_on_backend(
    plane_geometry, monkeypatch
):
    """pad_multiple defaults to 1 and auto phi_refine is one rule (CG and
    float32) whatever backend JAX reports."""
    import jax

    from dots_socp_tpu.solver.problem import build_problem

    for backend in ("cpu", "gpu", "tpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        rule = {}
        for mode in ("spectral", "cg"):
            for dtype in ("float32", "float64"):
                config, _, _ = build_problem(
                    4, plane_geometry, laplacian_mode=mode, dtype=dtype,
                    cg_deflation_k=4,
                )
                assert config.n_vertices == config.n_vertices_real
                assert config.n_triangles == config.n_triangles_real
                rule[mode, dtype] = config.phi_refine
        assert rule == {
            ("spectral", "float32"): False,
            ("spectral", "float64"): False,
            ("cg", "float32"): True,
            ("cg", "float64"): False,
        }, backend


def test_initialize_distributed_ignores_tpu_worker_env(monkeypatch):
    import jax

    from dots_socp_tpu.parallel import distributed

    calls = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: calls.append(kw)
    )
    monkeypatch.setattr(distributed, "_initialized", False)
    for key in ("COORDINATOR_ADDRESS", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0,host1")
    distributed.initialize_distributed()
    assert calls == []


def test_types_import_without_typing_extensions():
    proc = _python(
        "import sys; sys.modules['typing_extensions'] = None; "
        "import dots_socp_tpu.utils.types as t; "
        "print(sorted(t.GeometryData.__annotations__))"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "area_triangles" in proc.stdout


def test_host_device_without_cpu_backend(monkeypatch):
    """Problem assembly falls back to the default device when JAX runs
    without a CPU backend (JAX_PLATFORMS=cuda)."""
    import jax

    from dots_socp_tpu.solver.problem import host_device

    assert host_device().platform == "cpu"

    def no_cpu(backend=None):
        raise RuntimeError(f"Unknown backend {backend}")

    monkeypatch.setattr(jax, "local_devices", no_cpu)
    assert host_device() is None
    with jax.default_device(host_device()):
        assert np.asarray(jax.numpy.ones(3)).sum() == 3


@pytest.mark.gpu
def test_chip_smoke_kernels_at_real_widths(gpu):
    """Phase B of chip_smoke.py: every kernel of the main path at real
    widths against float64 SciPy / NumPy references, on the GPU."""
    import chip_smoke

    result = chip_smoke.phase_b()
    assert result["ok"], result
