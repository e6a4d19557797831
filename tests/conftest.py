"""Test configuration: run JAX on a virtual 8-device CPU mesh in float64.

Must set XLA flags before jax is imported anywhere. An explicit
JAX_PLATFORMS (e.g. `cuda,cpu` on a GPU host, to run the `gpu`-marked
checks) is honoured; unset, the tests run on the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the platform through the config too: it wins over any accelerator
# plugin that a site configuration registers regardless of JAX_PLATFORMS.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
# The persistent compilation cache directory is set by `dots_socp_tpu.ops`
# (JAX_COMPILATION_CACHE_DIR, else a fixed directory in the checkout).
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def plane_geometry():
    """Small plane example geometry (generated mesh, no data files needed)."""
    from dots_socp_tpu.geometry.generators import generate_plane_mesh
    from dots_socp_tpu.geometry.surface import triangle_quantities, vertex_areas
    from dots_socp_tpu.utils.types import GeometryData

    vertices, triangles, edges = generate_plane_mesh(n=12)
    area_f, _, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, vertices.shape[0])

    center0 = np.array([0.4, 0.4, 0.0])
    center1 = np.array([0.6, 0.6, 0.0])
    scale = 2 * 0.1**2
    mu0 = av * np.exp(-np.linalg.norm(vertices - center0, axis=1) ** 2 / scale)
    mu1 = av * np.exp(-np.linalg.norm(vertices - center1, axis=1) ** 2 / scale)
    mu0 /= mu0.sum()
    mu1 /= mu1.sum()

    return GeometryData(
        vertices=vertices,
        triangles=triangles,
        edges=edges,
        mu0=mu0,
        mu1=mu1,
        area_triangles=area_f,
        area_vertices=av,
    )


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU. Decided when the test runs, never at
    import, so that every test worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu)")
