"""Test harness: 8 virtual CPU devices, x64 on, CPU platform by default.

JAX_PLATFORMS picks the platform (CPU when unset).  The tests marked
`gpu` need the card and skip without one; run them on a GPU host with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402

use_compile_cache()

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "native", "build", "oracle")

# Build the native library BEFORE collection: the `skipif(not
# native.available())` markers evaluate at collection time, so a fixture
# build is too late — on a fresh clone those tests would silently skip
# on the first run and only pass from the second run on.
from ray_tracer_tpu.accel import native as _native  # noqa: E402

_native.ensure_built()


def pytest_configure(config):
    # pytest-timeout may be absent; the mark documents the intended
    # bound.  Registering it silences the unknown-mark warning.
    config.addinivalue_line(
        "markers",
        "timeout(seconds): advisory per-test timeout (plugin not installed)",
    )


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the card)")
    return dev


@pytest.fixture(scope="session")
def oracle_bin():
    if not os.path.exists(ORACLE):
        subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-j4"],
                       check=True, capture_output=True, timeout=300)
    return ORACLE


@pytest.fixture(scope="session")
def eight_device_mesh():
    from ray_tracer_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual CPU devices"
    return make_mesh(8, ("rays", "tris"), shape=(4, 2))


@pytest.fixture(scope="session")
def tiny_prep():
    """gradcheck scene (plane + 2 spheres, ~700 tris) prepared at 16x16."""
    import dataclasses

    from ray_tracer_tpu.models.scenes import gradcheck_scene
    from ray_tracer_tpu.render.renderer import prepare

    scene, cfg = gradcheck_scene(16, 16)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, ray_tile=64))
    return prepare(cfg, scene=scene)


def rng(seed=0):
    return np.random.default_rng(seed)
