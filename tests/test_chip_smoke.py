"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and the compile-cache helper every entry point calls."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from ray_tracer_tpu.utils import cache  # noqa: E402

SIZE = 16


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    """A private native build: the phase rebuilds with make -B, which
    must not rewrite the library other test processes have loaded."""
    d = str(tmp_path_factory.mktemp("native_build"))
    rec = chip_smoke.phase_build(d)
    assert rec["oracle"]
    return d


@pytest.mark.parametrize("phase", [
    "build", "forward_spot", "forward_dense", "forward_mirror", "gi", "fit",
    "oracle",
])
def test_phase_at_tiny_size(phase, build_dir, capsys):
    with jax.enable_x64(False):  # the phases run in JAX's default mode
        if phase == "build":
            rec = {"phase": "build", "oracle": os.path.exists(
                os.path.join(build_dir, "oracle"))}
        elif phase == "gi":
            rec = chip_smoke.phase_gi(SIZE, spp=2, depth=1)
        elif phase == "fit":
            rec = chip_smoke.phase_fit(SIZE, steps=3, grad_size=SIZE)
        elif phase == "oracle":
            rec = chip_smoke.phase_oracle(SIZE, SIZE, build_dir=build_dir)
        else:
            rec = getattr(chip_smoke, f"phase_{phase}")(SIZE)
    assert rec["phase"] == phase
    if phase == "build":
        assert rec["oracle"]
        return
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert f'"phase": "{phase}"' in line
    if phase == "oracle":
        # bit-identical on the CPU (tests/test_render_golden.py)
        assert rec["serial"]["mismatched_bytes"] == 0
        assert rec["parallel"]["mismatched_bytes"] == 0
        return
    assert rec["median_s"] > 0 and rec["first_call_s"] > 0
    if phase == "fit":
        assert rec["losses"][-1] < rec["losses"][0]
        assert max(rec["grad_rel_err_vs_cpu"].values()) == 0.0
    elif phase == "gi":
        assert rec["mean_abs_diff"] < rec["bound"]
    else:
        assert rec["flipped_pixel_share"] <= chip_smoke.MAX_FLIPPED_PIXELS
        assert rec["path"] == ("Whitted wave" if phase == "forward_mirror"
                               else "persistent wave")


@pytest.mark.parametrize("path", ["four_rays", "four_ring", "four_train"])
def test_four_device_path_on_virtual_cpus(path):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    with jax.enable_x64(False):
        rec = getattr(chip_smoke, path)(devices, size=SIZE)
    assert rec["devices"] == 4
    assert len(rec["peak_bytes_in_use_per_device"]) == 4
    if path == "four_train":
        assert rec["loss_rel_err"] <= chip_smoke.LOSS_REL_BOUND
    else:
        assert rec["flipped_pixel_share"] <= chip_smoke.MAX_FLIPPED_PIXELS


def test_env_phase_refuses_without_gpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("this host has a GPU")
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase_env()
    assert "no GPU" in str(e.value)


def test_main_prints_no_result_without_gpu(capsys):
    if jax.devices()[0].platform == "gpu":
        pytest.skip("this host has a GPU")
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert cache.use_compile_cache() == cache.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == cache.CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.dirname(cache.CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert os.path.basename(cache.CACHE_DIR) + "/" in ignored


@pytest.mark.gpu
def test_turbo_render_on_gpu_matches_cpu(tiny_prep, gpu):
    """The persistent-wave render on the card against the same render on
    the CPU backend of the same process."""
    from ray_tracer_tpu.config import apply_turbo
    from ray_tracer_tpu.render.renderer import prepare, render

    cfg = apply_turbo(tiny_prep.cfg, None)
    imgs = []
    for dev in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(dev), jax.enable_x64(False):
            imgs.append(np.asarray(render(prepare(
                cfg, scene=jax.device_put(tiny_prep.scene, dev)))))
    assert chip_smoke._flipped_share(*imgs) <= chip_smoke.MAX_FLIPPED_PIXELS
