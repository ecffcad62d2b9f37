"""Runtime setup (utils/runtime.py) and the card-only entry points."""

import os
import subprocess
import sys

import jax
import pytest

from dtc_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_card_scripts_fail_without_a_gpu(script):
    """On a CPU-only platform both scripts exit non-zero before any work
    and never print the smoke test's ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout[-2000:]
    assert '"ok": true' not in r.stdout


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch,
                                                        cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert runtime.enable_compile_cache() == got  # same path every call


def test_parse_nvidia_smi():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 500.00 W\n\n")
    assert runtime.parse_nvidia_smi(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "500.00 W")]
    assert runtime.parse_nvidia_smi("") == []
    with pytest.raises(ValueError):
        runtime.parse_nvidia_smi("no separator here")
