"""Driver-hook coverage: __graft_entry__.entry / dryrun_multichip.

These tests run both hooks, including the failure mode of a process whose
JAX already initialized on fewer devices than requested.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__  # noqa: E402


def test_entry_compiles_and_runs():
    fn, example_args = __graft_entry__.entry()
    out = jax.jit(fn)(*example_args)
    out = np.asarray(jax.block_until_ready(out))
    assert out.ndim >= 1 and np.all(np.isfinite(out))
    assert np.all(np.abs(out) <= 1.0 + 1e-5)


@pytest.mark.slow  # the subprocess-bootstrap variant below is the driver's actual path
def test_dryrun_multichip_in_process():
    # conftest forces 8 virtual CPU devices, so this exercises the direct path
    __graft_entry__.dryrun_multichip(8)


def test_dryrun_multichip_bootstraps_from_single_device():
    """Emulate the driver: JAX initialized on ONE device, then dryrun(8).

    The child pins a 1-device CPU platform (as a one-card driver process
    has a 1-device platform), so dryrun_multichip must detect the shortfall
    and re-exec its own fresh subprocess with an 8-device virtual mesh.
    """
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("_DTC_TPU_DRYRUN_CHILD", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    code = (
        f"import sys; sys.path.insert(0, {REPO!r}); "
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "assert len(jax.devices()) == 1; "
        "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip OK on 8 devices" in proc.stdout, proc.stdout
