"""NaN-sanitizer API (utils/validation.py).

The reference has no sanitizers (SURVEY.md §5); this build guards every
engine materialization because device work is asynchronous and a fault can
surface only at the next materialization.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dtc_tpu.utils.validation import NumericalFault, checked, guard


def test_guard_passes_clean_data():
    x = np.linspace(-1.0, 1.0, 16).reshape(4, 4)
    out = guard("stage", x, bound=1.0, enabled=True)
    assert out is not None and np.array_equal(out, x)


def test_guard_returns_materialized_jax_array():
    x = jnp.ones((3, 2)) * 0.5
    out = guard("stage", x, bound=1.0, enabled=True)
    assert isinstance(out, np.ndarray) and out.shape == (3, 2)


def test_guard_raises_on_nan_with_location():
    x = np.zeros((2, 3))
    x[1, 2] = np.nan
    with pytest.raises(NumericalFault) as ei:
        guard("forward_batch", x, enabled=True)
    assert ei.value.name == "forward_batch"
    assert ei.value.first_index == (1, 2)
    assert ei.value.n_bad == 1


def test_guard_raises_on_inf_complex():
    x = np.zeros((4,), dtype=np.complex64)
    x[1] = complex(0.0, np.inf)
    with pytest.raises(NumericalFault):
        guard("dm", x, enabled=True)


def test_guard_bound_violation():
    x = np.array([0.1, -1.7, 0.3])
    with pytest.raises(NumericalFault) as ei:
        guard("autocorr", x, bound=1.0, enabled=True)
    assert "exceed" in str(ei.value)
    # within float32 tolerance of the bound is fine
    guard("autocorr", np.array([1.0 + 1e-7]), bound=1.0, enabled=True)
    # ... and so is a reduced-precision drift up to 2.7e-4: a saturated
    # |A| = 1 run must not raise
    guard("autocorr", np.array([1.0 + 2.7e-4]), bound=1.0, enabled=True)
    with pytest.raises(NumericalFault):  # real device garbage still caught
        guard("autocorr", np.array([1.01]), bound=1.0, enabled=True)


def test_guard_disabled_is_passthrough():
    x = np.array([np.nan])
    out = guard("stage", x, enabled=False)
    assert np.isnan(out[0])


def test_guard_ignores_integer_arrays():
    out = guard("counts", np.arange(5), enabled=True)
    assert out.sum() == 10


def test_checked_catches_in_trace_nan():
    def f(x):
        return jnp.log(x)  # NaN for negative input

    run = checked(f)
    assert np.isfinite(run(jnp.asarray(2.0)))
    with pytest.raises(NumericalFault):
        run(jnp.asarray(-1.0))


def test_engine_sweep_runs_under_guard():
    # end-to-end: the guarded forward/echo sweeps pass clean physics through
    import jax

    from dtc_tpu.experiments.engine import build_context, echo_sweep, forward_sweep
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.utils.config import SimConfig

    cfg = SimConfig(L=4, g=0.84, inst=1, tf=5, noise_prob=0.05, use_noise=1,
                    n_trajectories=16, dtype="complex128")
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=11)
    sched, params, noise = build_context(cfg, hs, phis)
    key = jax.random.PRNGKey(0)
    a = forward_sweep(cfg, sched, params, noise, key)
    e = echo_sweep(cfg, sched, params, noise, key)
    assert np.isfinite(a).all() and np.isfinite(e).all()
    assert (np.abs(a) <= 1.0 + 1e-5).all()
