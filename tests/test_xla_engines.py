"""The XLA engines at the sizes the card runs them at.

Trajectory-exact checks: each engine at complex64 against itself at
complex128 with identical presampled keys (the noise draws are float32
uniforms, independent of the state dtype), so any gap is float32 rounding
of the evolution (~1e-6 per cycle; tol 1e-4). Device-noise and energy
routes get the same treatment, plus the dense original-order oracles for
general drives under device noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dtc_tpu.core.sigma_evolve import sigma_echo_batch, sigma_forward_batch
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule

TOL = 1e-4


def _sigma_args(L, pol, T, n_traj, seed):
    hs, phis = generate_disorder(L, 1, seed=seed)
    sched = build_kick_schedule(pol, 0.97, T)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_traj)[None]
    return (jnp.asarray(hs[:, :L]), jnp.asarray(phis[:, :L - 1]),
            sched.angles, keys), sched.K


@pytest.mark.parametrize("mode", ["forward", "echo"])
@pytest.mark.parametrize("pol", ["x", "y", "xy", "circular_left"])
@pytest.mark.parametrize("L", [14, 18])
def test_sigma_engine_c64_matches_c128(L, pol, mode):
    T, p = 3, 0.3
    args, K = _sigma_args(L, pol, T, 2, seed=L)
    kw = dict(L=L, T=T, K=K, p=p, q=L // 2, initial_state="vacuum",
              ancilla_factor=(1 - p) ** 6, has_y=pol != "x")
    if mode == "forward":
        run = lambda dt: np.asarray(sigma_forward_batch(
            *args, dtype_name=dt, **kw))
    else:
        ts = jnp.asarray([1, T])
        run = lambda dt: np.asarray(sigma_echo_batch(
            *args, ts, dtype_name=dt, **kw))
    lo, hi = run("complex64"), run("complex128")
    assert lo.shape == hi.shape and np.all(np.isfinite(lo))
    assert np.all(np.abs(hi) <= 1.0 + 1e-9)
    np.testing.assert_allclose(lo, hi, atol=TOL)


def _device_inputs(L, seed):
    hs, phis = generate_disorder(L, 1, seed=seed)
    # exaggerated, site-varying rates so every event class fires
    p1 = jnp.linspace(0.05, 0.3, L)
    p2 = jnp.linspace(0.1, 0.4, L - 1)
    return jnp.asarray(hs[0, :L]), jnp.asarray(phis[0, :L - 1]), p1, p2


@pytest.mark.parametrize("mode", ["forward", "echo"])
def test_device_sigma_engine_x_drive_l17(mode):
    """The x-drive device-noise route (device_sweeps) at complex64 vs
    complex128, identical presampled events."""
    from dtc_tpu.core.device_evolve import (
        device_sigma_echo_batch,
        device_sigma_forward_batch,
    )

    L, T = 17, 3
    h, ph, p1, p2 = _device_inputs(L, seed=4)
    sched = build_kick_schedule("x", 0.95, T)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    kw = dict(L=L, T=T, q=L // 2, ancilla_factor=0.9)
    if mode == "forward":
        run = lambda dt: np.asarray(device_sigma_forward_batch(
            h, ph, p1, p2, sched.angles, keys, dtype_name=dt, **kw))
    else:
        ts = jnp.asarray([1, T])
        run = lambda dt: np.asarray(device_sigma_echo_batch(
            h, ph, p1, p2, sched.angles, keys, ts, dtype_name=dt, **kw))
    lo, hi = run("complex64"), run("complex128")
    assert np.all(np.isfinite(lo))
    np.testing.assert_allclose(lo, hi, atol=TOL)


@pytest.mark.parametrize("mode", ["forward", "echo"])
def test_device_gather_engine_general_drive_l14(mode):
    """General drives under device noise run the lab-frame gather engine.
    At zero rates it must equal the dense original-order oracle exactly
    (both are the noiseless unitary evolution), and with noise the two
    ensembles (independent draws) must agree within sampling error."""
    from dtc_tpu.core.device_evolve import (
        device_autocorr_echo,
        device_autocorr_forward,
        device_general_echo_oracle,
        device_general_forward_oracle,
    )

    L, T, q, pol = 14, 3, 7, "xy"
    h, ph, _, _ = _device_inputs(L, seed=7)
    sched = build_kick_schedule(pol, 0.97, T)
    kw = dict(L=L, T=T, K=sched.K, q=q, ancilla_factor=1.0)
    zeros1, zeros2 = jnp.zeros((L,)), jnp.zeros((L - 1,))
    p1 = jnp.full((L,), 0.02)
    p2 = jnp.full((L - 1,), 0.04)
    n = 64
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    if mode == "forward":
        eng = lambda a, b, ks: np.asarray(device_autocorr_forward(
            h, ph, a, b, sched.angles, ks, **kw))
        orc = lambda a, b, ks: np.asarray(device_general_forward_oracle(
            h, ph, a, b, sched.angles, ks, **kw))
    else:
        eng = lambda a, b, ks: np.asarray(device_autocorr_echo(
            h, ph, a, b, sched.angles, ks, jnp.asarray(T), **kw))
        orc = lambda a, b, ks: np.asarray([device_general_echo_oracle(
            h, ph, a, b, sched.angles, k, T, **kw) for k in ks])
    np.testing.assert_allclose(eng(zeros1, zeros2, keys[:1]),
                               orc(zeros1, zeros2, keys[:1]), atol=TOL)
    okeys = keys[:8] if mode == "echo" else keys
    e, o = eng(p1, p2, keys), orc(p1, p2, okeys)
    assert np.all(np.isfinite(e)) and np.all(np.abs(e) <= 1.0 + 1e-5)
    # per-trajectory values lie in [-1, 1]: 4 sigma of the two means' gap
    se = np.sqrt(e.var(axis=0) / len(e) + o.var(axis=0) / len(o)) + 1e-3
    assert np.all(np.abs(e.mean(axis=0) - o.mean(axis=0)) <= 4 * se), (
        e.mean(axis=0), o.mean(axis=0))


@pytest.mark.parametrize("pol,p,component", [
    ("x", 0.0, "full"), ("y", 0.3, "full"), ("xy", 0.3, "z_zz")])
def test_energy_route_l17_c64_matches_c128(pol, p, component):
    """experiments.energy's XLA observables route (energy + per-qubit Z)
    at complex64 vs complex128, identical keys; xy is a K=2 schedule."""
    from dtc_tpu.experiments.energy import _observables_batch
    from dtc_tpu.models.hamiltonian import hamiltonian_terms

    L, T = 17, 3
    hs, phis = generate_disorder(L, 1, seed=9)
    terms = hamiltonian_terms(L, 0.97, hs[0], phis[0], component)
    sched = build_kick_schedule(pol, 0.97, T)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)[None]
    with_x = bool(float(terms.x_coeff) != 0.0)

    def run(dt):
        e, z = _observables_batch(
            jnp.asarray(hs[:, :L]), jnp.asarray(phis[:, :L - 1]),
            terms.hs[None], terms.phis[None], jnp.asarray(terms.x_coeff),
            sched.angles, keys, L=L, T=T, K=sched.K, p=p, with_x=with_x,
            initial_state="vacuum", dtype_name=dt)
        return np.asarray(e), np.asarray(z)

    (e_lo, z_lo), (e_hi, z_hi) = run("complex64"), run("complex128")
    assert np.all(np.isfinite(e_lo)) and np.all(np.abs(z_hi) <= 1 + 1e-9)
    # E is a sum of ~2L O(1) terms: float32 error scales with it
    np.testing.assert_allclose(e_lo, e_hi, atol=TOL * 2 * L)
    np.testing.assert_allclose(z_lo, z_hi, atol=TOL)


# --- dispatch with a GPU backend -----------------------------------------


def _gpu_backend(monkeypatch):
    """Every module that once branched on the backend sees a GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _small_cfg(**kw):
    from dtc_tpu.utils.config import SimConfig

    base = dict(L=6, tf=3, g=0.97, noise_prob=0.1, n_trajectories=4)
    base.update(kw)
    return SimConfig(**base)


def _ctx(cfg):
    from dtc_tpu.experiments.engine import build_context

    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=1)
    return build_context(cfg, hs, phis), (hs, phis)


def _spy(monkeypatch, module, name, hits):
    real = getattr(module, name)

    def spy(*a, **k):
        hits.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


def _run_forward_sweep(monkeypatch, hits):
    import dtc_tpu.core.sigma_evolve as se
    from dtc_tpu.experiments.engine import forward_sweep

    _spy(monkeypatch, se, "sigma_forward_batch", hits)
    cfg = _small_cfg()
    (sched, params, noise), _ = _ctx(cfg)
    return forward_sweep(cfg, sched, params, noise, jax.random.PRNGKey(0))


def _run_echo_sweep(monkeypatch, hits):
    import dtc_tpu.core.sigma_evolve as se
    from dtc_tpu.experiments.engine import echo_sweep

    _spy(monkeypatch, se, "sigma_echo_batch", hits)
    cfg = _small_cfg(polarization="y")
    (sched, params, noise), _ = _ctx(cfg)
    return echo_sweep(cfg, sched, params, noise, jax.random.PRNGKey(0))


def _run_device_forward(monkeypatch, hits):
    import dtc_tpu.core.device_evolve as de
    from dtc_tpu.experiments.device_sweeps import device_forward_sweep

    _spy(monkeypatch, de, "device_sigma_forward_batch", hits)
    cfg = _small_cfg(use_fakebackend=1)
    (sched, params, _), _ = _ctx(cfg)
    return device_forward_sweep(cfg, sched, params, jax.random.PRNGKey(0))


def _run_device_echo(monkeypatch, hits):
    from dtc_tpu.experiments import device_sweeps

    _spy(monkeypatch, device_sweeps, "device_autocorr_echo", hits)
    cfg = _small_cfg(use_fakebackend=1, polarization="xy")
    (sched, params, _), _ = _ctx(cfg)
    return device_sweeps.device_echo_sweep(cfg, sched, params,
                                           jax.random.PRNGKey(0))


def _run_energy(monkeypatch, hits):
    from dtc_tpu.experiments import energy

    _spy(monkeypatch, energy, "_observables_batch", hits)
    cfg = _small_cfg()
    _, (hs, phis) = _ctx(cfg)
    e, _ = energy._energy_single_noise(cfg, hs, phis, 0.1)
    return e


def _run_stepper(monkeypatch, hits):
    from dtc_tpu.experiments import adaptive

    cfg = _small_cfg()
    _, (hs, phis) = _ctx(cfg)
    st = adaptive.make_stepper(cfg, hs[0], phis[0])
    hits.append(type(st).__name__)
    return np.asarray([st.forward_value(st.reset())])


def _run_sharded(monkeypatch, hits):
    from dtc_tpu.experiments import sharded_run

    _spy(monkeypatch, sharded_run, "make_sharded_autocorr_forward", hits)
    _spy(monkeypatch, sharded_run, "make_sharded_echo", hits)
    cfg = _small_cfg()
    r = sharded_run.run_autocorr_sharded(cfg, n_amp=2, write=False)
    return np.stack([r["av_autocorr"], r["av_autocorr_echo"]])


@pytest.mark.parametrize("entry,want,bound", [
    (_run_forward_sweep, ["sigma_forward_batch"], 1.0),
    (_run_echo_sweep, ["sigma_echo_batch"], 1.0),
    (_run_device_forward, ["device_sigma_forward_batch"], 1.0),
    (_run_device_echo, ["device_autocorr_echo"], 1.0),
    (_run_energy, ["_observables_batch"], None),
    (_run_stepper, ["AdaptiveStepper"], 1.0),
    (_run_sharded, ["make_sharded_autocorr_forward", "make_sharded_echo"],
     1.0),
], ids=["forward_sweep", "echo_sweep", "device_forward", "device_echo",
        "energy", "make_stepper", "run_autocorr_sharded"])
def test_gpu_backend_dispatch_lands_on_xla_engine(monkeypatch, entry, want,
                                                  bound):
    """With JAX reporting a GPU backend, every sweep entry point runs on the
    XLA engine (there is no other) and returns finite, bounded values."""
    _gpu_backend(monkeypatch)
    hits = []
    out = np.asarray(entry(monkeypatch, hits))
    assert sorted(set(hits)) == sorted(want), hits
    assert np.all(np.isfinite(out))
    if bound is not None:
        assert np.all(np.abs(out) <= bound + 1e-3)
