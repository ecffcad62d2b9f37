"""Adaptive-g control: stepper correctness, feedback laws, optimizer, drivers."""

import jax
import numpy as np

from dtc_tpu.core.evolve import autocorr_forward
from dtc_tpu.core.density import dm_autocorr_echo
from dtc_tpu.core.statevector import initial_statevector
from dtc_tpu.experiments.adaptive import (
    AdaptiveStepper,
    adjust_g_schedule,
    exponential_g_adjustment,
    golden_section_minimize,
    linear_g_adjustment,
    run_adaptive_batch,
    run_adaptive_realtime,
)
from dtc_tpu.io import csvio
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule
from dtc_tpu.ops.diag import zz_z_phase_mask
from dtc_tpu.utils.config import SimConfig

import jax.numpy as jnp

CFG = SimConfig(L=3, g=0.84, inst=1, tf=5, noise_prob=0.0, use_noise=0,
                dtype="complex128", target_echo=1.0, feedback_gain=0.05)


def test_stepper_matches_core_forward_noiseless():
    hs, phis = generate_disorder(CFG.L, 1, seed=20)
    stepper = AdaptiveStepper(CFG, hs[0], phis[0])
    states = stepper.reset()
    key = jax.random.PRNGKey(0)

    sched = build_kick_schedule("x", CFG.g, CFG.tf + 1)
    diag = zz_z_phase_mask(jnp.asarray(hs[0]), jnp.asarray(phis[0]), CFG.L,
                           dtype=jnp.complex128)
    psi0 = initial_statevector(CFG.L, "vacuum", dtype=jnp.complex128)
    ref = autocorr_forward(psi0, sched.angles, diag, key,
                           L=CFG.L, T=CFG.tf + 1, K=1, p=0.0, q=CFG.L // 2)
    g_sched = np.full(CFG.tf, CFG.g)
    for t in range(CFG.tf):
        k, key = jax.random.split(key)
        prev = states
        states = stepper.advance(states, CFG.g, t, k)
        # forward value after t+1 cycles == core scan emission at index t+1
        np.testing.assert_allclose(stepper.forward_value(states),
                                   float(ref[t + 1]), atol=1e-10)
        # noiseless echo identity
        np.testing.assert_allclose(
            stepper.echo_value(prev, g_sched, CFG.g, t + 1, k), 1.0, atol=1e-10)


def test_stepper_echo_matches_exact_dm():
    """Trajectory echo estimate from the carried stepper vs exact DM echo."""
    cfg = CFG.replace(noise_prob=0.1, use_noise=1, n_trajectories=3000)
    hs, phis = generate_disorder(cfg.L, 1, seed=21)
    stepper = AdaptiveStepper(cfg, hs[0], phis[0])
    states = stepper.reset()
    key = jax.random.PRNGKey(5)
    g_sched = np.full(cfg.tf, cfg.g)

    diag = zz_z_phase_mask(jnp.asarray(hs[0]), jnp.asarray(phis[0]), cfg.L,
                           dtype=jnp.complex128)
    psi0 = initial_statevector(cfg.L, "vacuum", dtype=jnp.complex128)
    sched = build_kick_schedule("x", cfg.g, cfg.tf)

    for t in range(3):
        k_adv, k_echo, key = jax.random.split(key, 3)
        est = stepper.echo_value(states, g_sched, cfg.g, t + 1, k_echo)
        exact = float(dm_autocorr_echo(
            psi0, sched.angles, diag, jnp.asarray(t + 1),
            L=cfg.L, T=cfg.tf, K=1, p=cfg.noise_prob, q=cfg.L // 2))
        assert abs(est - exact) < 0.05, (t, est, exact)
        states = stepper.advance(states, cfg.g, t, k_adv)


def test_feedback_laws():
    # linear: error>0 raises g, clipped at bounds
    assert linear_g_adjustment(0.8, 1.0, 0.9, 0.5, 0.84, 1.0) == 1.0
    assert linear_g_adjustment(0.8, 1.0, 0.9, 0.05, 0.84, 1.0) > 0.9
    assert linear_g_adjustment(1.2, 1.0, 0.85, 0.5, 0.84, 1.0) == 0.84
    # exponential grows with time_step
    g1 = exponential_g_adjustment(0.5, 1.0, 0.9, 1, 0.01, 0.1, 0.84, 2.0)
    g2 = exponential_g_adjustment(0.5, 1.0, 0.9, 10, 0.01, 0.1, 0.84, 2.0)
    assert g2 > g1 > 0.9
    # tiny echo triggers the strong-correction branch
    g3 = exponential_g_adjustment(0.001, 1.0, 0.9, 0, 0.01, 0.1, 0.84, 2.0)
    assert g3 > 0.9


def test_adjust_g_schedule_uses_previous_echo():
    echo = [0.9, 0.8, 0.7]
    out = adjust_g_schedule(echo, [0.9] * 3, 1.0, 0.1, 0.0, 2.0)
    assert out[0] == 0.9
    np.testing.assert_allclose(out[1], 0.9 + 0.1 * 0.1)
    np.testing.assert_allclose(out[2], 0.9 + 0.1 * 0.2)


def test_golden_section():
    g = golden_section_minimize(lambda x: (x - 0.91) ** 2, 0.84, 1.0, iters=30)
    assert abs(g - 0.91) < 1e-4


def test_run_adaptive_realtime_noiseless_keeps_g(tmp_path):
    # noiseless: echo == target == 1 -> linear feedback never moves g
    cfg = CFG.replace(use_optimization=0, exponential_feedback=0)
    r = run_adaptive_realtime(cfg, *generate_disorder(cfg.L, 1, seed=22),
                              out_dir=str(tmp_path))
    np.testing.assert_allclose(r["av_g_values"], cfg.g, atol=1e-12)
    np.testing.assert_allclose(r["av_autocorr_echo_adaptive"], 1.0, atol=1e-10)
    cols = csvio.read_columns(r["csv_path"])
    for c in ("av_autocorr_adaptive", "av_autocorr_echo_adaptive", "av_g_values",
              "av_autocorr_standard", "sqrt_av_autocorr_echo_adaptive",
              "g_history_inst1", "echo_adaptive_inst1", "forward_adaptive_inst1"):
        assert c in cols, c
    gh = csvio.read_columns(r["g_history_csv_path"])
    assert "inst1_g_values" in gh and "inst1_echo_values" in gh


def test_run_adaptive_realtime_optimizer_noisy(tmp_path):
    cfg = CFG.replace(noise_prob=0.08, use_noise=1, n_trajectories=128,
                      use_optimization=1, tf=4)
    r = run_adaptive_realtime(cfg, *generate_disorder(cfg.L, 1, seed=23),
                              out_dir=str(tmp_path), optimizer_method="golden")
    g = r["g_history"][0]
    assert np.all(g >= cfg.g_min - 1e-12) and np.all(g <= cfg.g_max + 1e-12)
    # echo decays under noise but must stay in [0, 1]ish range
    assert np.all(r["echo"][0] <= 1.01)


def test_run_adaptive_batch(tmp_path):
    cfg = CFG.replace(noise_prob=0.05, use_noise=1, n_trajectories=64,
                      exponential_feedback=0, use_optimization=0, tf=4)
    r = run_adaptive_batch(cfg, *generate_disorder(cfg.L, 1, seed=24),
                           out_dir=str(tmp_path))
    assert r["g_history"].shape == (1, 4)
    # noisy echo < 1 -> batch feedback raises g after t=0
    assert np.all(r["g_history"][0][1:] >= cfg.g)


def test_kernel_stepper_matches_carried_noiseless():
    """KernelAdaptiveStepper (engine-batcher path, sigma fallback on CPU)
    reproduces the carried stepper exactly in the noiseless case."""
    from dtc_tpu.experiments.adaptive import KernelAdaptiveStepper

    hs, phis = generate_disorder(CFG.L, 1, seed=20)
    ks = KernelAdaptiveStepper(CFG, hs[0], phis[0])
    cs = AdaptiveStepper(CFG, hs[0], phis[0])
    k_states, c_states = ks.reset(), cs.reset()
    key = jax.random.PRNGKey(0)
    g_sched = np.full(CFG.tf, CFG.g)
    for t in range(CFG.tf):
        k, key = jax.random.split(key)
        c_prev = c_states
        k_states = ks.advance(k_states, CFG.g, t, k)
        c_states = cs.advance(c_states, CFG.g, t, k)
        np.testing.assert_allclose(ks.forward_value(k_states),
                                   cs.forward_value(c_states), atol=1e-7)
        np.testing.assert_allclose(
            ks.echo_value(t, g_sched, CFG.g, t + 1, k), 1.0, atol=1e-6)


def test_kernel_stepper_noisy_echo_vs_exact_dm():
    from dtc_tpu.experiments.adaptive import KernelAdaptiveStepper

    cfg = CFG.replace(noise_prob=0.1, use_noise=1, n_trajectories=3000,
                      dtype="complex64")
    hs, phis = generate_disorder(cfg.L, 1, seed=21)
    ks = KernelAdaptiveStepper(cfg, hs[0], phis[0])
    ks.reset()
    g_sched = np.full(cfg.tf, cfg.g)

    diag = zz_z_phase_mask(jnp.asarray(hs[0]), jnp.asarray(phis[0]), cfg.L,
                           dtype=jnp.complex128)
    psi0 = initial_statevector(cfg.L, "vacuum", dtype=jnp.complex128)
    sched = build_kick_schedule("x", cfg.g, cfg.tf)
    for t in range(2):
        est = ks.echo_value(t, g_sched, cfg.g, t + 1, None)
        exact = float(dm_autocorr_echo(
            psi0, sched.angles, diag, jnp.asarray(t + 1),
            L=cfg.L, T=cfg.tf, K=1, p=cfg.noise_prob, q=cfg.L // 2))
        assert abs(est - exact) < 0.05, (t, est, exact)


def test_make_stepper_selection(monkeypatch):
    from dtc_tpu.experiments import adaptive as ad

    hs, phis = generate_disorder(CFG.L, 1, seed=20)
    # auto -> carried on every backend
    assert isinstance(ad.make_stepper(CFG, hs[0], phis[0]),
                      ad.AdaptiveStepper)
    monkeypatch.setenv("DTC_TPU_ADAPTIVE", "kernel")
    assert isinstance(ad.make_stepper(CFG, hs[0], phis[0]),
                      ad.KernelAdaptiveStepper)
    monkeypatch.setenv("DTC_TPU_ADAPTIVE", "carried")
    assert isinstance(ad.make_stepper(CFG, hs[0], phis[0]),
                      ad.AdaptiveStepper)


def test_kernel_stepper_nonuniform_schedule_forward():
    """Schedule-placement regression: forward_value IS g-schedule-sensitive
    (unlike the noiseless echo, where U†U = 1 for ANY schedule), so
    advancing the two steppers through a NON-uniform g history must agree
    at every cycle — a misfiled g slot in either shows up immediately."""
    from dtc_tpu.experiments.adaptive import KernelAdaptiveStepper

    hs, phis = generate_disorder(CFG.L, 1, seed=25)
    ks = KernelAdaptiveStepper(CFG, hs[0], phis[0])
    cs = AdaptiveStepper(CFG, hs[0], phis[0])
    k_states, c_states = ks.reset(), cs.reset()
    gs = [0.86, 0.99, 0.90, 0.95, 0.88]
    key = jax.random.PRNGKey(2)
    for t in range(CFG.tf):
        k, key = jax.random.split(key)
        k_states = ks.advance(k_states, gs[t], t, k)
        c_states = cs.advance(c_states, gs[t], t, k)
        np.testing.assert_allclose(ks.forward_value(k_states),
                                   cs.forward_value(c_states), atol=1e-7)


def test_kernel_stepper_echo_schedule_placement(monkeypatch):
    """echo_value must evolve through g_schedule for cycles < t_next-1 and
    put g_last at EXACTLY cycle t_next-1 (the optimizer's candidate slot).
    The noiseless echo cannot distinguish placements (the unitary part
    cancels for any schedule), so assert the constructed angles directly."""
    from dtc_tpu.experiments import adaptive as ad

    hs, phis = generate_disorder(CFG.L, 1, seed=26)
    ks = ad.KernelAdaptiveStepper(CFG, hs[0], phis[0])
    ks.reset()
    captured = {}

    def fake_echo_batch(h, ph, angles, keys, ts, **kw):
        captured["angles"] = np.asarray(angles)
        captured["ts"] = np.asarray(ts)
        return jnp.zeros((1, keys.shape[1], 1))

    import dtc_tpu.core.sigma_evolve as se

    monkeypatch.setattr(se, "sigma_echo_batch", fake_echo_batch)
    g_sched = [0.86, 0.99]
    t_next, g_last = 3, 0.93
    ks.echo_value(t_next - 1, g_sched, g_last, t_next, None)
    ang = captured["angles"]  # (T+1, K, 2); x-pol: theta_x = pi * g
    np.testing.assert_allclose(ang[0, 0, 0], np.pi * 0.86, rtol=1e-6)
    np.testing.assert_allclose(ang[1, 0, 0], np.pi * 0.99, rtol=1e-6)
    np.testing.assert_allclose(ang[t_next - 1, 0, 0], np.pi * g_last,
                               rtol=1e-6)
    np.testing.assert_allclose(ang[t_next, 0, 0], np.pi * CFG.g, rtol=1e-6)
    assert captured["ts"] == [t_next]
