"""Sigma engine for general drives (y/xy/circular, K >= 2) against a
literal lab-frame reference.

The lab-frame reference here evolves the literal statevector in numpy —
slot unitaries kron'd to 2^L, explicit X-permutation / Z-sign per sampled
Pauli, dense diagonal — from the SAME uniforms the engines presample, so it
checks trajectories one-for-one, not statistically. It is the arbiter that
exposed the spurious per-slot D0c correction in
core.sigma_evolve.inverse_cycle_fac (K>=2 echoes disagreed with the exact
oracle before the fix).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dtc_tpu.core.sigma_evolve import (
    _codes_from_uniform,
    _masks_from_codes,
    sigma_echo_batch,
    sigma_forward_batch,
)
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule, slot_unitary

import exact_oracle as oracle


# ---------------------------------------------------------------------------
# lab-frame numpy reference (trajectory-exact)


def _kron_all(u, L):
    m = np.array([[1.0]], complex)
    for _ in range(L):
        m = np.kron(u, m)  # qubit 0 = least significant bit
    return m


def _d0_mask(h, ph, L):
    s = np.arange(1 << L)
    z = 1 - 2 * ((s[:, None] >> np.arange(L)) & 1)
    ang = -0.5 * (z @ h) - 0.5 * ((z[:, :-1] * z[:, 1:]) @ ph)
    return np.exp(1j * ang)


def _xperm(state, xm, L):
    return state[np.arange(1 << L) ^ xm]


def _zsign(state, zm, L):
    s = np.arange(1 << L)
    par = np.zeros(1 << L, int)
    for q in range(L):
        if (zm >> q) & 1:
            par ^= (s >> q) & 1
    return state * (1 - 2 * par)


def lab_forward(L, T, K, angles, h, ph, xm, zm, q, af):
    """A(t), t=0..T-1, for ONE sampled Pauli stream (xm/zm shaped (T, K))."""
    d0 = _d0_mask(h, ph, L)
    v = np.zeros(1 << L, complex)
    v[0] = 1.0
    zq = 1 - 2 * ((np.arange(1 << L) >> q) & 1)
    out = []
    for t in range(T):
        out.append(af * np.sum(np.abs(v) ** 2 * zq))
        for k in range(K):
            u = np.asarray(slot_unitary(angles[t, k, 0], angles[t, k, 1],
                                        jnp.complex64))
            v = _kron_all(u, L) @ v
            v = _xperm(v, int(xm[t, k]), L)
            v = _zsign(v, int(zm[t, k]), L)
        v = d0 * v
    return np.array(out)


def lab_echo(L, t, T, K, angles, h, ph, xm, zm, q, af):
    """A0(t) for ONE sampled stream (xm/zm shaped (2T, K); steps >= 2t are
    already zeroed). Mirrors the reference's echo: t forward cycles, then t
    inverse cycles in reverse order with daggered slots
    (autocorr-delta-a-single-qiskit-fast.py:140-143)."""
    d0 = _d0_mask(h, ph, L)
    v = np.zeros(1 << L, complex)
    v[0] = 1.0
    for kstep in range(t):
        for k in range(K):
            u = np.asarray(slot_unitary(angles[kstep, k, 0],
                                        angles[kstep, k, 1], jnp.complex64))
            v = _kron_all(u, L) @ v
            v = _xperm(v, int(xm[kstep, k]), L)
            v = _zsign(v, int(zm[kstep, k]), L)
        v = d0 * v
    for kstep in range(t, 2 * t):
        i = 2 * t - 1 - kstep
        v = np.conj(d0) * v
        for j in range(K):
            slot = K - 1 - j
            u = np.asarray(slot_unitary(angles[i, slot, 0],
                                        angles[i, slot, 1], jnp.complex64))
            v = _kron_all(u, L).conj().T @ v
            v = _xperm(v, int(xm[kstep, j]), L)
            v = _zsign(v, int(zm[kstep, j]), L)
    zq = 1 - 2 * ((np.arange(1 << L) >> q) & 1)
    return af * np.sum(np.abs(v) ** 2 * zq)


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("pol", ["xy", "circular_left"])
def test_sigma_echo_k2_matches_lab_frame_per_trajectory(pol):
    """Regression for the K>=2 echo bug: trajectory-exact comparison against
    the literal lab-frame evolution from identical presampled uniforms."""
    L, T, p, g = 3, 3, 0.15, 0.9
    hs, phis = generate_disorder(L, 1, seed=51)
    sched = build_kick_schedule(pol, g, T)
    K = sched.K
    angles = np.asarray(sched.angles)
    ts = jnp.arange(T)
    ntraj = 12
    keys = jax.random.split(jax.random.PRNGKey(3), ntraj)[None]
    af = (1 - p) ** 6
    e = np.asarray(sigma_echo_batch(
        jnp.asarray(hs[:, :L]), jnp.asarray(phis[:, :L - 1]), sched.angles,
        keys, ts, L=L, T=T, K=K, p=p, q=L // 2, initial_state="vacuum",
        dtype_name="complex64", ancilla_factor=af, has_y=True))
    for traj in range(ntraj):
        u = jax.random.uniform(keys[0, traj], (2 * T, K, L), dtype=jnp.float32)
        codes_all = np.asarray(_codes_from_uniform(u, p))
        for t in range(T):
            codes = np.where((np.arange(2 * T) < 2 * t)[:, None, None],
                             codes_all, 0)
            xm, zm = _masks_from_codes(jnp.asarray(codes), L)
            want = lab_echo(L, t, T, K, angles, hs[0, :L], phis[0, :L - 1],
                            np.asarray(xm), np.asarray(zm), L // 2, af)
            np.testing.assert_allclose(e[0, traj, t], want, atol=2e-5)


def test_sigma_forward_k2_matches_lab_frame_per_trajectory():
    L, T, p, g = 3, 4, 0.15, 0.9
    hs, phis = generate_disorder(L, 1, seed=52)
    sched = build_kick_schedule("xy", g, T)
    K = sched.K
    angles = np.asarray(sched.angles)
    ntraj = 12
    keys = jax.random.split(jax.random.PRNGKey(5), ntraj)[None]
    af = (1 - p) ** 6
    vals = np.asarray(sigma_forward_batch(
        jnp.asarray(hs[:, :L]), jnp.asarray(phis[:, :L - 1]), sched.angles,
        keys, L=L, T=T, K=K, p=p, q=L // 2, initial_state="vacuum",
        dtype_name="complex64", ancilla_factor=af, has_y=True))
    for traj in range(ntraj):
        u = jax.random.uniform(keys[0, traj], (T * K, L), dtype=jnp.float32)
        codes = _codes_from_uniform(u, p)
        xm, zm = _masks_from_codes(codes, L)
        want = lab_forward(L, T, K, angles, hs[0, :L], phis[0, :L - 1],
                           np.asarray(xm).reshape(T, K),
                           np.asarray(zm).reshape(T, K), L // 2, af)
        np.testing.assert_allclose(vals[0, traj], want, atol=2e-5)


def test_sigma_echo_k2_matches_oracle_statistically():
    """Mean over trajectories vs the exact density-matrix oracle (the check
    that first exposed the bug)."""
    L, T, p, g, pol = 3, 3, 0.1, 0.9, "xy"
    hs, phis = generate_disorder(L, 1, seed=51)
    sched = build_kick_schedule(pol, g, T)
    ts = jnp.arange(T)
    keys = jax.random.split(jax.random.PRNGKey(3), 3000)[None]
    e = np.asarray(sigma_echo_batch(
        jnp.asarray(hs[:, :L]), jnp.asarray(phis[:, :L - 1]), sched.angles,
        keys, ts, L=L, T=T, K=sched.K, p=p, q=L // 2, initial_state="vacuum",
        dtype_name="complex64", ancilla_factor=(1 - p) ** 6, has_y=True))
    mean = e[0].mean(axis=0)
    for t in range(T):
        want = oracle.autocorr_dm(L, g, hs[0], phis[0], t, p, echo=True,
                                  polarization=pol)
        assert abs(mean[t] - want) < 0.03, (t, mean[t], want)


def test_forward_sweep_y_on_cpu_unaffected():
    """End-to-end y-polarized sweep still runs through the sigma engine on
    CPU meshes and respects |A| <= 1."""
    from dtc_tpu.experiments.engine import (
        build_context,
        echo_sweep,
        forward_sweep,
    )
    from dtc_tpu.utils.config import SimConfig

    cfg = SimConfig(L=4, tf=4, inst=1, g=0.9, noise_prob=0.1,
                    n_trajectories=8, polarization="y")
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=7)
    sched, params, noise = build_context(cfg, hs, phis)
    key = jax.random.PRNGKey(0)
    a = forward_sweep(cfg, sched, params, noise, key)
    e = echo_sweep(cfg, sched, params, noise, key)
    assert a.shape == (1, 4) and e.shape == (1, 4)
    assert np.all(np.abs(a) <= 1.0 + 1e-5)
    assert np.all(np.abs(e) <= 1.0 + 1e-5)
