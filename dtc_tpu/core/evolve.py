"""Floquet evolution engines.

Design (contrast with the reference): the reference rebuilds and re-simulates
the full circuit from t=0 for every time point — O(inst * tf^2) cycle
applications (autocorr-delta-a-single-qiskit-fast.py:217-239). Here a single
``lax.scan`` over cycles evolves once and emits the observable at every cycle
— O(tf) — and disorder instances / noise trajectories are ``vmap`` axes.

Autocorrelator: instead of literally building the ancilla Hadamard test
(fast.py:124-147), the direct mode uses the operator identity

    A(t) = Re <psi| V^dag Z_q V Z_q |psi>,   V = U_F^t  (echo: V = U^dag^t U^t)

evolving two branches phi1 = V|psi>, phi2 = V Z_q|psi> under the SAME
trajectory noise (a sampled Pauli acts on the full superposed state in the
faithful picture, i.e. identically on both branches), and folding the six
noisy ancilla u2 gates into the exact analytic (1-p)^6 prefactor (see
dtc_tpu.models.noise).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dtc_tpu.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu.ops.gates import expect_x, expect_z
from dtc_tpu.ops.kick import apply_uniform_1q_layer
from dtc_tpu.ops.paulis import (
    apply_pauli_string,
    pauli_string_masks,
    sample_depolarizing_codes,
)


def make_floquet_params(hs, phis, L: int, *, dtype=jnp.complex64):
    """Precompute per-instance masks: fused diagonal phase, probe-Z sign."""
    diag = zz_z_phase_mask(hs[:L], phis[: L - 1], L, dtype=dtype)
    return diag


def _noise_layer(state, key, p, L, active=None):
    codes = sample_depolarizing_codes(key, p, (L,))
    if active is not None:
        codes = jnp.where(active, codes, 0)
    xm, zm, ny = pauli_string_masks(codes)
    return apply_pauli_string(state, xm, zm, ny)


def forward_cycle(state, angles, diag_mask, *, L, K, p, key=None, dtype=jnp.complex64):
    """One forward Floquet cycle: kick slots (+noise after each), fused diagonal."""
    for k in range(K):
        u = slot_unitary(angles[k, 0], angles[k, 1], dtype)
        state = apply_uniform_1q_layer(state, u, L)
        if p > 0.0:
            state = _noise_layer(state, jax.random.fold_in(key, k), p, L)
    return state * diag_mask


def inverse_cycle(state, angles, diag_mask, *, L, K, p, key=None, dtype=jnp.complex64):
    """One inverse cycle: conj(diagonal), then inverse slots in reverse order."""
    state = state * jnp.conj(diag_mask)
    for k in range(K - 1, -1, -1):
        u = slot_unitary_inverse(angles[k, 0], angles[k, 1], dtype)
        state = apply_uniform_1q_layer(state, u, L)
        if p > 0.0:
            state = _noise_layer(state, jax.random.fold_in(key, K + k), p, L)
    return state


def _branch_pair(psi0, zq_sign):
    """Stack (phi1, phi2) = (|psi>, Z_q|psi>) on a leading axis of size 2."""
    return jnp.stack([psi0, psi0 * zq_sign.astype(psi0.dtype)])


def _branch_autocorr(state, zq_sign, ancilla_factor):
    return ancilla_factor * jnp.real(
        jnp.sum(jnp.conj(state[0]) * zq_sign.astype(state.dtype) * state[1], axis=-1)
    )


@functools.partial(jax.jit, static_argnames=("L", "T", "K", "p", "q", "ancilla_factor"))
def autocorr_forward(
    psi0, angles, diag_mask, key, *, L, T, K, p, q, ancilla_factor=1.0
):
    """A(t) for t = 0..T-1 in ONE scan.

    psi0: (2**L,), angles: (T, K, 2), diag_mask: (2**L,) complex.
    Returns (T,) real autocorrelations (Aer-noise-equivalent in expectation
    when p > 0; exact when p == 0).
    """
    zq = z_sign_mask(q, L)
    state = _branch_pair(psi0, zq)
    keys = jax.random.split(key, T)

    def body(carry, inp):
        ang, k_t = inp
        a_t = _branch_autocorr(carry, zq, ancilla_factor)
        carry = forward_cycle(carry, ang, diag_mask, L=L, K=K, p=p, key=k_t, dtype=psi0.dtype)
        return carry, a_t

    _, a = jax.lax.scan(body, state, (angles, keys))
    return a


@functools.partial(
    jax.jit, static_argnames=("L", "T", "K", "p", "q", "ancilla_factor")
)
def autocorr_echo(
    psi0, angles, diag_mask, key, t_value, *, L, T, K, p, q, ancilla_factor=1.0
):
    """Echo A0(t) for a single (traced) t: t forward cycles then t inverse
    cycles in reverse time order (...-fast-circular-polarization.py:164-172).

    Runs a fixed-length masked scan of 2T steps so one compilation serves all
    t; vmap over ``t_value`` for a batch of time points.
    """
    dtype = psi0.dtype
    zq = z_sign_mask(q, L)
    state = _branch_pair(psi0, zq)
    keys = jax.random.split(key, 2 * T)
    eye = jnp.eye(2, dtype=dtype)
    ks = jnp.arange(2 * T)

    def body(carry, inp):
        k, key_k = inp
        fwd = k < t_value
        inv = (k >= t_value) & (k < 2 * t_value)
        active = fwd | inv
        idx = jnp.where(fwd, k, jnp.clip(2 * t_value - 1 - k, 0, T - 1))
        ang = angles[idx]  # (K, 2)
        state = jnp.where(inv, jnp.conj(diag_mask), jnp.ones((), dtype)) * carry
        for pos in range(K):
            th_f = ang[pos]
            th_i = ang[K - 1 - pos]
            u_f = slot_unitary(th_f[0], th_f[1], dtype)
            u_i = slot_unitary_inverse(th_i[0], th_i[1], dtype)
            u = jnp.where(fwd, u_f, jnp.where(inv, u_i, eye))
            state = apply_uniform_1q_layer(state, u, L)
            if p > 0.0:
                state = _noise_layer(
                    state, jax.random.fold_in(key_k, pos), p, L, active=active
                )
        state = jnp.where(fwd, diag_mask, jnp.ones((), dtype)) * state
        return state, None

    state, _ = jax.lax.scan(body, state, (ks, keys))
    return _branch_autocorr(state, zq, ancilla_factor)


@functools.partial(
    jax.jit, static_argnames=("L", "T", "K", "p", "with_x", "estimator_noise_factor")
)
def evolve_observables(
    psi0,
    angles,
    diag_mask,
    diag_energy,
    x_coeff,
    key,
    *,
    L,
    T,
    K,
    p,
    with_x=True,
    estimator_noise_factor=1.0,
):
    """Single-branch evolution emitting energy E(t) and per-qubit <Z_i(t)>.

    E(t) = sum_s |psi_s|^2 diag_energy(s) + x_coeff * sum_q <X_q>
    (the Z/ZZ part is one masked reduction; X terms are pair reductions —
    no measurement-basis circuits needed, cf.
    autocorr-delta-a-single-qiskit-fast-energy.py:168-172).
    ``estimator_noise_factor`` optionally contracts the X part by (1-p) to
    mirror BackendEstimatorV2's noisy basis-rotation u2 gates.

    Noise codes are PRESAMPLED in one PRNG call outside the scan
    (uniform(key, (T, K, L)) row-major, the same stream layout as the
    sigma engine's presample). The eager Pauli application stays: <X_q>
    is measured every cycle, and an off-diagonal observable cannot ride a
    deferred XOR frame with pending phase corrections.
    """
    from dtc_tpu.core.sigma_evolve import _codes_from_uniform

    if p > 0.0:
        u = jax.random.uniform(key, (T, K, L), dtype=jnp.float32)
        codes = _codes_from_uniform(u, p)
    else:
        codes = jnp.zeros((T, K, L), jnp.int32)

    def measure(state):
        probs = jnp.abs(state) ** 2
        e_diag = jnp.sum(probs * diag_energy)
        zs = jnp.stack([expect_z(state, qq, L) for qq in range(L)])
        if with_x:
            xs = jnp.stack([expect_x(state, qq, L) for qq in range(L)])
            e = e_diag + x_coeff * estimator_noise_factor * jnp.sum(xs)
        else:
            e = e_diag
        return e, zs

    def body(carry, inp):
        ang, codes_t = inp
        out = measure(carry)
        state = carry
        for k in range(K):
            uk = slot_unitary(ang[k, 0], ang[k, 1], psi0.dtype)
            state = apply_uniform_1q_layer(state, uk, L)
            if p > 0.0:
                xm, zm, ny = pauli_string_masks(codes_t[k])
                state = apply_pauli_string(state, xm, zm, ny)
        return state * diag_mask, out

    _, (energy, zs) = jax.lax.scan(body, psi0, (angles, codes))
    return energy, zs
