"""Floquet evolution under DEVICE noise models (calibration-derived).

Differences vs the flat Aer-custom model (core.evolve):
- per-SITE 1q depolarizing probabilities (p_1q vector) after each kick gate
  (x `events_per_kick`, default 2: on heavy-hex hardware rx transpiles to
  two sx pulses, each carrying the 1q error);
- per-BOND 2q depolarizing after each RZZ sublayer — so the diagonal is
  split into even-bond / odd-bond / field masks instead of one fused mask
  (2q Pauli errors do not commute through the other sublayer);
- readout assignment errors applied as exact (1-2*eps) contractions.

Mirrors NoiseModel.from_backend(FakeBrisbane()) usage
(autocorr-delta-a-single-qiskit-fast.py:77-79, use_fakebackend=1) with a
calibration-schema import instead of a qiskit backend object.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.core.statevector import initial_statevector
from dtc_tpu.models.drives import slot_unitary
from dtc_tpu.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu.ops.kick import apply_uniform_1q_layer
from dtc_tpu.ops.paulis import (
    apply_pauli_string,
    pauli_string_masks,
    sample_bond_depolarizing_codes,
    sample_depolarizing_codes,
)


def _masks_split(hs, phis, L, dtype):
    """(even-bond, odd-bond, field) phase masks whose product is the fused one."""
    zeros_h = jnp.zeros_like(hs)
    zeros_p = jnp.zeros_like(phis)
    idx = jnp.arange(L - 1)
    phis_even = jnp.where(idx % 2 == 0, phis, 0.0)
    phis_odd = jnp.where(idx % 2 == 1, phis, 0.0)
    m_even = zz_z_phase_mask(zeros_h, phis_even, L, dtype=dtype)
    m_odd = zz_z_phase_mask(zeros_h, phis_odd, L, dtype=dtype)
    m_field = zz_z_phase_mask(hs, zeros_p, L, dtype=dtype)
    return m_even, m_odd, m_field


def _apply_codes(state, codes):
    xm, zm, ny = pauli_string_masks(codes)
    return apply_pauli_string(state, xm, zm, ny)


def device_forward_cycle(state, ang, masks, p_1q, p_2q, key, *, L, K, dtype,
                         events_per_kick=2):
    m_even, m_odd, m_field = masks
    idx = jnp.arange(L - 1)
    p2_even = jnp.where(idx % 2 == 0, p_2q, 0.0)[::2]
    p2_odd = jnp.where(idx % 2 == 1, p_2q, 0.0)[1::2]
    for k in range(K):
        u = slot_unitary(ang[k, 0], ang[k, 1], dtype)
        state = apply_uniform_1q_layer(state, u, L)
        for ev in range(events_per_kick):
            codes = sample_depolarizing_codes(
                jax.random.fold_in(key, 7 * k + ev), p_1q, (L,))
            state = _apply_codes(state, codes)
    state = state * m_even
    state = _apply_codes(state, sample_bond_depolarizing_codes(
        jax.random.fold_in(key, 101), p2_even, 0, L))
    state = state * m_odd
    state = _apply_codes(state, sample_bond_depolarizing_codes(
        jax.random.fold_in(key, 102), p2_odd, 1, L))
    state = state * m_field  # rz is virtual on hardware: no error
    return state


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "q", "initial_state", "dtype_name",
                     "events_per_kick"),
)
def device_autocorr_forward(hs, phis, p_1q, p_2q, angles, keys, *, L, T, K, q,
                            initial_state="vacuum", dtype_name="complex64",
                            ancilla_factor=1.0, events_per_kick=2):
    """Trajectory-batched A(t) under a device-noise model.

    Real-boundary jit: (L,), (L-1,) calibration vectors; keys (n_traj, 2);
    returns (n_traj, T). `ancilla_factor` should come from
    DeviceNoiseModel.ancilla_interferometric_factor() x readout contraction.
    """
    from dtc_tpu.experiments.engine import resolve_dtype

    dtype = resolve_dtype(dtype_name)
    masks = _masks_split(hs, phis, L, dtype)
    zq = z_sign_mask(q, L)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    # vacuum/neel are Z eigenstates: single-state A(t) = s0 * <Z_q(t)>
    from dtc_tpu.core.statevector import neel_index

    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    state0 = psi0

    def one_traj(key):
        keys_t = jax.random.split(key, T)

        def body(carry, inp):
            ang, k_t = inp
            a_t = ancilla_factor * s0 * jnp.sum(
                (jnp.real(carry) ** 2 + jnp.imag(carry) ** 2)
                * zq.astype(jnp.float32))
            carry = device_forward_cycle(
                carry, ang, masks, p_1q, p_2q, k_t, L=L, K=K, dtype=dtype,
                events_per_kick=events_per_kick)
            return carry, a_t

        _, a = jax.lax.scan(body, state0, (angles, keys_t))
        return a

    return jax.vmap(one_traj)(keys)


def device_inverse_cycle(state, ang, masks, p_1q, p_2q, key, *, L, K, dtype,
                         events_per_kick=2, active=None):
    """Inverse cycle with device noise: reversed sublayers, daggered gates,
    noise after each (inverse) hardware gate; `active` masks noise off for
    padding steps in the fixed-length echo scan."""
    from dtc_tpu.models.drives import slot_unitary_inverse

    m_even, m_odd, m_field = masks
    p2_even = p_2q[0::2]
    p2_odd = p_2q[1::2]

    def codes_1q(salt):
        c = sample_depolarizing_codes(jax.random.fold_in(key, salt), p_1q, (L,))
        return c if active is None else jnp.where(active, c, 0)

    def codes_2q(salt, pb, start):
        c = sample_bond_depolarizing_codes(jax.random.fold_in(key, salt), pb, start, L)
        return c if active is None else jnp.where(active, c, 0)

    state = state * jnp.conj(m_field)
    state = state * jnp.conj(m_odd)
    state = _apply_codes(state, codes_2q(202, p2_odd, 1))
    state = state * jnp.conj(m_even)
    state = _apply_codes(state, codes_2q(201, p2_even, 0))
    for k in range(K - 1, -1, -1):
        u = slot_unitary_inverse(ang[k, 0], ang[k, 1], dtype)
        state = apply_uniform_1q_layer(state, u, L)
        for ev in range(events_per_kick):
            state = _apply_codes(state, codes_1q(7 * k + ev + 300))
    return state


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "q", "initial_state", "dtype_name",
                     "events_per_kick"),
)
def device_autocorr_echo(hs, phis, p_1q, p_2q, angles, keys, t_value, *, L, T,
                         K, q, initial_state="vacuum", dtype_name="complex64",
                         ancilla_factor=1.0, events_per_kick=2):
    """Trajectory-batched device-noise echo A0(t): fixed-length masked scan."""
    from dtc_tpu.experiments.engine import resolve_dtype

    dtype = resolve_dtype(dtype_name)
    masks = _masks_split(hs, phis, L, dtype)
    zq = z_sign_mask(q, L)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    from dtc_tpu.core.statevector import neel_index

    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    state0 = psi0

    def one_traj(key):
        keys_t = jax.random.split(key, 2 * T)

        def body(carry, inp):
            kstep, key_k = inp
            fwd = kstep < t_value
            inv = (kstep >= t_value) & (kstep < 2 * t_value)
            idx = jnp.where(fwd, kstep, jnp.clip(2 * t_value - 1 - kstep, 0, T - 1))
            ang = angles[idx]
            # forward branch (noise masked off when not fwd)
            st_f = device_forward_cycle(
                carry, jnp.where(fwd, ang, jnp.zeros_like(ang)),
                tuple(jnp.where(fwd, m, jnp.ones_like(m)) for m in masks),
                jnp.where(fwd, p_1q, 0.0), jnp.where(fwd, p_2q, 0.0),
                key_k, L=L, K=K, dtype=dtype, events_per_kick=events_per_kick)
            # inverse branch
            st_i = device_inverse_cycle(
                carry, jnp.where(inv, ang, jnp.zeros_like(ang)),
                tuple(jnp.where(inv, m, jnp.ones_like(m)) for m in masks),
                jnp.where(inv, p_1q, 0.0), jnp.where(inv, p_2q, 0.0),
                key_k, L=L, K=K, dtype=dtype, events_per_kick=events_per_kick)
            carry = jnp.where(fwd, st_f, st_i)
            return carry, None

        state, _ = jax.lax.scan(body, state0, (jnp.arange(2 * T), keys_t))
        return ancilla_factor * s0 * jnp.sum(
            (jnp.real(state) ** 2 + jnp.imag(state) ** 2)
            * zq.astype(jnp.float32))

    return jax.vmap(one_traj)(keys)


# ---------------------------------------------------------------------------
# sigma-frame (gather-free) device-noise engines for x-polarized drives:
# no per-string gathers, and the per-cycle work stays on the kick einsums.


def _device_presample_split(key, model_p1, model_p2, epk, T, L):
    """Presample all device-noise events for one trajectory, per-event.

    RNG consumption (the determinism contract shared by the sigma engines
    and the original-order oracles): k1/k2/k3 = split(key, 3); u1 (T, epk, L) for the 1q
    events, ue/uo (T, n_bonds) for the even/odd 2q events. Returns per-step
    ((T, epk) xm1/zm1, (T,) xme/zme, xmo/zmo) Pauli masks.
    """
    from dtc_tpu.core.sigma_evolve import _masks_from_codes

    k1, k2, k3 = jax.random.split(key, 3)
    u1 = jax.random.uniform(k1, (T, epk, L), dtype=jnp.float32)
    q1 = 0.25 * jnp.broadcast_to(model_p1, (L,))
    c1 = (u1 >= (1.0 - 3.0 * q1)).astype(jnp.int32) * (
        1 + jnp.floor((u1 - (1.0 - 3.0 * q1))
                      / jnp.maximum(q1, 1e-30)).astype(jnp.int32))
    c1 = jnp.clip(c1, 0, 3)
    xm1, zm1 = _masks_from_codes(c1, L)          # (T, epk)

    def bond_codes(u, p_bonds, start):
        bonds = [(i, i + 1) for i in range(start, L - 1, 2)]
        nb = len(bonds)
        p = jnp.broadcast_to(jnp.asarray(p_bonds), (nb,))
        q16 = p / 16.0
        idx = (u >= (1.0 - 15.0 * q16)).astype(jnp.int32) * (
            1 + jnp.floor((u - (1.0 - 15.0 * q16))
                          / jnp.maximum(q16, 1e-30)).astype(jnp.int32))
        idx = jnp.clip(idx, 0, 15)
        codes = jnp.zeros(u.shape[:-1] + (L,), dtype=jnp.int32)
        hi = jnp.asarray([b[0] for b in bonds], dtype=jnp.int32)
        lo = jnp.asarray([b[1] for b in bonds], dtype=jnp.int32)
        codes = codes.at[..., hi].set(idx >> 2)
        codes = codes.at[..., lo].set(idx & 3)
        return codes

    p2 = jnp.broadcast_to(model_p2, (L - 1,))
    ue = jax.random.uniform(k2, (T, (L - 1 + 1) // 2), dtype=jnp.float32)
    uo = jax.random.uniform(k3, (T, (L - 1) // 2), dtype=jnp.float32)
    ce = bond_codes(ue, p2[0::2], 0)
    co = bond_codes(uo, p2[1::2], 1)
    xme, zme = _masks_from_codes(ce, L)          # (T,)
    xmo, zmo = _masks_from_codes(co, L)
    return xm1, zm1, xme, zme, xmo, zmo


def _compose_1q(xm1, zm1, epk):
    """XOR-compose the epk per-kick 1q events (exact up to global phase)."""
    xm_kick, zm_1q = xm1[..., 0], zm1[..., 0]
    for e in range(1, epk):
        xm_kick = xm_kick ^ xm1[..., e]
        zm_1q = zm_1q ^ zm1[..., e]
    return xm_kick, zm_1q


def _device_presample(key, model_p1, model_p2, epk, T, L):
    """Presample all device-noise events for one trajectory.

    Per cycle, in order: epk per-site 1q events (after the kick), one 2q
    event after the even-bond RZZ sublayer, one after the odd sublayer.
    Returns per-cycle combined z-mask, the three sigma checkpoints
    (sig_a: before D_even, sig_b: before D_odd, sig_c: cycle end), all
    (T,) uint32.
    """
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        key, model_p1, model_p2, epk, T, L)
    xm_kick, zm_1q = _compose_1q(xm1, zm1, epk)
    zm_all = zm_1q ^ zme ^ zmo

    # prefix sigmas: sig_a after kick events, sig_b after even bond event,
    # sig_c after odd bond event (cycle end)
    def scan_sig(carry, inp):
        xk, xe, xo = inp
        sa = carry ^ xk
        sb = sa ^ xe
        sc = sb ^ xo
        return sc, (sa, sb, sc)

    _, (sig_a, sig_b, sig_c) = jax.lax.scan(
        scan_sig, jnp.uint32(0), (xm_kick, xme, xmo))
    return zm_all, sig_a, sig_b, sig_c


def _device_presample_echo(key, model_p1, model_p2, epk, t_value, T, L):
    """Echo-schedule device events: 2T potential steps, codes zeroed on
    inactive steps (k >= 2*t_value), per-step split masks + the running
    sigma frame.

    A forward step's events fire kick-first (sa = sig0 ^ xm_kick); an
    inverse step's fire odd-bond-first (s1 = sig0 ^ xm_odd) — but the
    END-of-step frame is the XOR of all three either way, so one uniform
    csum serves both branches. RNG consumption matches _device_presample
    with T -> 2T (identical uniforms regardless of t_value).
    """
    T2 = 2 * T
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        key, model_p1, model_p2, epk, T2, L)
    xm_kick, zm_1q = _compose_1q(xm1, zm1, epk)
    step = jnp.arange(T2)
    act = step < 2 * t_value
    z32 = jnp.uint32(0)
    xm_kick, zm_1q, xme, zme, xmo, zmo = (
        jnp.where(act, m, z32) for m in (xm_kick, zm_1q, xme, zme, xmo, zmo))
    csum = jax.lax.associative_scan(jnp.bitwise_xor, xm_kick ^ xme ^ xmo)
    sig_start = jnp.concatenate([jnp.zeros((1,), jnp.uint32), csum[:-1]])
    fwd = step < t_value
    inv = (step >= t_value) & (step < 2 * t_value)
    return (xm_kick, zm_1q, xme, zme, xmo, zmo, sig_start, csum, fwd, inv)


def _device_column_factors(q0, k, pend_zm, sa, sb, sc, exp_h, exp_p, L, dtype):
    """Column factors with per-coefficient-class sigmas: field h from sc,
    even bonds from sa, odd bonds from sb (exact event placement)."""
    from dtc_tpu.core.sigma_evolve import _bits

    j = jnp.arange(1 << k, dtype=jnp.uint32)
    out = jnp.ones((1 << k,), dtype=dtype)
    bits_c = _bits(sc, L)
    bits_a = _bits(sa, L)
    bits_b = _bits(sb, L)
    zm_bits = _bits(pend_zm, L)
    for q in range(q0, q0 + k):
        bit = ((j >> (q - q0)) & 1).astype(jnp.int32)
        nsign = jnp.where(zm_bits[q] * bit == 1, -1.0, 1.0)
        fq = jnp.where(bit == 0, exp_h[q], jnp.conj(exp_h[q]))
        fq = jnp.where(bits_c[q] == 1, fq, jnp.ones((), dtype))
        out = out * (nsign * fq)
    for b in range(q0, min(q0 + k - 1, L - 1)):
        sig = bits_a if b % 2 == 0 else bits_b
        flip = sig[b] ^ sig[b + 1]
        zz_pos = (((j >> (b - q0)) & 1) == ((j >> (b + 1 - q0)) & 1))
        gb = jnp.where(zz_pos, exp_p[b], jnp.conj(exp_p[b]))
        out = out * jnp.where(flip == 1, gb, jnp.ones((), dtype))
    return out


def _require_constant_x(angles, fname):
    """The sigma-frame device engines evolve EVERY cycle with
    angles[0, 0] — calling them with a per-cycle or K > 1 schedule would
    silently return wrong physics, so reject anything but a constant
    x-only K=1 schedule loudly (tracers skip the check: jitted callers
    own the guarantee)."""
    if isinstance(angles, jax.core.Tracer):
        return
    ang = np.asarray(angles)
    if (ang.ndim != 3 or ang.shape[1] != 1
            or not (np.all(ang[:, :, 1] == 0.0) and np.all(ang == ang[0]))):
        raise ValueError(
            f"{fname} supports only CONSTANT x-polarized K=1 kick "
            f"schedules (got shape {getattr(ang, 'shape', None)}); use "
            "the dense gather engine (device_autocorr_forward/_echo) for "
            "general drives")


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "q", "initial_state", "dtype_name",
                     "events_per_kick"),
)
def _device_sigma_echo_batch_jit(hs, phis, p_1q, p_2q, angles, keys, ts, *, L, T,
                            q, initial_state="vacuum", dtype_name="complex64",
                            ancilla_factor=1.0, events_per_kick=2):
    """Gather-free device-noise echo A0(t) for x-polarized drives.

    x-polarized constant drives (K=1). Masked fixed-length 2T scan; every
    step applies [pre-mask] -> kick -> [post-mask] where the masks are
    EAGER frame-corrected diagonals built from branch-selected small
    parameters: stored state s~ with physical = X^sigma s~; a diagonal
    applied physically at frame sigma becomes the mask with h_q -> h_q *
    (1 - 2 sigma_q) and phi_b -> phi_b * (1 - 2 flip_b); a Pauli Z-mask
    becomes a popcount-parity sign (global signs cancel in |amp|^2).

    keys (n_traj, 2), ts (n_ts,) -> (n_traj, n_ts).
    """
    from dtc_tpu.core.sigma_evolve import _bits
    from dtc_tpu.experiments.engine import resolve_dtype
    from dtc_tpu.models.drives import slot_unitary_inverse
    from dtc_tpu.ops.kick import apply_uniform_1q_layer

    dtype = resolve_dtype(dtype_name)
    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    zq = z_sign_mask(q, L)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    theta = angles[0, 0, 0]
    u_f = slot_unitary(theta, angles[0, 0, 1], dtype)
    u_i = slot_unitary_inverse(theta, angles[0, 0, 1], dtype)
    eye2 = jnp.eye(2, dtype=dtype)
    idx = jnp.arange(1 << L, dtype=jnp.uint32)
    epk = events_per_kick
    bond_even = (jnp.arange(L - 1) % 2 == 0)

    def frame_params(h_sig, even_sig, odd_sig):
        """(h signs, phi signs) for a split diagonal at per-class frames."""
        sh = (1 - 2 * _bits(h_sig, L)).astype(jnp.float32)
        be = _bits(even_sig, L)
        bo = _bits(odd_sig, L)
        fe = (be[:-1] ^ be[1:]).astype(jnp.float32)
        fo = (bo[:-1] ^ bo[1:]).astype(jnp.float32)
        flip = jnp.where(bond_even, fe, fo)
        return hs * sh, phis * (1.0 - 2.0 * flip)

    def zpar(zm):
        par = jax.lax.population_count(idx & zm) & jnp.uint32(1)
        return (1.0 - 2.0 * par.astype(jnp.float32))

    def one(key, t_value):
        (xmk, zm1, xme, zme, xmo, zmo, sig0, scend, fwd, inv) = (
            _device_presample_echo(key, p_1q, p_2q, epk, t_value, T, L))

        def body(st, inp):
            xmk_k, zm1_k, xme_k, zme_k, xmo_k, zmo_k, s0_k, sc_k, f_k, i_k = inp
            ff = f_k.astype(jnp.float32)
            fi = i_k.astype(jnp.float32)
            # pre mask: inverse-only daggered split diagonal (even bonds at
            # s1 = sig0 ^ xm_odd, odd + field at sig0) + the 2q Z-parities
            h_pre, p_pre = frame_params(s0_k, s0_k ^ xmo_k, s0_k)
            m_pre = zz_z_phase_mask(-fi * h_pre, -fi * p_pre, L, dtype=dtype)
            m_pre = m_pre * zpar(jnp.where(i_k, zme_k ^ zmo_k, jnp.uint32(0)))
            # kick: u (fwd) / u-dagger (inv) / identity (padding)
            uk = (ff * u_f + fi * u_i
                  + (1.0 - ff - fi) * eye2).astype(dtype)
            # post mask: forward split diagonal at (sa, sb, sc) frames with
            # all the step's Z-parities; inverse keeps only the 1q Z-parity
            sa = s0_k ^ xmk_k
            h_post, p_post = frame_params(sc_k, sa, sa ^ xme_k)
            m_post = zz_z_phase_mask(ff * h_post, ff * p_post, L, dtype=dtype)
            zm_post = jnp.where(f_k, zm1_k ^ zme_k ^ zmo_k,
                                jnp.where(i_k, zm1_k, jnp.uint32(0)))
            m_post = m_post * zpar(zm_post)
            st = apply_uniform_1q_layer(st * m_pre, uk, L) * m_post
            return st, None

        st, _ = jax.lax.scan(
            body, psi0, (xmk, zm1, xme, zme, xmo, zmo, sig0, scend, fwd, inv))
        val = jnp.sum((jnp.real(st) ** 2 + jnp.imag(st) ** 2)
                      * zq.astype(jnp.real(psi0).dtype))
        # cast the +-1 sigma sign to the accumulator dtype BEFORE the python
        # ancilla_factor multiply — a float32 sq would weak-type-demote
        # af*sq to f32 and cap the c128 oracle at ~3e-8
        sq = (1 - 2 * ((scend[-1] >> q) & jnp.uint32(1)).astype(jnp.int32)
              ).astype(val.dtype)
        return ancilla_factor * s0 * sq * val

    return jax.vmap(lambda k: jax.vmap(lambda t: one(k, t))(ts))(keys)


def device_sigma_echo_batch(hs, phis, p_1q, p_2q, angles, keys, ts, **kw):
    _require_constant_x(angles, "device_sigma_echo_batch")
    return _device_sigma_echo_batch_jit(hs, phis, p_1q, p_2q, angles, keys,
                                        ts, **kw)


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "q", "initial_state", "dtype_name",
                     "events_per_kick"),
)
def _device_sigma_forward_batch_jit(hs, phis, p_1q, p_2q, angles, keys, *, L, T, q,
                               initial_state="vacuum", dtype_name="complex64",
                               ancilla_factor=1.0, events_per_kick=2):
    """Gather-free device-noise forward A(t): (n_traj, 2) keys -> (n_traj, T).

    x-polarized drives; single-state Z-eigenstate measurement; sigma-frame
    with the noise/diag-correction factors folded into kick columns (see
    core.sigma_evolve) generalized to the device event structure.
    """
    from dtc_tpu.core.sigma_evolve import _straddle_factor, _group_starts
    from dtc_tpu.experiments.engine import resolve_dtype
    from dtc_tpu.models.drives import slot_unitary
    from dtc_tpu.ops.kick import kron_power
    from dtc_tpu.ops.precision import gate_precision

    dtype = resolve_dtype(dtype_name)
    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    zq = z_sign_mask(q, L)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    d0 = zz_z_phase_mask(hs, phis, L, dtype=dtype)
    exp_h = jnp.exp(1j * hs.astype(jnp.float32)).astype(dtype)
    exp_p = jnp.exp(1j * phis.astype(jnp.float32)).astype(dtype)
    starts = _group_starts(L)
    u = slot_unitary(angles[0, 0, 0], angles[0, 0, 1], dtype)
    theta = angles[0, 0, 0]

    def per_traj(key):
        zm_all, sig_a, sig_b, sig_c = _device_presample(
            key, p_1q, p_2q, events_per_kick, T, L)
        sig_start = jnp.concatenate([jnp.zeros((1,), jnp.uint32), sig_c[:-1]])

        def body(carry, inp):
            st, pend = carry
            zm_t, sa, sb, sc, sig0 = inp
            pzm, pa, pb, pc = pend
            a_t = s0 * (1 - 2 * ((sig0 >> q) & jnp.uint32(1)).astype(
                jnp.int32)).astype(jnp.float32) * jnp.sum(
                (jnp.real(st) ** 2 + jnp.imag(st) ** 2)
                * zq.astype(jnp.float32))
            # straddle bonds for pending corrections
            for q0, kk in starts[:-1]:
                bb = q0 + kk - 1
                if bb < L - 1:
                    sig_for_bond = pa if bb % 2 == 0 else pb
                    st = _straddle_factor(st, bb, sig_for_bond, exp_p, L, dtype)
            # kick with pending factors folded into columns
            total = st.shape[-1]
            for q0, kk in starts:
                uk = kron_power(u, kk) if kk > 1 else u
                cols = _device_column_factors(q0, kk, pzm, pa, pb, pc,
                                              exp_h, exp_p, L, dtype)
                uk = uk * cols[None, :]
                high = total >> (q0 + kk)
                low = 1 << q0
                s2 = st.reshape(high, 1 << kk, low)
                s2 = jnp.einsum("ab,hbl->hal", uk, s2,
                                precision=gate_precision())
                st = s2.reshape(total)
            st = st * d0
            return (st, (zm_t, sa, sb, sc)), a_t * ancilla_factor

        zero = jnp.uint32(0)
        (_, _), a = jax.lax.scan(
            body, (psi0, (zero, zero, zero, zero)),
            (zm_all, sig_a, sig_b, sig_c, sig_start))
        return a

    return jax.vmap(per_traj)(keys)


def device_sigma_forward_batch(hs, phis, p_1q, p_2q, angles, keys, **kw):
    _require_constant_x(angles, "device_sigma_forward_batch")
    return _device_sigma_forward_batch_jit(hs, phis, p_1q, p_2q, angles,
                                           keys, **kw)


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "q", "initial_state", "dtype_name",
                     "events_per_kick"),
)
def device_general_forward_oracle(hs, phis, p_1q, p_2q, angles, keys, *, L,
                                  T, K, q, initial_state="vacuum",
                                  dtype_name="complex64",
                                  ancilla_factor=1.0, events_per_kick=2):
    """Dense lab-frame device-noise forward for any kick schedule, applying
    presampled events (_device_presample_split with K*epk 1q events per
    cycle) in the ORIGINAL circuit order — the test reference for the
    device-noise engines.
    """
    from dtc_tpu.core.statevector import neel_index
    from dtc_tpu.experiments.engine import resolve_dtype
    from dtc_tpu.ops.paulis import apply_pauli_string

    dtype = resolve_dtype(dtype_name)
    masks = _masks_split(hs, phis, L, dtype)
    m_even, m_odd, m_field = masks
    zq = z_sign_mask(q, L)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    ny0 = jnp.zeros((), jnp.int32)  # composed global phase is irrelevant

    def per_traj(key):
        xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
            key, p_1q, p_2q, K * events_per_kick, T, L)
        xk, zk = _compose_1q(xm1.reshape(T, K, events_per_kick),
                             zm1.reshape(T, K, events_per_kick),
                             events_per_kick)

        def body(st, inp):
            ang, xk_t, zk_t, xme_t, zme_t, xmo_t, zmo_t = inp
            a_t = ancilla_factor * s0 * jnp.sum(
                (jnp.real(st) ** 2 + jnp.imag(st) ** 2)
                * zq.astype(jnp.float32))
            for k in range(K):
                u = slot_unitary(ang[k, 0], ang[k, 1], dtype)
                st = apply_uniform_1q_layer(st, u, L)
                st = apply_pauli_string(st, xk_t[k], zk_t[k], ny0)
            st = st * m_even
            st = apply_pauli_string(st, xme_t, zme_t, ny0)
            st = st * m_odd
            st = apply_pauli_string(st, xmo_t, zmo_t, ny0)
            st = st * m_field
            return st, a_t

        _, a = jax.lax.scan(body, psi0, (angles, xk, zk, xme, zme, xmo, zmo))
        return a

    return jax.vmap(per_traj)(keys)


def device_general_echo_oracle(hs, phis, p_1q, p_2q, angles, key, t_value,
                               *, L, T, K, q, initial_state="vacuum",
                               dtype_name="complex64", ancilla_factor=1.0,
                               events_per_kick=2):
    """Dense lab-frame echo oracle: the device_general_forward_oracle
    presample over 2T steps, events applied in the ORIGINAL
    device_inverse_cycle order. One trajectory, one t; eager python loop —
    test-scale only."""
    import numpy as np

    from dtc_tpu.core.statevector import neel_index
    from dtc_tpu.experiments.engine import resolve_dtype
    from dtc_tpu.models.drives import slot_unitary_inverse
    from dtc_tpu.ops.paulis import apply_pauli_string

    dtype = resolve_dtype(dtype_name)
    m_even, m_odd, m_field = _masks_split(hs, phis, L, dtype)
    zq = z_sign_mask(q, L)
    psi = initial_statevector(L, initial_state, dtype=dtype)
    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    ny0 = jnp.zeros((), jnp.int32)

    T2 = 2 * T
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        key, p_1q, p_2q, K * events_per_kick, T2, L)
    xk, zk = _compose_1q(np.asarray(xm1).reshape(T2, K, events_per_kick),
                         np.asarray(zm1).reshape(T2, K, events_per_kick),
                         events_per_kick)
    xme, zme, xmo, zmo = (np.asarray(m) for m in (xme, zme, xmo, zmo))

    for s in range(int(t_value)):
        for k in range(K):
            u = slot_unitary(angles[s, k, 0], angles[s, k, 1], dtype)
            psi = apply_uniform_1q_layer(psi, u, L)
            psi = apply_pauli_string(psi, jnp.uint32(xk[s, k]),
                                     jnp.uint32(zk[s, k]), ny0)
        psi = psi * m_even
        psi = apply_pauli_string(psi, jnp.uint32(xme[s]),
                                 jnp.uint32(zme[s]), ny0)
        psi = psi * m_odd
        psi = apply_pauli_string(psi, jnp.uint32(xmo[s]),
                                 jnp.uint32(zmo[s]), ny0)
        psi = psi * m_field
    for s in range(int(t_value), 2 * int(t_value)):
        ci = 2 * int(t_value) - 1 - s
        psi = psi * jnp.conj(m_field)
        psi = psi * jnp.conj(m_odd)
        psi = apply_pauli_string(psi, jnp.uint32(xmo[s]),
                                 jnp.uint32(zmo[s]), ny0)
        psi = psi * jnp.conj(m_even)
        psi = apply_pauli_string(psi, jnp.uint32(xme[s]),
                                 jnp.uint32(zme[s]), ny0)
        for j in range(K):
            u = slot_unitary_inverse(angles[ci, K - 1 - j, 0],
                                     angles[ci, K - 1 - j, 1], dtype)
            psi = apply_uniform_1q_layer(psi, u, L)
            psi = apply_pauli_string(psi, jnp.uint32(xk[s, j]),
                                     jnp.uint32(zk[s, j]), ny0)
    val = jnp.sum((jnp.real(psi) ** 2 + jnp.imag(psi) ** 2)
                  * zq.astype(jnp.float32))
    return ancilla_factor * s0 * float(val)
