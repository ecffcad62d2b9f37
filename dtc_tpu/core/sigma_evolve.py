"""Sigma-frame trajectory evolution — fully factored, mask-free noise.

A noisy trajectory cycle done literally costs three passes that a noiseless
cycle does not: an XOR-gather per sampled Pauli string, PRNG calls inside
the scan, and a per-cycle index-computed (2^L,)-sized diagonal rebuild.
This engine removes all three. Noise is presampled (one PRNG call per
trajectory), the Pauli X-part is deferred into a carried XOR frame sigma
(psi(s) = v(s XOR sigma)), and EVERY per-cycle diagonal is factored into
per-qubit / per-bond unit factors that fold into the kick's kron-group
matrices as column scalings — so a noisy cycle touches the state exactly
like a noiseless one: K kron-group matmuls + one multiply by the
PRECOMPUTED instance diagonal D0, plus two tiny broadcast 4-vectors for the
bonds straddling group boundaries.

The algebra:
- Pauli (x, z):    Z-sign mask is separable: (-1)^{bit_q} per q in z ->
                   +-1 column signs on the NEXT kick; sigma ^= x; global
                   phases (i^{n_y}, (-1)^{popcount(sigma&z)}) cancel exactly
                   between the interferometer branches and are dropped.
- diagonal:        D_sigma(s) = D0(s) * prod_q f_q^{(bit)} * prod_b g_b^{(zz)}
                   with f_q = [e^{+i h_q}, e^{-i h_q}] where sigma flips q
                   (else 1), g_b likewise with phi_b where sigma flips the
                   bond sign. Per-qubit and in-group bond factors fold into
                   the next kick's columns; the <=2 straddling bonds apply
                   as (4,) broadcasts on a reshaped axis. All unit-modulus,
                   so anything still pending at measurement cancels.
- kick:            sigma-conjugation U -> XUX = RY(-ty)RX(tx) per flipped
                   site (pure-X drives invariant).
- measurement:     Re<v1|Z_q|v2> x (1 - 2 sigma_q).

The sampled-code distribution matches qiskit-aer's depolarizing_error
exactly, so physics and oracle parity are unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dtc_tpu.core.statevector import initial_statevector
from dtc_tpu.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu.ops.kick import kron_power
from dtc_tpu.ops.precision import gate_precision

_GROUP = 7


# ---------------------------------------------------------------------------
# presampling


def _codes_from_uniform(u, p):
    """uniform(0,1) -> Pauli codes with P(I)=1-3p/4, P(X/Y/Z)=p/4 each
    (qiskit depolarizing_error(p,1) mixed-unitary decomposition)."""
    q = 0.25 * p
    c = (u >= (1.0 - 3.0 * q)).astype(jnp.int32) * (
        1 + jnp.floor((u - (1.0 - 3.0 * q)) / jnp.maximum(q, 1e-30)).astype(jnp.int32)
    )
    return jnp.clip(c, 0, 3)


def _masks_from_codes(codes, L):
    weights = (jnp.uint32(1) << jnp.arange(L, dtype=jnp.uint32))
    is_x = (codes == 1) | (codes == 2)
    is_z = codes >= 2
    xm = jnp.sum(jnp.where(is_x, weights, jnp.uint32(0)), axis=-1, dtype=jnp.uint32)
    zm = jnp.sum(jnp.where(is_z, weights, jnp.uint32(0)), axis=-1, dtype=jnp.uint32)
    return xm, zm


def presample_noise(key, p, n_events, L):
    """One PRNG call -> per-event (xmask, zmask, sigma_before, sigma_csum)."""
    with jax.named_scope("noise"):
        u = jax.random.uniform(key, (n_events, L), dtype=jnp.float32)
        codes = _codes_from_uniform(u, p)
        xm, zm = _masks_from_codes(codes, L)
        csum = jax.lax.associative_scan(jnp.bitwise_xor, xm)
        sigma_before = jnp.concatenate(
            [jnp.zeros((1,), jnp.uint32), csum[:-1]])
    return xm, zm, sigma_before, csum


# ---------------------------------------------------------------------------
# small per-cycle builders (sizes <= (2^group,), never 2^L)


def _bits(mask, n):
    return ((mask >> jnp.arange(n, dtype=jnp.uint32)) & 1).astype(jnp.int32)


def _sigma_signs(sigma, L, dtype=jnp.float32):
    return (1 - 2 * _bits(sigma, L)).astype(dtype)


def _group_column_factors(q0, k, pend_zm, diag_sig, exp_h, exp_p, L, dtype):
    """(2^k,) complex column factors for qubits [q0, q0+k):

    noise +-1 signs from pend_zm, per-qubit diag-correction factors from
    diag_sig (f_q = exp_h[q]^{+-1} where flipped), and in-group bond factors
    (g_b = exp_p[b]^{+-1} where the bond sign flipped).
    """
    j = jnp.arange(1 << k, dtype=jnp.uint32)
    out = jnp.ones((1 << k,), dtype=dtype)
    sig_bits = _bits(diag_sig, L)
    zm_bits = _bits(pend_zm, L)
    for q in range(q0, q0 + k):
        bit = ((j >> (q - q0)) & 1).astype(jnp.int32)
        # noise sign: (-1)^{bit} if z bit set
        nsign = jnp.where(zm_bits[q] * bit == 1, -1.0, 1.0)
        # diag-correction factor: exp_h[q]^{z_q}, z=+1 for bit 0
        fq = jnp.where(bit == 0, exp_h[q], jnp.conj(exp_h[q]))
        fq = jnp.where(sig_bits[q] == 1, fq, jnp.ones((), dtype))
        out = out * (nsign * fq)
    for b in range(q0, min(q0 + k - 1, L - 1)):
        flip = sig_bits[b] ^ sig_bits[b + 1]
        zz_pos = (((j >> (b - q0)) & 1) == ((j >> (b + 1 - q0)) & 1))
        gb = jnp.where(zz_pos, exp_p[b], jnp.conj(exp_p[b]))
        out = out * jnp.where(flip == 1, gb, jnp.ones((), dtype))
    return out


def _straddle_factor(state, b, diag_sig, exp_p, L, dtype):
    """Bond b straddling a group boundary: multiply by the (4,) diagonal
    [g, g*, g*, g] on qubits (b, b+1) via an axis reshape — no 2^L mask."""
    sig_bits = _bits(diag_sig, L)
    flip = (sig_bits[b] ^ sig_bits[b + 1]) == 1
    g = jnp.where(flip, exp_p[b], jnp.ones((), dtype))
    vec4 = jnp.stack([g, jnp.conj(g), jnp.conj(g), g])  # index = bit_{b+1}<<1 | bit_b
    shape = state.shape
    total = shape[-1]
    high = total >> (b + 2)
    low = 1 << b
    s = state.reshape(*shape[:-1], high, 4, low)
    s = s * vec4[:, None]
    return s.reshape(shape)


def _group_starts(L, group=_GROUP):
    starts = []
    q = 0
    while q < L:
        starts.append((q, min(group, L - q)))
        q += group
    return starts


def _kick_factored(state, theta_x, theta_y, sigma, pend_zm, diag_sig, exp_h,
                   exp_p, *, L, dtype, has_y, inverse=False, group=_GROUP):
    """sigma-conjugated kick with pending noise signs + diag-correction
    factors folded into the kron-group columns; straddle bonds applied as
    (4,) broadcasts first."""
    starts = _group_starts(L, group)
    with jax.named_scope("diag"):
        for q0, k in starts[:-1]:
            b = q0 + k - 1
            if b < L - 1:
                state = _straddle_factor(state, b, diag_sig, exp_p, L, dtype)
    make = slot_unitary_inverse if inverse else slot_unitary
    if has_y:
        s = _sigma_signs(sigma, L, jnp.asarray(theta_y).dtype)
        us = jax.vmap(lambda sq: make(theta_x, sq * theta_y, dtype))(s)
    else:
        u = make(theta_x, theta_y, dtype)
    total = state.shape[-1]
    shape = state.shape
    for q0, k in starts:
        with jax.named_scope("kick"):
            if has_y:
                uk = us[q0 + k - 1]
                for jq in range(k - 2, -1, -1):
                    uk = jnp.kron(uk, us[q0 + jq])
            else:
                uk = kron_power(u, k) if k > 1 else u
            cols = _group_column_factors(q0, k, pend_zm, diag_sig, exp_h,
                                         exp_p, L, dtype)
            uk = uk * cols[None, :]
            high = total >> (q0 + k)
            low = 1 << q0
            s2 = state.reshape(*shape[:-1], high, 1 << k, low)
            s2 = jnp.einsum("ab,...hbl->...hal", uk, s2,
                            precision=gate_precision())
            state = s2.reshape(shape)
    return state


# ---------------------------------------------------------------------------
# cycles (pending = (zm uint32, diag_sig uint32): what the next kick absorbs)


def forward_cycle_fac(state, pending, ang, d0, exp_h, exp_p, ev, *, L, K, p,
                      dtype, has_y):
    """Forward cycle. ev = (zm (K,), sig_b (K,), sig_after scalar).
    d0 = precomputed instance diagonal (applied every cycle); the
    sigma-correction rides the columns."""
    pend_zm, pend_sig = pending
    if p <= 0.0:
        for k in range(K):
            state = _kick_factored(state, ang[k, 0], ang[k, 1], jnp.uint32(0),
                                   jnp.uint32(0), jnp.uint32(0), exp_h, exp_p,
                                   L=L, dtype=dtype, has_y=False)
        with jax.named_scope("diag"):
            return state * d0, pending
    zm, sig_b, sig_after = ev
    for k in range(K):
        state = _kick_factored(state, ang[k, 0], ang[k, 1], sig_b[k],
                               pend_zm, pend_sig, exp_h, exp_p,
                               L=L, dtype=dtype, has_y=has_y)
        pend_zm, pend_sig = zm[k], jnp.uint32(0)
    with jax.named_scope("diag"):
        state = state * d0
    return state, (pend_zm, sig_after)


def inverse_cycle_fac(state, pending, ang, d0c, exp_hc, exp_pc, ev, *, L, K,
                      p, dtype, has_y):
    """Inverse cycle: conj-diag first (D0* applied now; its sigma-correction
    — at sigma = sig_b[0] — folds into the first inverse kick), then inverse
    slots each followed by a noise event."""
    pend_zm, pend_sig = pending
    if p <= 0.0:
        with jax.named_scope("diag"):
            state = state * d0c
        for k in range(K - 1, -1, -1):
            state = _kick_factored(state, ang[k, 0], ang[k, 1], jnp.uint32(0),
                                   jnp.uint32(0), jnp.uint32(0), exp_hc, exp_pc,
                                   L=L, dtype=dtype, has_y=False, inverse=True)
        return state, pending
    zm, sig_b, sig_after = ev
    with jax.named_scope("diag"):
        state = state * d0c
    # D0c's correction (at sig_b[0], the sigma when it was applied) rides the
    # FIRST inverse kick only, XOR-composed with any pending correction: at
    # the echo turnaround pend_sig (the last forward D0's deferred sigma)
    # equals sig_b[0] and the conjugate-pair corrections cancel exactly
    # (dsig = 0); mid-echo pend_sig is 0 and dsig = sig_b[0]. Later slots of
    # the same cycle carry NO diag correction — there is no diagonal between
    # inverse kick slots, only the event z-sign (a spurious per-slot
    # correction here was the K>=2 echo bug caught by the lab-frame oracle
    # comparison, tests/test_resident_general.py).
    for j in range(K):
        slot = K - 1 - j
        dsig = (sig_b[0] ^ pend_sig) if j == 0 else jnp.uint32(0)
        state = _kick_factored(state, ang[slot, 0], ang[slot, 1], sig_b[j],
                               pend_zm, dsig, exp_hc, exp_pc,
                               L=L, dtype=dtype, has_y=has_y, inverse=True)
        pend_zm, pend_sig = zm[j], jnp.uint32(0)
    return state, (pend_zm, pend_sig)


def _measure_single_autocorr(state, sigma, zq_signs, q, s0, ancilla_factor,
                             dtype):
    """A(t) for Z-eigenstate initial states (vacuum/neel — the only initial
    states the reference supports): Z_q|psi0> = s0|psi0>, so the
    interferometric A(t) = s0 * <Z_q(t)> on a SINGLE state — half the memory
    and FLOPs of the two-branch form. Pending unit-modulus masks cancel in
    |v|^2; sigma contributes z_q(s^sigma) = (1-2 sigma_q) z_q(s)."""
    sq = (1 - 2 * ((sigma >> q) & jnp.uint32(1)).astype(jnp.int32)).astype(
        jnp.float32)
    with jax.named_scope("measure"):
        val = jnp.sum((jnp.real(state) ** 2 + jnp.imag(state) ** 2)
                      * zq_signs.astype(jnp.float32))
    return ancilla_factor * s0 * sq * val


# ---------------------------------------------------------------------------
# batched drivers


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "p", "q", "initial_state", "dtype_name",
                     "ancilla_factor", "has_y"),
)
def sigma_forward_batch(hs, phis, angles, keys, *, L, T, K, p, q,
                        initial_state, dtype_name, ancilla_factor,
                        has_y=False):
    """(inst, L), (inst, L-1), (T,K,2), (inst, c, 2) -> (inst, c, T)."""
    from dtc_tpu.experiments.engine import resolve_dtype

    dtype = resolve_dtype(dtype_name)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    zq = z_sign_mask(q, L)
    from dtc_tpu.core.statevector import neel_index
    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    state0 = psi0

    def per_instance(h, ph, ks):
        d0 = zz_z_phase_mask(h, ph, L, dtype=dtype)
        exp_h = jnp.exp(1j * h.astype(jnp.float32)).astype(dtype)
        exp_p = jnp.exp(1j * ph.astype(jnp.float32)).astype(dtype)

        def per_traj(key):
            if p > 0.0:
                xm, zm, sig_b, csum = presample_noise(key, p, T * K, L)
                zm = zm.reshape(T, K)
                sig_b = sig_b.reshape(T, K)
                sig_after = csum.reshape(T, K)[:, -1]
                sig_at_start = jnp.concatenate(
                    [jnp.zeros((1,), jnp.uint32), sig_after[:-1]])
            else:
                zm = sig_b = jnp.zeros((T, K), jnp.uint32)
                sig_after = sig_at_start = jnp.zeros((T,), jnp.uint32)

            def body(carry, inp):
                st, pend = carry
                ang, ev, sig0 = inp
                a_t = _measure_single_autocorr(st, sig0, zq, q, s0,
                                               ancilla_factor, dtype)
                st, pend = forward_cycle_fac(st, pend, ang, d0, exp_h, exp_p,
                                             ev, L=L, K=K, p=p, dtype=dtype,
                                             has_y=has_y)
                return (st, pend), a_t

            _, a = jax.lax.scan(
                body, (state0, (jnp.uint32(0), jnp.uint32(0))),
                (angles, (zm, sig_b, sig_after), sig_at_start))
            return a

        return jax.vmap(per_traj)(ks)

    return jax.vmap(per_instance)(hs, phis, keys)


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "p", "q", "initial_state", "dtype_name",
                     "ancilla_factor", "has_y"),
)
def sigma_echo_batch(hs, phis, angles, keys, ts, *, L, T, K, p, q,
                     initial_state, dtype_name, ancilla_factor, has_y=False):
    """-> (inst, c, n_ts) echo values (masked fixed-length scan, presampled
    noise for all 2T potential events; inactive-step codes zeroed)."""
    from dtc_tpu.experiments.engine import resolve_dtype

    dtype = resolve_dtype(dtype_name)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    zq = z_sign_mask(q, L)
    from dtc_tpu.core.statevector import neel_index
    b0 = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    state0 = psi0
    eye_ang = jnp.zeros((K, 2), dtype=angles.dtype)

    def per_instance(h, ph, ks):
        d0 = zz_z_phase_mask(h, ph, L, dtype=dtype)
        d0c = jnp.conj(d0)
        exp_h = jnp.exp(1j * h.astype(jnp.float32)).astype(dtype)
        exp_p = jnp.exp(1j * ph.astype(jnp.float32)).astype(dtype)
        exp_hc = jnp.conj(exp_h)
        exp_pc = jnp.conj(exp_p)

        def one(key, t_value):
            if p > 0.0:
                with jax.named_scope("noise"):
                    u = jax.random.uniform(key, (2 * T, K, L),
                                           dtype=jnp.float32)
                    codes = _codes_from_uniform(u, p)
                    step = jnp.arange(2 * T)
                    active = (step < 2 * t_value)[:, None, None]
                    codes = jnp.where(active, codes, 0)
                    xm, zm = _masks_from_codes(codes, L)
                    flat = xm.reshape(-1)
                    csum = jax.lax.associative_scan(jnp.bitwise_xor, flat)
                    sig_b = jnp.concatenate(
                        [jnp.zeros((1,), jnp.uint32), csum[:-1]]
                    ).reshape(2 * T, K)
                    sig_after = csum.reshape(2 * T, K)[:, -1]
            else:
                zm = sig_b = jnp.zeros((2 * T, K), jnp.uint32)
                sig_after = jnp.zeros((2 * T,), jnp.uint32)

            def body(carry, inp):
                st, pend = carry
                kstep, ev = inp
                fwd = kstep < t_value
                inv = (kstep >= t_value) & (kstep < 2 * t_value)
                i = jnp.where(fwd, kstep,
                              jnp.clip(2 * t_value - 1 - kstep, 0, T - 1))
                ang = angles[i]
                st_f, pend_f = forward_cycle_fac(
                    st, pend, jnp.where(fwd, ang, eye_ang),
                    jnp.where(fwd, d0, jnp.ones((), dtype)), exp_h, exp_p,
                    ev, L=L, K=K, p=p, dtype=dtype, has_y=has_y)
                st_i, pend_i = inverse_cycle_fac(
                    st, pend, jnp.where(inv, ang, eye_ang),
                    jnp.where(inv, d0c, jnp.ones((), dtype)), exp_hc, exp_pc,
                    ev, L=L, K=K, p=p, dtype=dtype, has_y=has_y)
                st2 = jnp.where(fwd, st_f, jnp.where(inv, st_i, st))
                pend2 = tuple(
                    jnp.where(fwd, a, jnp.where(inv, b, c))
                    for a, b, c in zip(pend_f, pend_i, pend))
                return (st2, pend2), None

            xs = (jnp.arange(2 * T), (zm, sig_b, sig_after))
            (st, _), _ = jax.lax.scan(
                body, (state0, (jnp.uint32(0), jnp.uint32(0))), xs)
            return _measure_single_autocorr(st, sig_after[-1], zq, q, s0,
                                            ancilla_factor, dtype)

        return jax.vmap(lambda k: jax.vmap(lambda t: one(k, t))(ts))(ks)

    return jax.vmap(per_instance)(hs, phis, keys)
