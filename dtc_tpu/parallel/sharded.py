"""Amplitude-sharded Floquet simulation via shard_map over the ('traj','amp')
mesh.

Sharding layout: the 2**L statevector is split along the TOP k = log2(n_amp)
index bits, so device a of the 'amp' axis holds global indices
[a*M, (a+1)*M), M = 2**(L-k). Consequences (SURVEY.md §2e "hard parts"):

- the fused RZZ+RZ diagonal and every Z-type mask are shard-local (computed
  from offset + local iota — zero comms);
- a 1q gate on a LOCAL qubit (index < L-k) is shard-local;
- a 1q gate on a GLOBAL qubit g is one nearest-pair `lax.ppermute` (shard a
  exchanges with a XOR 2^(g-(L-k))) + a 2-term local combine — the statevector
  analogue of halo exchange;
- a sampled Pauli string costs NOTHING at all in the autocorr/echo paths:
  noise is presampled outside the scan (one PRNG call per trajectory) and
  the X-part is deferred into a carried XOR frame sigma exactly as in
  core.sigma_evolve — the frame covers the SHARD-ID bits too, so a sampled
  X on a global qubit requires no ppermute, no gather, nothing; Z-signs and
  the diagonal's sigma-correction fold into the next kick's kron-group
  columns (local bits), into the global kicks' 2x2 column scalings (shard
  bits), and into tiny per-shard bond factors. The scan body is
  loop-invariant apart from small folded factors, like the single-device
  sigma engine;
- the observables path (which measures off-diagonal <X_q> every cycle and
  therefore cannot ride a deferred frame) still applies strings eagerly:
  one unconditional pair exchange per global x-bit + a local XOR gather,
  with its noise presampled outside the scan;
- expectations are local partial reductions + `psum` over 'amp';
- trajectories shard over 'traj' with no intra-step comms (the final mean is
  one scalar psum).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dtc_tpu.core.statevector import neel_index
from dtc_tpu.models.drives import slot_unitary
from dtc_tpu.ops.diag import z_sign_mask, zz_z_diag_energy, zz_z_phase_mask
from dtc_tpu.ops.kick import apply_uniform_1q_layer
from dtc_tpu.ops.paulis import (
    _i_power,
    _parity,
    pauli_string_masks,
    sample_depolarizing_codes,
)


def _xor_perm(n_shards: int, bit: int):
    return [(i, i ^ (1 << bit)) for i in range(n_shards)]


def _global_1q(state, u, gbit, n_shards):
    """2x2 unitary on global qubit (shard-id bit ``gbit``): pair ppermute +
    local 2-term combine."""
    partner = jax.lax.ppermute(state, "amp", _xor_perm(n_shards, gbit))
    mybit = (jax.lax.axis_index("amp") >> gbit) & 1
    diag_c = jnp.where(mybit == 0, u[0, 0], u[1, 1])
    off_c = jnp.where(mybit == 0, u[0, 1], u[1, 0])
    return diag_c * state + off_c * partner


def _sharded_pauli_string(state, xmask, zmask, n_y, *, offset, local_size,
                          local_bits, n_shards):
    """Apply a Pauli string whose x-mask may touch global (shard-id) bits."""
    xhigh = (xmask >> local_bits).astype(jnp.uint32)
    for gb in range(int(np.log2(n_shards)) if n_shards > 1 else 0):
        partner = jax.lax.ppermute(state, "amp", _xor_perm(n_shards, gb))
        take_partner = ((xhigh >> gb) & 1).astype(bool)
        state = jnp.where(take_partner, partner, state)
    l = jnp.arange(local_size, dtype=jnp.uint32)
    xlow = xmask & jnp.uint32(local_size - 1)
    state = jnp.take(state, (l ^ xlow).astype(jnp.int32), axis=-1)
    src_global = (jnp.uint32(offset) + l) ^ jnp.uint32(xmask)
    sign = 1 - 2 * _parity(src_global & jnp.uint32(zmask))
    phase = _i_power(n_y, state.dtype)
    return state * (phase * sign.astype(state.real.dtype))


def _sharded_kick_factored(state, theta_x, theta_y, sigma, pend_zm, diag_sig,
                           exp_h, exp_p, *, L, local_bits, n_amp, dtype,
                           has_y, inv_t=None):
    """Sigma-conjugated kick on a sharded local state with all pending noise
    Z-signs and diagonal sigma-corrections folded in.

    Local bits ride the kron-group machinery of core.sigma_evolve (column
    factors on the group matmuls, (4,) broadcasts for in-local straddle
    bonds); shard-id bits get their per-qubit factors folded into the
    ppermute 2x2's columns, the local/global boundary bond a (2,) broadcast
    on the local top-bit axis selected by shard bit 0, and global-global
    bonds a per-shard scalar. No full-plane per-cycle masks anywhere.

    ``inv_t`` (a traced boolean) selects the slot-unitary dagger at run
    time — the echo scan uses it to run ONE kick application per step whose
    direction is data-dependent, instead of computing both directions and
    discarding one (2x the einsums and ppermutes). The dagger select costs
    a 2x2 ``where``; the caller selects the matching conjugated exponent
    vectors.
    """
    from dtc_tpu.core.sigma_evolve import (
        _bits,
        _group_column_factors,
        _group_starts,
        _sigma_signs,
        _straddle_factor,
    )
    from dtc_tpu.ops.kick import kron_power
    from dtc_tpu.ops.precision import gate_precision

    k_bits = L - local_bits
    M = 1 << local_bits

    def make(tx, ty, dtype=dtype):
        u = slot_unitary(tx, ty, dtype)
        if inv_t is not None:
            return jnp.where(inv_t, jnp.conj(u).T, u)
        return u
    sig_bits = _bits(diag_sig, L)
    zm_bits = _bits(pend_zm, L)
    aidx = jax.lax.axis_index("amp")
    one = jnp.ones((), dtype)

    # ---- pre-kick diagonal factors on bonds outside the local kron groups
    starts = _group_starts(local_bits)
    for q0, k in starts[:-1]:
        b = q0 + k - 1
        if b < local_bits - 1:
            state = _straddle_factor(state, b, diag_sig, exp_p, L, dtype)
    if k_bits > 0 and local_bits >= 1:
        # boundary bond (local top bit, shard bit 0)
        b = local_bits - 1
        flip = (sig_bits[b] ^ sig_bits[b + 1]) == 1
        g = jnp.where(flip, exp_p[b], one)
        sb = (aidx & 1) == 0
        vec2 = jnp.where(sb, jnp.stack([g, jnp.conj(g)]),
                         jnp.stack([jnp.conj(g), g]))
        s = state.reshape(*state.shape[:-1], 2, M >> 1)
        state = (s * vec2[:, None]).reshape(state.shape)
    for b in range(local_bits, L - 1):
        # bond between two shard bits: a per-shard scalar
        gb, gb1 = b - local_bits, b + 1 - local_bits
        flip = (sig_bits[b] ^ sig_bits[b + 1]) == 1
        equal = ((aidx >> gb) & 1) == ((aidx >> gb1) & 1)
        g = jnp.where(flip,
                      jnp.where(equal, exp_p[b], jnp.conj(exp_p[b])), one)
        state = state * g

    # ---- local kron-group kicks with folded column factors
    if has_y:
        s_all = _sigma_signs(sigma, L, jnp.asarray(theta_y).dtype)
    for q0, k in starts:
        if has_y:
            us = jax.vmap(lambda sq: make(theta_x, sq * theta_y, dtype))(
                s_all[q0 : q0 + k])
            uk = us[k - 1]
            for jq in range(k - 2, -1, -1):
                uk = jnp.kron(uk, us[jq])
        else:
            u1 = make(theta_x, theta_y, dtype)
            uk = kron_power(u1, k) if k > 1 else u1
        cols = _group_column_factors(q0, k, pend_zm, diag_sig, exp_h, exp_p,
                                     L, dtype)
        uk = uk * cols[None, :]
        high = M >> (q0 + k)
        s2 = state.reshape(*state.shape[:-1], high, 1 << k, 1 << q0)
        s2 = jnp.einsum("ab,...hbl->...hal", uk, s2,
                        precision=gate_precision())
        state = s2.reshape(state.shape)

    # ---- global (shard-bit) kicks: per-qubit factors ride the 2x2 columns
    for gb in range(k_bits):
        qq = local_bits + gb
        if has_y:
            u1 = make(theta_x, s_all[qq] * theta_y, dtype)
        else:
            u1 = make(theta_x, theta_y, dtype)
        f0 = jnp.where(sig_bits[qq] == 1, exp_h[qq], one)
        f1 = jnp.where(sig_bits[qq] == 1, jnp.conj(exp_h[qq]), one)
        f1 = f1 * jnp.where(zm_bits[qq] == 1, -one, one)
        u1 = u1 * jnp.stack([f0, f1])[None, :]
        state = _global_1q(state, u1, gb, n_amp)
    return state


def _sharded_forward_cycle(state, pending, ang, ev, d0, exp_h, exp_p, *, L,
                           local_bits, n_amp, K, p, dtype, has_y):
    """Sharded counterpart of core.sigma_evolve.forward_cycle_fac."""
    kw = dict(L=L, local_bits=local_bits, n_amp=n_amp, dtype=dtype)
    pend_zm, pend_sig = pending
    if p <= 0.0:
        for k in range(K):
            state = _sharded_kick_factored(
                state, ang[k, 0], ang[k, 1], jnp.uint32(0), jnp.uint32(0),
                jnp.uint32(0), exp_h, exp_p, has_y=False, **kw)
        return state * d0, pending
    zm, sig_b, sig_after = ev
    for k in range(K):
        state = _sharded_kick_factored(
            state, ang[k, 0], ang[k, 1], sig_b[k], pend_zm, pend_sig,
            exp_h, exp_p, has_y=has_y, **kw)
        pend_zm, pend_sig = zm[k], jnp.uint32(0)
    return state * d0, (pend_zm, sig_after)


def make_sharded_autocorr_forward(
    mesh, *, L, T, K, p, q, initial_state="vacuum", dtype=jnp.complex64,
    ancilla_factor=None, has_y=False,
):
    """Build a jitted sharded forward-autocorrelator (sigma-frame factored).

    Returns fn(angles (T,K,2), hs (L,), phis (L-1,), keys (n_traj, 2))
    -> A (T,) trajectory-averaged, replicated on all devices.
    `n_traj` must be a multiple of mesh.shape['traj']. Noise is presampled
    per trajectory outside the scan and its X-part deferred into the XOR
    frame (shard-id bits included), so the scan body carries no PRNG, no
    gathers, and no per-string collectives.
    """
    from dtc_tpu.core.sigma_evolve import presample_noise

    n_amp = mesh.shape["amp"]
    n_traj_dev = mesh.shape["traj"]
    k_bits = int(np.log2(n_amp))
    local_bits = L - k_bits
    if local_bits < 1:
        raise ValueError(f"L={L} too small for {n_amp} amp-shards")
    M = 1 << local_bits
    af = ((1.0 - p) ** 6 if p > 0 else 1.0) if ancilla_factor is None else ancilla_factor
    init_idx = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((init_idx >> q) & 1) == 0 else -1.0
    ckw = dict(L=L, local_bits=local_bits, n_amp=n_amp, K=K, p=p, dtype=dtype,
               has_y=has_y)

    def local_fn(angles, hs, phis, keys):
        offset = (jax.lax.axis_index("amp") * M).astype(jnp.uint32)
        d0 = zz_z_phase_mask(hs, phis, L, offset=offset, size=M, dtype=dtype)
        zq = z_sign_mask(q, L, offset=offset, size=M).astype(jnp.float32)
        gidx = jnp.arange(M, dtype=jnp.uint32) + offset
        state0 = (gidx == jnp.uint32(init_idx)).astype(dtype)
        exp_h = jnp.exp(1j * hs.astype(jnp.float32)).astype(dtype)
        exp_p = jnp.exp(1j * phis.astype(jnp.float32)).astype(dtype)

        def one_traj(key):
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
                sq = (1 - 2 * ((sig0 >> q) & jnp.uint32(1)).astype(
                    jnp.int32)).astype(jnp.float32)
                part = jnp.sum(
                    (jnp.real(st) ** 2 + jnp.imag(st) ** 2) * zq)
                a_t = af * s0 * sq * jax.lax.psum(part, "amp")
                st, pend = _sharded_forward_cycle(
                    st, pend, ang, ev, d0, exp_h, exp_p, **ckw)
                return (st, pend), a_t

            _, a = jax.lax.scan(
                body, (state0, (jnp.uint32(0), jnp.uint32(0))),
                (angles, (zm, sig_b, sig_after), sig_at_start))
            return a

        a_local = jax.vmap(one_traj)(keys)  # (local_traj, T)
        total = jax.lax.psum(jnp.sum(a_local, axis=0), "traj")
        n_total = keys.shape[0] * n_traj_dev
        return total / n_total

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("traj", None)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_echo(
    mesh, *, L, T, K, p, q, initial_state="vacuum", dtype=jnp.complex64,
    ancilla_factor=None, has_y=False,
):
    """Sharded echo A0(t): fixed-length masked scan (forward t, inverse t),
    sigma-frame factored like the forward path (presampled noise with
    inactive-step codes zeroed; no in-scan PRNG/gathers/string collectives).

    Returns fn(angles, hs, phis, keys (n_traj,2), t_value) -> scalar echo.
    """
    from dtc_tpu.core.sigma_evolve import _codes_from_uniform, _masks_from_codes

    n_amp = mesh.shape["amp"]
    n_traj_dev = mesh.shape["traj"]
    k_bits = int(np.log2(n_amp))
    local_bits = L - k_bits
    M = 1 << local_bits
    af = ((1.0 - p) ** 6 if p > 0 else 1.0) if ancilla_factor is None else ancilla_factor
    init_idx = 0 if initial_state == "vacuum" else neel_index(L)
    s0 = 1.0 if ((init_idx >> q) & 1) == 0 else -1.0

    def local_fn(angles, hs, phis, keys, t_value):
        offset = (jax.lax.axis_index("amp") * M).astype(jnp.uint32)
        d0 = zz_z_phase_mask(hs, phis, L, offset=offset, size=M, dtype=dtype)
        d0c = jnp.conj(d0)
        zq = z_sign_mask(q, L, offset=offset, size=M).astype(jnp.float32)
        gidx = jnp.arange(M, dtype=jnp.uint32) + offset
        state0 = (gidx == jnp.uint32(init_idx)).astype(dtype)
        exp_h = jnp.exp(1j * hs.astype(jnp.float32)).astype(dtype)
        exp_p = jnp.exp(1j * phis.astype(jnp.float32)).astype(dtype)
        exp_hc, exp_pc = jnp.conj(exp_h), jnp.conj(exp_p)
        eye_ang = jnp.zeros((K, 2), dtype=angles.dtype)
        one = jnp.ones((), dtype)

        def one_traj(key):
            if p > 0.0:
                u = jax.random.uniform(key, (2 * T, K, L), dtype=jnp.float32)
                codes = _codes_from_uniform(u, p)
                step = jnp.arange(2 * T)
                active = (step < 2 * t_value)[:, None, None]
                codes = jnp.where(active, codes, 0)
                xm, zm = _masks_from_codes(codes, L)
                flat = xm.reshape(-1)
                csum = jax.lax.associative_scan(jnp.bitwise_xor, flat)
                sig_b = jnp.concatenate(
                    [jnp.zeros((1,), jnp.uint32), csum[:-1]]).reshape(2 * T, K)
                sig_after = csum.reshape(2 * T, K)[:, -1]
            else:
                zm = sig_b = jnp.zeros((2 * T, K), jnp.uint32)
                sig_after = jnp.zeros((2 * T,), jnp.uint32)

            def body(carry, inp):
                # ONE direction-selected cycle per step (select-before-apply:
                # the kick einsums and global-bit ppermutes run once; only
                # the 2x2 unitaries, (L,) exponent vectors, diagonal vectors
                # and noise words are where()-selected). Matches
                # _sharded_forward_cycle and the unsharded
                # core.sigma_evolve.inverse_cycle_fac exactly —
                # same kick slot order (fwd ascending / inv descending), the
                # inverse's d0c BEFORE its kicks vs the forward's d0 after,
                # and the turnaround rule (sig_b[0] ^ pend_sig on the first
                # inverse kick). Padding steps (kstep >= 2*t_value) zero
                # every noise fold and ride identity kicks, leaving state
                # and carry untouched.
                st, pend = carry
                kstep, ev = inp
                zm, sig_b, sig_after = ev
                fwd = kstep < t_value
                inv = (kstep >= t_value) & (kstep < 2 * t_value)
                active = fwd | inv
                i = jnp.where(fwd, kstep,
                              jnp.clip(2 * t_value - 1 - kstep, 0, T - 1))
                ang = jnp.where(active, angles[i], eye_ang)
                pend_zm, pend_sig = pend
                exp_h_s = jnp.where(inv, exp_hc, exp_h)
                exp_p_s = jnp.where(inv, exp_pc, exp_p)
                zero = jnp.uint32(0)
                st = st * jnp.where(inv, d0c, one)
                for j in range(K):
                    ang_j = jnp.where(fwd, ang[j], ang[K - 1 - j])
                    pz = pend_zm if j == 0 else zm[j - 1]
                    pz = jnp.where(active, pz, zero)
                    if j == 0:
                        dsig = jnp.where(
                            inv, sig_b[0] ^ pend_sig,
                            jnp.where(fwd, pend_sig, zero))
                    else:
                        dsig = zero
                    st = _sharded_kick_factored(
                        st, ang_j[0], ang_j[1], sig_b[j], pz, dsig,
                        exp_h_s, exp_p_s, has_y=has_y, inv_t=inv,
                        L=L, local_bits=local_bits, n_amp=n_amp, dtype=dtype)
                st = st * jnp.where(fwd, d0, one)
                pend2 = (jnp.where(active, zm[K - 1], pend_zm),
                         jnp.where(fwd, sig_after,
                                   jnp.where(inv, zero, pend_sig)))
                return (st, pend2), None

            xs = (jnp.arange(2 * T), (zm, sig_b, sig_after))
            (st, _), _ = jax.lax.scan(
                body, (state0, (jnp.uint32(0), jnp.uint32(0))), xs)
            sigma_fin = sig_after[-1]
            sq = (1 - 2 * ((sigma_fin >> q) & jnp.uint32(1)).astype(
                jnp.int32)).astype(jnp.float32)
            part = jnp.sum((jnp.real(st) ** 2 + jnp.imag(st) ** 2) * zq)
            return af * s0 * sq * jax.lax.psum(part, "amp")

        e_local = jax.vmap(one_traj)(keys)
        total = jax.lax.psum(jnp.sum(e_local), "traj")
        return total / (keys.shape[0] * n_traj_dev)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("traj", None), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_observables(
    mesh, *, L, T, K, p, initial_state="vacuum", dtype=jnp.complex64,
    with_x=True, estimator_noise_factor=1.0,
):
    """Sharded single-state evolution emitting energy and per-qubit <Z_i>.

    The amplitude-sharded counterpart of core.evolve.evolve_observables
    (energy-sweep capability beyond one card; reference energy path at
    autocorr-delta-a-single-qiskit-fast-energy.py:136-183 is single-GPU).

    Returns fn(angles, hs, phis, term_hs, term_phis, x_coeff, keys (n_traj,2))
    -> (energy (T,), zs (T, L)) trajectory-averaged, replicated.

    Diagonal (Z/ZZ) energy terms are shard-local masked reductions + psum;
    <X_q> for local qubits is a shard-local pair reduction, for global
    qubits one ppermute pair exchange (the same halo pattern as gates).
    """
    n_amp = mesh.shape["amp"]
    n_traj_dev = mesh.shape["traj"]
    k_bits = int(np.log2(n_amp))
    local_bits = L - k_bits
    M = 1 << local_bits
    real_dt = jnp.float64 if dtype == jnp.complex128 else jnp.float32

    def local_fn(angles, hs, phis, term_hs, term_phis, x_coeff, keys):
        offset = (jax.lax.axis_index("amp") * M).astype(jnp.uint32)
        diag = zz_z_phase_mask(hs, phis, L, offset=offset, size=M, dtype=dtype)
        diag_e = zz_z_diag_energy(term_hs, term_phis, L, offset=offset, size=M,
                                  dtype=real_dt)
        gidx = jnp.arange(M, dtype=jnp.uint32) + offset
        init_idx = 0 if initial_state == "vacuum" else neel_index(L)
        psi0 = (gidx == jnp.uint32(init_idx)).astype(dtype)

        def fwd_cycle(state, ang, codes_t):
            # codes_t: (K, L) presampled Pauli codes for this cycle — the
            # scan body does no PRNG (one sample_depolarizing_codes call per
            # trajectory outside the scan); eager string application stays
            # because <X_q> is measured every cycle (off-diagonal — a
            # deferred XOR frame cannot cancel its pending phases)
            for kk in range(K):
                u = slot_unitary(ang[kk, 0], ang[kk, 1], dtype)
                state = apply_uniform_1q_layer(state, u, local_bits)
                for gb in range(k_bits):
                    state = _global_1q(state, u, gb, n_amp)
                if p > 0.0:
                    xm, zm, ny = pauli_string_masks(codes_t[kk])
                    state = _sharded_pauli_string(
                        state, xm, zm, ny, offset=offset, local_size=M,
                        local_bits=local_bits, n_shards=n_amp)
            return state * diag

        def measure(state):
            probs = jnp.real(state) ** 2 + jnp.imag(state) ** 2
            e_diag = jax.lax.psum(jnp.sum(probs * diag_e), "amp")
            zs = []
            for qq in range(L):
                sgn = z_sign_mask(qq, L, offset=offset, size=M)
                zs.append(jax.lax.psum(jnp.sum(probs * sgn), "amp"))
            zs = jnp.stack(zs)
            if with_x:
                xs = []
                for qq in range(L):
                    if qq < local_bits:
                        s = state.reshape(M >> (qq + 1), 2, 1 << qq)
                        part = 2.0 * jnp.real(jnp.sum(
                            jnp.conj(s[:, 0, :]) * s[:, 1, :]))
                        xs.append(jax.lax.psum(part, "amp"))
                    else:
                        # global qubit: each shard of the XOR pair computes
                        # Re<conj(mine), partner>; the two partners contribute
                        # equal values, so the psum supplies the factor of 2
                        # in <X> = 2 Re sum(conj(a0) a1) with no extra scaling.
                        gb = qq - local_bits
                        partner = jax.lax.ppermute(
                            state, "amp", _xor_perm(n_amp, gb))
                        part = jnp.real(jnp.sum(jnp.conj(state) * partner))
                        xs.append(jax.lax.psum(part, "amp"))
                e = e_diag + x_coeff * estimator_noise_factor * jnp.sum(jnp.stack(xs))
            else:
                e = e_diag
            return e, zs

        def one_traj(key):
            if p > 0.0:
                codes = sample_depolarizing_codes(key, p, (T, K, L))
            else:
                codes = jnp.zeros((T, K, L), jnp.int32)

            def body(carry, inp):
                ang, codes_t = inp
                out = measure(carry)
                carry = fwd_cycle(carry, ang, codes_t)
                return carry, out

            _, (e, zs) = jax.lax.scan(body, psi0, (angles, codes))
            return e, zs

        e_l, zs_l = jax.vmap(one_traj)(keys)
        e_tot = jax.lax.psum(jnp.sum(e_l, axis=0), "traj")
        zs_tot = jax.lax.psum(jnp.sum(zs_l, axis=0), "traj")
        n_total = keys.shape[0] * n_traj_dev
        return e_tot / n_total, zs_tot / n_total

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P("traj", None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)
