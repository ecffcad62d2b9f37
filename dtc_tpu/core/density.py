"""Exact noisy evolution: vectorized density matrix with interleaved bits.

Replaces Aer's density-matrix/noise engine (SURVEY.md §2d) for moderate L.
A DM on n qubits is stored as a vector of 4**n amplitudes where base-4 digit
q holds (col_bit<<1 | row_bit) of qubit q — row and column bits INTERLEAVED.
In this layout:

- a unitary U on qubit q  ->  4x4 matrix kron(conj(U), U) on digit q
- a 1q Kraus channel      ->  4x4 superoperator sum_k kron(conj(K_k), K_k)
- the fused RZZ+RZ layer  ->  one diagonal mask D(row) * conj(D)(col)
- Tr(P rho) for a Pauli string -> one weighted reduction with per-digit
  weights w[2a+b] = P[a, b]

so the WHOLE noisy Floquet cycle is the same kron-grouped-matmul + mask
machinery as the statevector engine, with local dimension 4: the kick+depol
slot is a single uniform 4x4-per-site layer (grouped into 64x64 matmuls),
not 2L sequential channel applications.

Direct-mode autocorrelator on the DM: the ancilla coherence block of the
Hadamard-test evolves as the (non-Hermitian) operator B_0 = rho_0 Z_q pushed
through the same noisy superoperator, giving A(t) = (1-p)^6 Re Tr(Z_q B_t)
emitted every cycle of ONE scan — O(T), exact, no ancilla dimension. An
interferometric mode with a literal ancilla qubit + its 6 depol events exists
for validation (dm_autocorr_interferometric).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dtc_tpu.ops.precision import gate_precision
import numpy as np

from dtc_tpu.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu.ops.diag import zz_z_phase_mask


# ---------------------------------------------------------------------------
# layout helpers


def _interleave_bits(row: int, col: int, n: int) -> int:
    s = 0
    for q in range(n):
        s |= ((row >> q) & 1) << (2 * q)
        s |= ((col >> q) & 1) << (2 * q + 1)
    return s


def pure_dm_vec(psi: jnp.ndarray, n: int) -> jnp.ndarray:
    """|psi><psi| as an interleaved vec of length 4**n (host-side setup)."""
    rho = jnp.outer(psi, jnp.conj(psi))  # [row, col]
    # interleave: reshape (2,)*n (row) + (2,)*n (col) then transpose pairs
    t = rho.reshape((2,) * (2 * n))
    # current axis order: row bits n-1..0 then col bits n-1..0 (jnp reshape is
    # row-major => axis 0 is the MSB of the row index)
    perm = []
    for q in range(n - 1, -1, -1):  # from MSB digit down
        perm.append(n - 1 - q + n)  # col bit q axis
        perm.append(n - 1 - q)      # row bit q axis
    t = jnp.transpose(t, perm)
    return t.reshape(4**n)


def dm_vec_to_matrix(vec: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse of pure_dm_vec packing: interleaved vec -> rho[row, col]."""
    t = vec.reshape((2,) * (2 * n))
    # axes currently: [col_{n-1}, row_{n-1}, col_{n-2}, row_{n-2}, ...]
    row_axes = [2 * i + 1 for i in range(n)]
    col_axes = [2 * i for i in range(n)]
    t = jnp.transpose(t, row_axes + col_axes)
    return t.reshape(2**n, 2**n)


# ---------------------------------------------------------------------------
# site-local superoperators


def unitary_site_op(u: jnp.ndarray) -> jnp.ndarray:
    """4x4 digit operator for rho -> U rho U^dag (digit = col<<1 | row)."""
    return jnp.kron(jnp.conj(u), u)


def depolarizing_site_op(p: float, dtype=jnp.complex64) -> jnp.ndarray:
    """qiskit depolarizing_error(p,1) as a 4x4 digit superoperator."""
    I = np.eye(2)
    X = np.array([[0, 1], [1, 0]])
    Y = np.array([[0, -1j], [1j, 0]])
    Z = np.array([[1, 0], [0, -1]])
    m = (1 - 3 * p / 4) * np.kron(I, I)
    for P in (X, Y, Z):
        m = m + (p / 4) * np.kron(np.conj(P), P)
    return jnp.asarray(m, dtype=dtype)


def apply_uniform_site_layer(vec: jnp.ndarray, m4: jnp.ndarray, n_sites: int,
                             group: int = 3) -> jnp.ndarray:
    """Apply the same 4x4 op to digits 0..n_sites-1 of a base-4 vector.

    group=3 -> 64x64 kron blocks (group=4 -> 256). Digits above n_sites
    (e.g. a literal ancilla) are untouched.
    """
    total = vec.shape[-1]
    shape = vec.shape
    q = 0
    while q < n_sites:
        k = min(group, n_sites - q)
        mk = m4
        for _ in range(k - 1):
            mk = jnp.kron(mk, m4)
        high = total >> (2 * (q + k))
        low = 1 << (2 * q)
        s = vec.reshape(*shape[:-1], high, 1 << (2 * k), low)
        s = jnp.einsum("ab,...hbl->...hal", mk, s, precision=gate_precision())
        vec = s.reshape(shape)
        q += k
    return vec


def apply_site_op(vec: jnp.ndarray, m4: jnp.ndarray, q: int) -> jnp.ndarray:
    """Apply a 4x4 op to digit q only."""
    total = vec.shape[-1]
    shape = vec.shape
    high = total >> (2 * (q + 1))
    low = 1 << (2 * q)
    s = vec.reshape(*shape[:-1], high, 4, low)
    s = jnp.einsum("ab,...hbl->...hal", m4, s, precision=gate_precision())
    return s.reshape(shape)


def diag_mask_dm(diag_sv: jnp.ndarray, n: int) -> jnp.ndarray:
    """General lift: mask[s] = D(row(s)) * conj(D(col(s))) via bit gathers."""
    size = 4**n
    idx = jnp.arange(size, dtype=jnp.uint32)
    row = jnp.zeros_like(idx)
    col = jnp.zeros_like(idx)
    for q in range(n):
        row = row | (((idx >> (2 * q)) & 1) << q)
        col = col | (((idx >> (2 * q + 1)) & 1) << q)
    return diag_sv[row.astype(jnp.int32)] * jnp.conj(diag_sv[col.astype(jnp.int32)])


def pauli_weight_vector(codes, n: int, dtype=jnp.complex64) -> jnp.ndarray:
    """w[s] = prod_q P_q[col_bit, row_bit]: Tr(P rho) = sum_s w[s] vec[s].

    codes: length-n ints {0:I,1:X,2:Y,3:Z}. Weight tables per digit
    (v = col<<1 | row): I:[1,0,0,1] X:[0,1,1,0] Y:[0,-i,i,0]... note
    w[v=2a+b] = P[a,b] with a=col? Tr(P rho) = sum_{a,b} P[a,b] rho[b,a]
    => element rho[row=b, col=a] gets weight P[a, b]: v = (a<<1)|b.
    """
    tables = jnp.asarray(
        np.array(
            [
                [1, 0, 0, 1],          # I
                [0, 1, 1, 0],          # X: P[0,1]=1 -> v=(0<<1)|1=1; P[1,0]=1 -> v=2
                [0, -1j, 1j, 0],       # Y: P[0,1]=-i -> v=1; P[1,0]=i -> v=2
                [1, 0, 0, -1],         # Z
            ]
        ),
        dtype=dtype,
    )
    size = 4**n
    idx = jnp.arange(size, dtype=jnp.uint32)
    w = jnp.ones((size,), dtype=dtype)
    for q in range(n):
        v = ((idx >> (2 * q)) & 3).astype(jnp.int32)
        w = w * tables[codes[q]][v]
    return w


def trace_weight_vector(n: int, dtype=jnp.complex64) -> jnp.ndarray:
    return pauli_weight_vector([0] * n, n, dtype=dtype)


# ---------------------------------------------------------------------------
# operator vectors and two-site ops


def op_vec(a: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Interleaved vec of the (generally non-Hermitian) operator |a><b|."""
    rho = jnp.outer(a, jnp.conj(b))
    t = rho.reshape((2,) * (2 * n))
    perm = []
    for q in range(n - 1, -1, -1):
        perm.append(n - 1 - q + n)  # col bit q axis
        perm.append(n - 1 - q)      # row bit q axis
    return jnp.transpose(t, perm).reshape(4**n)


def two_qubit_superop(u4: np.ndarray) -> np.ndarray:
    """16x16 digit-pair superop of a 4x4 unitary (qubit order hi=q1, lo=q2).

    Output index = (digit_{q1} << 2) | digit_{q2}, digit = col<<1 | row.
    """
    s = np.zeros((16, 16), dtype=complex)
    uc = np.conj(u4)
    for r1p in range(2):
        for r2p in range(2):
            for c1p in range(2):
                for c2p in range(2):
                    for r1 in range(2):
                        for r2 in range(2):
                            for c1 in range(2):
                                for c2 in range(2):
                                    val = (
                                        u4[(r1p << 1) | r2p, (r1 << 1) | r2]
                                        * uc[(c1p << 1) | c2p, (c1 << 1) | c2]
                                    )
                                    if val == 0:
                                        continue
                                    row_idx = ((((c1p << 1) | r1p) << 2)
                                               | ((c2p << 1) | r2p))
                                    col_idx = ((((c1 << 1) | r1) << 2)
                                               | ((c2 << 1) | r2))
                                    s[row_idx, col_idx] += val
    return s


def apply_two_site_op(vec: jnp.ndarray, m16: jnp.ndarray, s1: int, s2: int) -> jnp.ndarray:
    """Apply a 16x16 digit-pair op to sites (s1, s2), s1 indexed as high digit."""
    total = vec.shape[-1]
    shape = vec.shape
    if s1 == s2:
        raise ValueError("sites must differ")
    sa, sb = (s1, s2) if s1 > s2 else (s2, s1)
    top = total >> (2 * (sa + 1))
    mid = 1 << (2 * (sa - 1 - sb))
    low = 1 << (2 * sb)
    s = vec.reshape(*shape[:-1], top, 4, mid, 4, low)
    m = m16.reshape(4, 4, 4, 4)  # [a1, a2, b1, b2], a1 = digit of s1
    if s1 > s2:
        s = jnp.einsum("acbd,...xbmdz->...xamcz", m, s, precision=gate_precision())
    else:
        s = jnp.einsum("acbd,...xdmbz->...xcmaz", m, s, precision=gate_precision())
    return s.reshape(shape)


# ---------------------------------------------------------------------------
# Floquet evolution on the vectorized DM


def _dm_cycle(vec, angles, dmask, depol4, *, L, K, p, dtype, inverse=False):
    if inverse:
        vec = vec * jnp.conj(dmask)
        for k in range(K - 1, -1, -1):
            u = slot_unitary_inverse(angles[k, 0], angles[k, 1], dtype)
            vec = apply_uniform_site_layer(vec, unitary_site_op(u), L)
            if p > 0.0:
                vec = apply_uniform_site_layer(vec, depol4, L)
        return vec
    for k in range(K):
        u = slot_unitary(angles[k, 0], angles[k, 1], dtype)
        vec = apply_uniform_site_layer(vec, unitary_site_op(u), L)
        if p > 0.0:
            vec = apply_uniform_site_layer(vec, depol4, L)
    return vec * dmask


@functools.partial(jax.jit, static_argnames=("L", "T", "K", "p", "q", "ancilla_factor"))
def dm_autocorr_forward(psi0, angles, diag_sv, *, L, T, K, p, q, ancilla_factor=None):
    """Exact noisy A(t), t=0..T-1, via the coherence-block operator scan.

    B_0 = rho_0 Z_q evolves through the noisy cycle superoperator; emit
    A(t) = (1-p)^6 Re Tr(Z_q B_t) each cycle (6 = ancilla u2 depol events,
    see dtc_tpu.models.noise).
    """
    dtype = psi0.dtype
    af = (1.0 - p) ** 6 if ancilla_factor is None else ancilla_factor
    from dtc_tpu.ops.diag import z_sign_mask

    zq = z_sign_mask(q, L, dtype=psi0.real.dtype)
    b0 = op_vec(psi0, zq.astype(dtype) * psi0, n=L)  # rho0 Z_q = |psi><Z psi|
    dmask = diag_mask_dm(diag_sv, L)
    depol4 = depolarizing_site_op(p, dtype=dtype)
    wz = pauli_weight_vector([3 if i == q else 0 for i in range(L)], L, dtype=dtype)

    def body(carry, ang):
        a_t = af * jnp.real(jnp.sum(wz * carry))
        carry = _dm_cycle(carry, ang, dmask, depol4, L=L, K=K, p=p, dtype=dtype)
        return carry, a_t

    _, a = jax.lax.scan(body, b0, angles)
    return a


@functools.partial(jax.jit, static_argnames=("L", "T", "K", "p", "q", "ancilla_factor"))
def dm_autocorr_echo(psi0, angles, diag_sv, t_value, *, L, T, K, p, q, ancilla_factor=None):
    """Exact noisy echo A0(t): t forward + t reversed inverse cycles (masked scan)."""
    dtype = psi0.dtype
    af = (1.0 - p) ** 6 if ancilla_factor is None else ancilla_factor
    from dtc_tpu.ops.diag import z_sign_mask

    zq = z_sign_mask(q, L, dtype=psi0.real.dtype)
    b0 = op_vec(psi0, zq.astype(dtype) * psi0, n=L)
    dmask = diag_mask_dm(diag_sv, L)
    depol4 = depolarizing_site_op(p, dtype=dtype)
    wz = pauli_weight_vector([3 if i == q else 0 for i in range(L)], L, dtype=dtype)
    id4 = jnp.eye(4, dtype=dtype)

    def body(carry, k):
        fwd = k < t_value
        inv = (k >= t_value) & (k < 2 * t_value)
        idx = jnp.where(fwd, k, jnp.clip(2 * t_value - 1 - k, 0, T - 1))
        ang = angles[idx]
        vec = jnp.where(inv, jnp.conj(dmask), jnp.ones((), dtype)) * carry
        for pos in range(K):
            th_f = ang[pos]
            th_i = ang[K - 1 - pos]
            u_f = unitary_site_op(slot_unitary(th_f[0], th_f[1], dtype))
            u_i = unitary_site_op(slot_unitary_inverse(th_i[0], th_i[1], dtype))
            m = jnp.where(fwd, u_f, jnp.where(inv, u_i, id4))
            vec = apply_uniform_site_layer(vec, m, L)
            if p > 0.0:
                active = fwd | inv
                dep = jnp.where(active, depol4, id4)
                vec = apply_uniform_site_layer(vec, dep, L)
        vec = jnp.where(fwd, dmask, jnp.ones((), dtype)) * vec
        return vec, None

    vec, _ = jax.lax.scan(body, b0, jnp.arange(2 * T))
    return af * jnp.real(jnp.sum(wz * vec))


@functools.partial(jax.jit, static_argnames=("L", "T", "K", "p"))
def dm_energy(psi0, angles, diag_sv, weight_vec, *, L, T, K, p):
    """Exact noisy E(t) = Re sum(weight_vec * vec_t), one scan."""
    dtype = psi0.dtype
    rho0 = op_vec(psi0, psi0, n=L)
    dmask = diag_mask_dm(diag_sv, L)
    depol4 = depolarizing_site_op(p, dtype=dtype)

    def body(carry, ang):
        e_t = jnp.real(jnp.sum(weight_vec * carry))
        carry = _dm_cycle(carry, ang, dmask, depol4, L=L, K=K, p=p, dtype=dtype)
        return carry, e_t

    _, e = jax.lax.scan(body, rho0, angles)
    return e


def energy_weight_vector(terms, L: int, dtype=jnp.complex64) -> jnp.ndarray:
    """Combined Tr(H rho) weight vector from HamiltonianTerms."""
    hs = np.asarray(terms.hs)
    phis = np.asarray(terms.phis)
    xc = float(terms.x_coeff)
    w = jnp.zeros((4**L,), dtype=dtype)
    for i in range(L):
        if hs[i] != 0.0:
            w = w + hs[i] * pauli_weight_vector(
                [3 if j == i else 0 for j in range(L)], L, dtype=dtype)
        if xc != 0.0:
            w = w + xc * pauli_weight_vector(
                [1 if j == i else 0 for j in range(L)], L, dtype=dtype)
    for i in range(L - 1):
        if phis[i] != 0.0:
            w = w + phis[i] * pauli_weight_vector(
                [3 if j in (i, i + 1) else 0 for j in range(L)], L, dtype=dtype)
    return w


def dm_autocorr_interferometric(psi0, angles, diag_sv, t: int, *, L, K, p,
                                q=None, echo=False):
    """Literal Hadamard-test on L+1 sites with explicit ancilla depol events.

    Validation mode (python loop over cycles, not jitted): mirrors the
    transpiled reference circuit gate-for-gate — h [depol]; h [depol] cx
    h [depol]; cycles; h [depol] cx h [depol]; h [depol]; <Z_anc>
    (autocorr-delta-a-single-qiskit-fast.py:124-147 + CZ/H -> u2 decomposition
    evidenced by gate_counts_t*_*.csv u2=6).
    """
    dtype = psi0.dtype
    n = L + 1
    anc = L
    qq = (L // 2) if q is None else q
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    h_op = jnp.asarray(np.kron(np.conj(h), h), dtype=dtype)
    depol4 = depolarizing_site_op(p, dtype=dtype)
    cx = np.zeros((4, 4), dtype=complex)  # control = hi bit (system q), target = lo (anc)
    for b in range(4):
        hi, lo = (b >> 1) & 1, b & 1
        cx[(hi << 1) | (lo ^ hi), b] = 1
    cx_super = jnp.asarray(two_qubit_superop(cx), dtype=dtype)

    psi_full = jnp.zeros((2**n,), dtype=dtype).at[: 2**L].set(psi0)
    vec = op_vec(psi_full, psi_full, n=n)
    dmask = diag_mask_dm(jnp.concatenate([diag_sv, diag_sv]), n)  # ancilla: no phase

    def hd(v):
        v = apply_site_op(v, h_op, anc)
        if p > 0.0:
            v = apply_site_op(v, depol4, anc)
        return v

    vec = hd(vec)
    vec = hd(vec)
    vec = apply_two_site_op(vec, cx_super, qq, anc)
    vec = hd(vec)
    for step in range(t):
        vec = _dm_cycle(vec, angles[step], dmask, depol4, L=L, K=K, p=p, dtype=dtype)
    if echo:
        for step in range(t - 1, -1, -1):
            vec = _dm_cycle(vec, angles[step], dmask, depol4, L=L, K=K, p=p,
                            dtype=dtype, inverse=True)
    vec = hd(vec)
    vec = apply_two_site_op(vec, cx_super, qq, anc)
    vec = hd(vec)
    vec = hd(vec)
    wz = pauli_weight_vector([3 if i == anc else 0 for i in range(n)], n, dtype=dtype)
    return float(jnp.real(jnp.sum(wz * vec)))


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "p", "q", "initial_state", "dtype_name",
                     "ancilla_factor"),
)
def dm_autocorr_forward_run(hs, phis, angles, *, L, T, K, p, q,
                            initial_state="vacuum", dtype_name="complex64",
                            ancilla_factor=None):
    """Real-boundary wrapper: exact noisy A(t) from (hs, phis) directly.

    The EXACT density-matrix mode of the autocorr experiment (BASELINE
    config 1: L=4 DTC, depol 0.05, density-matrix). Complex state built
    inside jit from real inputs.
    """
    from dtc_tpu.core.statevector import initial_statevector
    from dtc_tpu.experiments.engine import resolve_dtype

    dtype = resolve_dtype(dtype_name)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    diag_sv = zz_z_phase_mask(hs, phis, L, dtype=dtype)
    return dm_autocorr_forward(psi0, angles, diag_sv, L=L, T=T, K=K, p=p, q=q,
                               ancilla_factor=ancilla_factor)


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "p", "q", "initial_state", "dtype_name",
                     "ancilla_factor"),
)
def dm_autocorr_echo_run(hs, phis, angles, ts, *, L, T, K, p, q,
                         initial_state="vacuum", dtype_name="complex64",
                         ancilla_factor=None):
    """Real-boundary exact echo for a vector of time points."""
    from dtc_tpu.core.statevector import initial_statevector
    from dtc_tpu.experiments.engine import resolve_dtype

    dtype = resolve_dtype(dtype_name)
    psi0 = initial_statevector(L, initial_state, dtype=dtype)
    diag_sv = zz_z_phase_mask(hs, phis, L, dtype=dtype)
    return jax.vmap(
        lambda t: dm_autocorr_echo(psi0, angles, diag_sv, t, L=L, T=T, K=K,
                                   p=p, q=q, ancilla_factor=ancilla_factor)
    )(ts)
