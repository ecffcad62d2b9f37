"""Pauli-string application — the trajectory-noise workhorse.

Aer inserts one sampled Pauli per noisy transpiled 1q gate per shot
(qiskit_aer depolarizing_error on u1/u2/u3,
autocorr-delta-a-single-qiskit-fast.py:84-86). A whole per-cycle noise layer
(one sampled Pauli per qubit) is a single Pauli STRING, which acts on a
statevector as one XOR-permutation plus one elementwise phase:

    P|s> = i^{n_Y} (-1)^{popcount(s & zmask)} |s XOR xmask>

so an L-qubit noise layer costs one gather + one multiply — independent of L —
instead of L sequential 1q gate applications.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# I, X, Y, Z — host-side table (tests / channel builders). Kept as numpy so
# importing this module creates no device array.
PAULIS = np.array(
    [
        [[1, 0], [0, 1]],
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex64,
)


def _i_power(n_y: jnp.ndarray, dtype) -> jnp.ndarray:
    """i**n_y as a traced complex scalar (no host complex constants)."""
    m = n_y % 4
    re = jnp.where(m == 0, 1.0, jnp.where(m == 2, -1.0, 0.0))
    im = jnp.where(m == 1, 1.0, jnp.where(m == 3, -1.0, 0.0))
    return (re + 1j * im).astype(dtype)


def pauli_string_masks(codes: jnp.ndarray):
    """codes (n,) int in {0:I,1:X,2:Y,3:Z} -> (xmask, zmask, n_y) uint32/int32.

    xmask flags X/Y positions (bit flips), zmask flags Y/Z positions (signs).
    """
    n = codes.shape[0]
    weights = (jnp.uint32(1) << jnp.arange(n, dtype=jnp.uint32))
    is_x = (codes == 1) | (codes == 2)
    is_z = codes >= 2
    xmask = jnp.sum(jnp.where(is_x, weights, jnp.uint32(0)), dtype=jnp.uint32)
    zmask = jnp.sum(jnp.where(is_z, weights, jnp.uint32(0)), dtype=jnp.uint32)
    n_y = jnp.sum((codes == 2).astype(jnp.int32))
    return xmask, zmask, n_y


def _parity(v: jnp.ndarray) -> jnp.ndarray:
    """(-1)^popcount parity bit of uint32 array."""
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return (v & jnp.uint32(1)).astype(jnp.int32)


def apply_pauli_string(
    state: jnp.ndarray,
    xmask: jnp.ndarray,
    zmask: jnp.ndarray,
    n_y: jnp.ndarray,
    *,
    offset=0,
) -> jnp.ndarray:
    """Apply P = (x)_q P_q to ``state`` of shape (..., size).

    ``xmask``/``zmask`` are traced uint32 scalars (sampled per trajectory &
    cycle under vmap/scan). ``offset`` is the global index of local element 0
    for amplitude-sharded states; the caller must have already resolved any
    xmask bits above log2(size) via a shard permutation.
    """
    size = state.shape[-1]
    idx = jnp.arange(size, dtype=jnp.uint32) + jnp.uint32(offset)
    src = idx ^ jnp.uint32(xmask)
    sign = 1 - 2 * _parity(src & jnp.uint32(zmask))
    amp = jnp.take(state, (src - jnp.uint32(offset)).astype(jnp.int32), axis=-1)
    phase = _i_power(n_y, state.dtype)
    return amp * (phase * sign.astype(state.real.dtype))


def sample_depolarizing_codes(key, p, shape):
    """Sample Pauli codes per site: P(I)=1-3p/4, P(X)=P(Y)=P(Z)=p/4.

    Matches qiskit_aer.noise.depolarizing_error(p, 1), whose mixed-unitary
    decomposition is exactly these four probabilities.
    """
    import jax

    u = jax.random.uniform(key, shape, dtype=jnp.float32)
    # thresholds: [0, 1-3p/4) -> I; then thirds of the remaining 3p/4.
    # p may be a scalar or a per-qubit vector broadcastable to `shape`
    # (device-noise calibrations); guard the divide for p=0 entries.
    q = jnp.asarray(p) * 0.25
    c = (u >= (1.0 - 3.0 * q)).astype(jnp.int32) * (
        1 + jnp.floor((u - (1.0 - 3.0 * q)) / jnp.maximum(q, 1e-30)).astype(jnp.int32)
    )
    return jnp.clip(c, 0, 3)


def sample_bond_depolarizing_codes(key, p_bonds, start: int, L: int):
    """Two-qubit depolarizing layer on bonds (start, start+2, ...) -> per-site
    Pauli codes (L,).

    Each bond (i, i+1) draws from the 2q depolarizing mixture: identity with
    prob 1 - 15p/16, else one of the 15 non-identity Pauli pairs uniformly
    (qiskit depolarizing_error(p, 2) mixed-unitary decomposition). Bonds in
    one even/odd sublayer are disjoint, so the layer is one Pauli string.
    """
    import jax

    bonds = [(i, i + 1) for i in range(start, L - 1, 2)]
    nb = len(bonds)
    p = jnp.broadcast_to(jnp.asarray(p_bonds), (nb,))
    u = jax.random.uniform(key, (nb,))
    q16 = p / 16.0
    idx = (u >= (1.0 - 15.0 * q16)).astype(jnp.int32) * (
        1 + jnp.floor((u - (1.0 - 15.0 * q16)) / jnp.maximum(q16, 1e-30)).astype(jnp.int32)
    )
    idx = jnp.clip(idx, 0, 15)
    c_hi = idx >> 2   # code on bond site i
    c_lo = idx & 3    # code on bond site i+1
    codes = jnp.zeros((L,), dtype=jnp.int32)
    sites_hi = jnp.asarray([b[0] for b in bonds], dtype=jnp.int32)
    sites_lo = jnp.asarray([b[1] for b in bonds], dtype=jnp.int32)
    codes = codes.at[sites_hi].set(c_hi)
    codes = codes.at[sites_lo].set(c_lo)
    return codes
