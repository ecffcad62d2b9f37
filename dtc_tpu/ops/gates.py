"""Dense gate application on flat statevectors.

Conventions
-----------
- A state on ``n`` qubits is an array of shape ``(..., 2**n)`` (arbitrary
  leading batch axes, e.g. trajectories or disorder instances).
- Qubit ``q`` is the q-th bit of the flattened basis index, **qubit 0 =
  least-significant bit** (Qiskit little-endian convention, matching the
  reference's ``compute_z_expectation`` bit reversal at
  autocorr-delta-a-single-qiskit-fast.py:101).
- Gates are applied in-place semantically (functionally in JAX): the returned
  array replaces the input.

These are the "reference kernels": simple reshape+contract forms that XLA
lowers to batched matmuls/fused elementwise. The fused fast paths live
in :mod:`dtc_tpu.ops.kick` (kron-grouped kick layers) and
:mod:`dtc_tpu.ops.diag` (single phase mask per Floquet diagonal layer).
"""

from __future__ import annotations

import jax.numpy as jnp

from dtc_tpu.ops.precision import gate_precision


def _split(state: jnp.ndarray, q: int, n: int):
    """Reshape last axis 2**n -> (high=2**(n-1-q), 2, low=2**q)."""
    high = 1 << (n - 1 - q)
    low = 1 << q
    return state.reshape(*state.shape[:-1], high, 2, low)


def apply_1q(state: jnp.ndarray, u: jnp.ndarray, q: int, n: int) -> jnp.ndarray:
    """Apply a 2x2 unitary ``u`` to qubit ``q`` of an ``n``-qubit state."""
    shape = state.shape
    s = _split(state, q, n)
    s = jnp.einsum("ab,...xbz->...xaz", u, s, precision=gate_precision())
    return s.reshape(shape)


def apply_2q(state: jnp.ndarray, u: jnp.ndarray, q1: int, q2: int, n: int) -> jnp.ndarray:
    """Apply a 4x4 matrix ``u`` to qubits ``(q1, q2)`` of an ``n``-qubit state.

    ``u`` is indexed as ``u[(a1 a2), (b1 b2)]`` with ``a1`` the bit of ``q1``
    (i.e. q1 is the most-significant bit of the 2-bit gate index — matches
    ``kron(U_q1, U_q2)`` ordering). ``q1 != q2`` required; any order allowed.

    Not restricted to unitaries: also used for superoperator (Kraus-channel)
    blocks in the vectorized density-matrix engine.
    """
    shape = state.shape
    if q1 == q2:
        raise ValueError("q1 and q2 must differ")
    qa, qb = (q1, q2) if q1 > q2 else (q2, q1)  # qa = higher bit position
    # Split axes: (..., top, 2[qa], mid, 2[qb], low)
    top = 1 << (n - 1 - qa)
    mid = 1 << (qa - 1 - qb)
    low = 1 << qb
    s = state.reshape(*state.shape[:-1], top, 2, mid, 2, low)
    u4 = u.reshape(2, 2, 2, 2)  # [a1, a2, b1, b2] with a1 = bit of q1
    if q1 > q2:
        # qa bit is u's first index
        s = jnp.einsum("acbd,...xbmdz->...xamcz", u4, s, precision=gate_precision())
    else:
        # q1 is the lower bit position: swap gate-index roles
        s = jnp.einsum("acbd,...xdmbz->...xcmaz", u4, s, precision=gate_precision())
    return s.reshape(shape)


def apply_diag(state: jnp.ndarray, diag: jnp.ndarray) -> jnp.ndarray:
    """Multiply by a (broadcastable) diagonal, e.g. a fused RZZ+RZ phase mask."""
    return state * diag


def apply_gate_layer(state: jnp.ndarray, gates, n: int) -> jnp.ndarray:
    """Apply a sequence of ``(u_2x2, qubit)`` pairs in order."""
    for u, q in gates:
        state = apply_1q(state, u, q, n)
    return state


def probabilities_bit(state: jnp.ndarray, q: int, n: int):
    """Return (p0, p1): probability of qubit ``q`` being 0/1."""
    s = _split(state, q, n)
    p = jnp.sum(jnp.abs(s) ** 2, axis=(-3, -1))
    return p[..., 0], p[..., 1]


def expect_z(state: jnp.ndarray, q: int, n: int) -> jnp.ndarray:
    """<Z_q> on a normalized state."""
    p0, p1 = probabilities_bit(state, q, n)
    return p0 - p1


def expect_x(state: jnp.ndarray, q: int, n: int) -> jnp.ndarray:
    """<X_q> on a normalized state: 2 Re sum conj(psi_0) psi_1 over bit-q pairs."""
    s = _split(state, q, n)
    return 2.0 * jnp.real(jnp.sum(jnp.conj(s[..., 0, :]) * s[..., 1, :], axis=(-2, -1)))
