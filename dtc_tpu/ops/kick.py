"""Fused single-qubit gate layers via kron-grouped matmuls.

The reference applies the kick layer as L separate ``rx(pi*g)`` gates
(autocorr-delta-a-single-qiskit-fast.py:113-114), which on any backend means L
passes over the 2**n amplitudes. Here ``k`` qubits at a time are
left-multiplied by the dense ``2**k x 2**k`` Kronecker power ``U^{(x)k}``,
turning the whole layer into ``ceil(n/k)`` batched matmuls: ~k-fold less
memory traffic than per-qubit application, at 2**k complex multiply-adds per
amplitude per group instead of 2. Whether k=7 is the right trade on the
current device is an open measurement (ROADMAP S3).
"""

from __future__ import annotations

import jax.numpy as jnp

from dtc_tpu.ops.precision import gate_precision

_GROUP = 7


def kron_power(u: jnp.ndarray, k: int) -> jnp.ndarray:
    """U^{(x)k} (k <= ~7, so a simple build loop traced once under jit)."""
    result = u
    for _ in range(k - 1):
        result = jnp.kron(result, u)
    return result


def apply_uniform_1q_layer(
    state: jnp.ndarray, u: jnp.ndarray, n: int, group: int = _GROUP
) -> jnp.ndarray:
    """Apply the same 2x2 unitary ``u`` to every one of the ``n`` low qubits.

    ``state``: shape (..., 2**m) with m >= n; qubits n..m-1 (high bits, e.g.
    an ancilla) are untouched. Works under jit with traced ``u``.
    """
    m_total = state.shape[-1]
    shape = state.shape
    q = 0
    while q < n:
        k = min(group, n - q)
        uk = kron_power(u, k) if k > 1 else u
        high = m_total >> (q + k)
        low = 1 << q
        s = state.reshape(*shape[:-1], high, 1 << k, low)
        # Contract the middle (2**k) axis: batched (2**k x 2**k) @ (2**k x low)
        s = jnp.einsum("ab,...hbl->...hal", uk, s, precision=gate_precision())
        state = s.reshape(shape)
        q += k
    return state


def apply_per_qubit_1q_layer(
    state: jnp.ndarray, us: jnp.ndarray, n: int, group: int = _GROUP
) -> jnp.ndarray:
    """Apply a possibly different 2x2 unitary to each of the n low qubits.

    ``us``: shape (n, 2, 2), us[q] applied to qubit q. Groups of ``group``
    qubits are fused into one dense kron matrix per group (kron order: higher
    qubit index = left factor).
    """
    m_total = state.shape[-1]
    shape = state.shape
    q = 0
    while q < n:
        k = min(group, n - q)
        uk = us[q + k - 1]
        for j in range(k - 2, -1, -1):
            uk = jnp.kron(uk, us[q + j])
        high = m_total >> (q + k)
        low = 1 << q
        s = state.reshape(*shape[:-1], high, 1 << k, low)
        s = jnp.einsum("ab,...hbl->...hal", uk, s, precision=gate_precision())
        state = s.reshape(shape)
        q += k
    return state
