"""Fused diagonal layers for the kicked-Ising Floquet cycle.

The whole interaction + disorder part of one Floquet cycle —
even-bond RZZ, odd-bond RZZ, and the RZ disorder layer
(autocorr-delta-a-single-qiskit-fast.py:115-120) — is diagonal in the
computational basis and mutually commuting, so it collapses into ONE
elementwise complex multiply by a precomputed phase mask, instead of the
reference's 2L-1 separate gate applications per cycle.

Conventions: RZ(h) = diag(e^{-ih/2}, e^{ih/2}) = exp(-i h/2 Z),
RZZ(phi) = exp(-i phi/2 Z(x)Z); with z_q = 1 - 2*bit_q the mask is
exp(-i/2 * E(s)),  E(s) = sum_q h_q z_q + sum_q phi_q z_q z_{q+1}.
``E`` doubles as the diagonal (Z + ZZ) part of the energy observable
(autocorr-delta-a-single-qiskit-fast-energy.py:83-102).
"""

from __future__ import annotations

import jax.numpy as jnp


def _z_signs(idx: jnp.ndarray, q: int, dtype) -> jnp.ndarray:
    """z_q = +1 for bit 0, -1 for bit 1, as ``dtype``."""
    bit = ((idx >> q) & 1).astype(jnp.int32)  # int32: avoid uint underflow in 1-2b
    return (1 - 2 * bit).astype(dtype)


def zz_z_diag_energy(
    hs: jnp.ndarray,
    phis: jnp.ndarray,
    n: int,
    *,
    offset=0,
    size: int | None = None,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """E(s) = sum_q hs[q] z_q(s) + sum_q phis[q] z_q(s) z_{q+1}(s).

    ``offset``/``size`` select a contiguous index window — used by the
    amplitude-sharded engine where each device evaluates only its local
    window of global indices (offset = shard_index * local_size).
    """
    if size is None:
        size = 1 << n
    idx = jnp.arange(size, dtype=jnp.uint32) + jnp.uint32(offset)
    e = jnp.zeros((size,), dtype=dtype)
    z_prev = None
    for q in range(n):
        z = _z_signs(idx, q, dtype)
        e = e + hs[q] * z
        if q > 0:
            e = e + phis[q - 1] * z_prev * z
        z_prev = z
    return e


def zz_z_phase_mask(
    hs: jnp.ndarray,
    phis: jnp.ndarray,
    n: int,
    *,
    offset=0,
    size: int | None = None,
    dtype=jnp.complex64,
) -> jnp.ndarray:
    """exp(-i/2 E(s)) — one fused mask for the full RZZ(even)+RZZ(odd)+RZ layer."""
    real_dtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    e = zz_z_diag_energy(hs, phis, n, offset=offset, size=size, dtype=real_dtype)
    return jnp.exp((-0.5j) * e.astype(dtype))


def z_sign_mask(q: int, n: int, *, offset=0, size: int | None = None, dtype=jnp.float32):
    """Vector of z_q(s) signs — the diagonal of the Z_q observable."""
    if size is None:
        size = 1 << n
    idx = jnp.arange(size, dtype=jnp.uint32) + jnp.uint32(offset)
    return _z_signs(idx, q, dtype)


def cz_sign_mask(q1: int, q2: int, n: int, *, offset=0, size: int | None = None, dtype=jnp.float32):
    """Diagonal of CZ(q1, q2): -1 where both bits set, else +1."""
    if size is None:
        size = 1 << n
    idx = jnp.arange(size, dtype=jnp.uint32) + jnp.uint32(offset)
    both = (((idx >> q1) & 1) * ((idx >> q2) & 1)).astype(jnp.int32)
    return (1 - 2 * both).astype(dtype)
