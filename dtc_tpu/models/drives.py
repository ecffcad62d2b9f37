"""Kicked-Ising drive (kick-layer) schedules for every polarization family.

One Floquet cycle = kick layer, even-bond RZZ, odd-bond RZZ, RZ disorder
(autocorr-delta-a-single-qiskit-fast.py:111-121). The kick layer depends on
the polarization family and possibly the cycle index:

- "x"/"y":       RX(pi g) / RY(pi g)                    (...-fast-polarization.py:110-129)
- "xy"/"yx":     RX(pi g/2) then RY(pi g/2) (or swapped)
- "circular_left/right": RX(pi g cos(w t)/sqrt2), RY(+-pi g sin(w t)/sqrt2)
                 per cycle t                  (...-fast-circular-polarization.py:110-142)
- "circular_static": RX(pi g/sqrt2), RY(pi g/sqrt2)
- "xy_cycle":    axis = X for cycles 0-4, Y for 5-9, ... (period 5)
                 (...-fast-polarization-xy-cycle.py:141-155)

We encode every family as a dense (T, K, 2) array of (theta_x, theta_y)
angles: cycle t applies sub-kick slots k = 0..K-1 in order, each slot being
RY(theta_y) @ RX(theta_x) — families only populate one of the two per slot, so
each slot maps to exactly one transpiled u3 gate (= one depolarizing noise
event per qubit in Aer's noise model). Time-dependent g (the adaptive-g
controller) is just a per-cycle g vector feeding the same constructor.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class KickSchedule:
    """Per-cycle kick-slot angles.

    angles: (T, K, 2) float array; angles[t, k] = (theta_x, theta_y) of slot k
    in cycle t. Slots act in increasing k order in the forward cycle.
    """

    angles: jnp.ndarray

    @property
    def T(self) -> int:
        return self.angles.shape[0]

    @property
    def K(self) -> int:
        return self.angles.shape[1]


def n_kick_slots(polarization: str) -> int:
    return 1 if polarization in ("x", "y", "xy_cycle") else 2


def build_kick_schedule(
    polarization: str,
    g,
    T: int,
    *,
    circular_frequency: float = 0.5,
    xy_cycle_period: int = 5,
) -> KickSchedule:
    """Build the (T, K, 2) kick-angle schedule.

    ``g`` may be a scalar (fixed drive) or a length-T vector (time-dependent
    g, e.g. from the adaptive controller —
    autocorr-delta-a-single-qiskit-fast-g-optimization.py:200-245).
    """
    g = jnp.asarray(g, dtype=jnp.float64 if jnp.ones(()).dtype == jnp.float64 else jnp.float32)
    g = jnp.broadcast_to(g, (T,))
    K = n_kick_slots(polarization)
    t = jnp.arange(T, dtype=g.dtype)
    zeros = jnp.zeros((T,), dtype=g.dtype)
    pi = np.pi

    if polarization == "x":
        slots = [(pi * g, zeros)]
    elif polarization == "y":
        slots = [(zeros, pi * g)]
    elif polarization == "xy":
        slots = [(pi * g / 2, zeros), (zeros, pi * g / 2)]
    elif polarization == "yx":
        slots = [(zeros, pi * g / 2), (pi * g / 2, zeros)]
    elif polarization == "circular_left":
        w = circular_frequency
        slots = [
            (pi * g * jnp.cos(w * t) / np.sqrt(2), zeros),
            (zeros, pi * g * jnp.sin(w * t) / np.sqrt(2)),
        ]
    elif polarization == "circular_right":
        w = circular_frequency
        slots = [
            (pi * g * jnp.cos(w * t) / np.sqrt(2), zeros),
            (zeros, -pi * g * jnp.sin(w * t) / np.sqrt(2)),
        ]
    elif polarization == "circular_static":
        slots = [(pi * g / np.sqrt(2), zeros), (zeros, pi * g / np.sqrt(2))]
    elif polarization == "xy_cycle":
        # X for cycles [0,P), Y for [P,2P), ... — one slot, axis alternates.
        use_x = ((jnp.arange(T) // xy_cycle_period) % 2) == 0
        slots = [(jnp.where(use_x, pi * g, 0.0), jnp.where(use_x, 0.0, pi * g))]
    else:
        raise ValueError(f"unknown polarization {polarization!r}")

    assert len(slots) == K
    angles = jnp.stack([jnp.stack(s, axis=-1) for s in slots], axis=1)  # (T, K, 2)
    return KickSchedule(angles=angles)


def slot_unitary(theta_x, theta_y, dtype=jnp.complex64) -> jnp.ndarray:
    """2x2 unitary RY(theta_y) @ RX(theta_x) in closed form (one of the two
    angles is 0 per slot; closed form avoids a 2x2 matmul whose default
    precision may be reduced, which would corrupt the gate matrix)."""
    cx, sx = jnp.cos(theta_x / 2), jnp.sin(theta_x / 2)
    cy, sy = jnp.cos(theta_y / 2), jnp.sin(theta_y / 2)
    # RY = [[cy, -sy],[sy, cy]]; RX = [[cx, -i sx],[-i sx, cx]]
    m00 = cy * cx + 1j * (sy * sx)
    m01 = -1j * (cy * sx) - sy * cx
    m10 = sy * cx - 1j * (cy * sx)
    m11 = cy * cx - 1j * (sy * sx)
    return jnp.stack([jnp.stack([m00, m01]), jnp.stack([m10, m11])]).astype(dtype)


def slot_unitary_inverse(theta_x, theta_y, dtype=jnp.complex64) -> jnp.ndarray:
    """(RY(ty) RX(tx))^-1 = RX(-tx) RY(-ty), closed form (dagger of slot_unitary)."""
    u = slot_unitary(theta_x, theta_y, dtype)
    return jnp.conj(u).T
