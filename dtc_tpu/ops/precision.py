"""Matmul precision policy for state-evolution contractions.

On the GPU, float32 matmuls at DEFAULT or HIGH precision may run in TF32,
which keeps about three decimal digits — enough to visibly break the
unitarity of a Floquet evolution over tens of cycles. Quantum-state
contractions therefore default to HIGHEST (full float32).
Set `DTC_TPU_MATMUL_PRECISION=high` or `default` only for precision or
roofline experiments.
"""

from __future__ import annotations

import os

import jax

_LEVELS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}

_current = _LEVELS[os.environ.get("DTC_TPU_MATMUL_PRECISION", "highest").lower()]


def gate_precision():
    return _current


def set_gate_precision(level: str):
    global _current
    _current = _LEVELS[level.lower()]
