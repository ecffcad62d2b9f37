"""Numerical sanitizers: NaN/Inf guards at every engine materialization.

The reference has no sanitizers at all (SURVEY.md §5 "Race detection /
sanitizers: none" — it drives a sequential C++ engine single-threaded).
Device work is asynchronous, so a fault can surface only at the next
materialization.  `guard()` materializes to host, scans for non-finite
values (and optionally a physical bound such as |A(t)| <= 1), and raises a
diagnostic `NumericalFault` naming the producing stage instead of silently
writing NaN rows into result CSVs.

Enabled by default (`DTC_TPU_VALIDATE=0` disables); cost is one
`np.isfinite` pass over data that was being copied to the host anyway.

For debugging the *inside* of a jitted program, `checked()` wraps a function
with `jax.experimental.checkify` float/NaN checks — the build's analogue of
a compute sanitizer.  Use it on the XLA sigma-engine paths on CPU where the
overhead is acceptable.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["NumericalFault", "guard", "validation_enabled", "checked"]


class NumericalFault(RuntimeError):
    """A guarded engine output contained NaN/Inf or violated its bound."""

    def __init__(self, name: str, message: str, *, n_bad: int,
                 first_index: tuple | None):
        super().__init__(f"{name}: {message}")
        self.name = name
        self.n_bad = n_bad
        self.first_index = first_index


def validation_enabled() -> bool:
    return os.environ.get("DTC_TPU_VALIDATE", "1") not in ("0", "false", "")


def guard(name: str, arr, *, bound: float | None = None,
          enabled: bool | None = None) -> np.ndarray:
    """Materialize `arr` to host and sanitize it.

    Returns the materialized ``np.ndarray`` so callers replace
    ``np.asarray(x)`` with ``guard("stage", x)`` at zero extra transfer cost.
    Raises :class:`NumericalFault` naming the producing stage when any
    element is non-finite, or when ``bound`` is given and ``|arr|`` exceeds
    it beyond a numerical tolerance (~1e-3 — see comment below).
    """
    out = np.asarray(arr)
    if enabled is None:
        enabled = validation_enabled()
    if not enabled or out.dtype.kind not in "fc":
        return out
    finite = np.isfinite(out)
    if out.dtype.kind == "c":
        finite = np.isfinite(out.real) & np.isfinite(out.imag)
    if not finite.all():
        n_bad = int(out.size - np.count_nonzero(finite))
        first = np.unravel_index(int(np.argmin(finite)), out.shape)
        raise NumericalFault(
            name, f"{n_bad}/{out.size} non-finite values "
            f"(first at index {tuple(int(i) for i in first)})",
            n_bad=n_bad, first_index=tuple(int(i) for i in first))
    if bound is not None:
        mag = np.abs(out)
        # The bound check catches device faults (garbage magnitudes), not
        # precision drift: reduced-precision matmuls (DTC_TPU_MATMUL_PRECISION
        # below highest) and float32 sums over 2^L amplitudes drift by up
        # to ~1e-4, so the tolerance sits above that or healthy saturated
        # runs (|A| = 1 at g=1.0) would raise.
        tol = bound * 1e-3 + 1e-6
        bad = mag > bound + tol
        if bad.any():
            n_bad = int(np.count_nonzero(bad))
            first = np.unravel_index(int(np.argmax(bad)), out.shape)
            raise NumericalFault(
                name, f"{n_bad}/{out.size} values exceed |x| <= {bound} "
                f"(max {float(mag.max()):.6g}, first at index "
                f"{tuple(int(i) for i in first)})",
                n_bad=n_bad, first_index=tuple(int(i) for i in first))
    return out


def checked(fn, *, errors=None):
    """Wrap `fn` with checkify NaN/div-by-zero instrumentation.

    Returns a callable with the same signature that raises
    :class:`NumericalFault` at the first in-trace NaN producer.  Intended
    for CPU debugging of the XLA engine paths (sigma/density); the wrapped
    function is checkify-transformed, so jit it *after* wrapping.
    """
    from jax.experimental import checkify as _checkify

    if errors is None:
        errors = _checkify.float_checks

    cfn = _checkify.checkify(fn, errors=errors)

    def run(*args, **kw):
        err, out = cfn(*args, **kw)
        try:
            _checkify.check_error(err)
        except Exception as e:  # checkify raises JaxRuntimeError subclasses
            raise NumericalFault("checkify", str(e), n_bad=-1,
                                 first_index=None) from e
        return out

    return run
