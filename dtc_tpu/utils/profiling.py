"""Profiling & observability: phase timers, throughput reporting, jax traces.

The reference's tracing is wall-clock prints per phase
(autocorr-delta-a-single-qiskit-fast.py:230-237); here the same surface plus
a cycles/sec estimator (the BASELINE.json metric) and an optional
jax.profiler trace hook.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("dtc_tpu")


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    log.info("phase %-12s %8.3fs", name, dt)


@contextlib.contextmanager
def jax_trace(trace_dir: str | None):
    """Wrap a region in a jax.profiler trace when trace_dir is given."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def cycles_per_second(n_cycles: int, n_states: int, seconds: float) -> float:
    """Floquet cycle applications per second (the north-star metric)."""
    return n_cycles * n_states / max(seconds, 1e-12)
