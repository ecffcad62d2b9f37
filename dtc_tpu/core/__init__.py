"""Simulation engines: statevector, Floquet evolution, vectorized density matrix."""

from dtc_tpu.core.statevector import initial_statevector  # noqa: F401
from dtc_tpu.core.evolve import (  # noqa: F401
    autocorr_echo,
    autocorr_forward,
    evolve_observables,
    make_floquet_params,
)
