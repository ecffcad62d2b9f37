"""dtc_tpu — JAX framework for discrete-time-crystal (DTC) noise resilience
studies, run on an NVIDIA H100.

A ground-up re-design of the capabilities of the reference codebase
`Noise-Resilience-in-Discrete-Time-Crystal-Realizations-on-Quantum-Computers`
(kicked-Ising Floquet circuits simulated with Qiskit Aer; see
/root/reference/autocorr-delta-a-single-qiskit-fast.py) as an idiomatic
JAX/XLA library:

- statevector & vectorized density-matrix engines (`dtc_tpu.core`)
- fused gate layers (`dtc_tpu.ops`)
- kicked-Ising drive families & Aer-equivalent noise (`dtc_tpu.models`)
- amplitude-sharded multi-device simulation (`dtc_tpu.parallel`)
- experiment drivers, reference-compatible CSV IO, analysis/fits
  (`dtc_tpu.experiments`, `dtc_tpu.io`, `dtc_tpu.analysis`)
"""

__version__ = "0.1.0"

from dtc_tpu.utils.config import SimConfig  # noqa: F401
