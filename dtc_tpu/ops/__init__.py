"""Gate-application layers for statevector simulation."""

from dtc_tpu.ops.gates import (  # noqa: F401
    apply_1q,
    apply_2q,
    apply_diag,
    apply_gate_layer,
    expect_x,
    expect_z,
    probabilities_bit,
)
from dtc_tpu.ops.kick import apply_uniform_1q_layer, kron_power  # noqa: F401
from dtc_tpu.ops.paulis import (  # noqa: F401
    PAULIS,
    apply_pauli_string,
    pauli_string_masks,
)
from dtc_tpu.ops.diag import zz_z_diag_energy, zz_z_phase_mask  # noqa: F401
from dtc_tpu.ops.precision import gate_precision, set_gate_precision  # noqa: F401
