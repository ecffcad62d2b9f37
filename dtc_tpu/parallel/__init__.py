"""Multi-device simulation: device meshes + amplitude-sharded statevectors."""

from dtc_tpu.parallel.mesh import make_mesh  # noqa: F401
from dtc_tpu.parallel.sharded import (  # noqa: F401
    make_sharded_autocorr_forward,
    make_sharded_echo,
    make_sharded_observables,
)
