"""Device mesh construction.

The reference's only distributed hook is PennyLane-Lightning's `mpi=True`
(dtc_qasm.py:57-58, unused elsewhere); its simulation ceiling is single-GPU
Aer. Here multi-device is first-class: a 2-axis mesh

    ('traj', 'amp')

where 'traj' data-parallelizes noise trajectories / disorder instances
(embarrassingly parallel, no comms beyond the final mean) and 'amp' shards
the 2**L amplitudes across devices (the analogue of sequence/context
parallelism — SURVEY.md §2e). 'amp' collectives are pairwise ppermutes
(shard a <-> a XOR 2^b for a global qubit b); 'traj' only ever all-reduces
scalars. The cards of one host are joined all to all at one rate (NVLink),
so the mesh follows the algorithm alone: any device order serves.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_amp: int = 1, n_traj: int | None = None, devices=None) -> Mesh:
    """Mesh with shape (traj, amp); n_amp must be a power of two."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_amp & (n_amp - 1):
        raise ValueError("n_amp must be a power of two")
    if n_traj is None:
        n_traj = n_dev // n_amp
    if n_traj * n_amp > n_dev:
        raise ValueError(f"need {n_traj * n_amp} devices, have {n_dev}")
    grid = np.asarray(devices[: n_traj * n_amp]).reshape(n_traj, n_amp)
    return Mesh(grid, ("traj", "amp"))


def amp_bits(mesh: Mesh) -> int:
    return int(np.log2(mesh.shape["amp"]))
