"""Shared sweep machinery: instance x trajectory batching with memory-aware
trajectory chunking.

Replaces the reference's serial python loops over disorder instances and time
points (autocorr-delta-a-single-qiskit-fast.py:217-239, O(inst*tf^2) rebuilt
circuits) with vmap axes over (instance, trajectory) around O(T) scans.

Every jitted entry point here takes real arrays (hs, phis, kick angles, PRNG
keys) and builds the complex statevector, phase masks and observables inside
the traced program, so 2**L amplitudes never exist on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.models.drives import build_kick_schedule
from dtc_tpu.models.noise import NoiseSpec
from dtc_tpu.utils.validation import guard


DEFAULT_BATCH_BYTES = 2 << 30  # ~2 GB of live state per chunk


def resolve_dtype(name: str):
    return {"complex64": jnp.complex64, "complex128": jnp.complex128}[name]


def traj_chunks(n_traj: int, L: int, extra_factor: int = 2,
                budget_bytes: int = DEFAULT_BATCH_BYTES) -> int:
    """Trajectories per chunk so live states stay under the HBM budget."""
    bytes_per_traj = extra_factor * (1 << L) * 8
    return max(1, min(n_traj, budget_bytes // max(1, bytes_per_traj)))


def build_context(cfg, hs, phis):
    """Per-run precomputation: kick schedule + real parameter arrays."""
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period,
    )
    hs = jnp.asarray(np.asarray(hs)[:, : cfg.L])
    phis = jnp.asarray(np.asarray(phis)[:, : cfg.L - 1])
    noise = NoiseSpec(p=cfg.noise_p)
    return sched, (hs, phis), noise


def _inst_keys(key, inst, salt, count):
    """(inst, count, 2) trajectory keys; ``salt`` is the chunk offset.

    Because the chunk offset folds into the key, the trajectory ensemble
    a sweep draws depends on its CHUNK BOUNDARIES (traj_chunks' state-bytes
    budget). Reproducibility per config is exact, but "trajectory-exact"
    comparisons between two runs must use a trajectory count both take in
    ONE chunk — mismatched chunking yields different (equally valid)
    ensembles that differ by sampling noise."""
    ki = jax.random.split(key, inst)
    return jnp.stack([jax.random.split(jax.random.fold_in(k, salt), count)
                      for k in ki])


def forward_sweep(cfg, sched, params, noise, key) -> np.ndarray:
    """A(t) per instance, trajectory-averaged: returns (inst, T)."""
    from dtc_tpu.core.sigma_evolve import sigma_forward_batch

    hs, phis = params
    p = noise.p
    af = noise.ancilla_factor if p > 0 else 1.0
    kw = dict(L=cfg.L, T=cfg.tf, K=sched.K, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af, has_y=cfg.polarization != "x")
    n_traj = cfg.n_trajectories if p > 0 else 1
    chunk = traj_chunks(n_traj, cfg.L, extra_factor=2 * cfg.inst)
    acc = np.zeros((cfg.inst, cfg.tf))
    done = 0
    while done < n_traj:
        c = min(chunk, n_traj - done)
        keys = _inst_keys(key, cfg.inst, done, c)
        vals = sigma_forward_batch(hs, phis, sched.angles, keys, **kw)
        acc += guard("forward_batch", jnp.sum(vals, axis=1), bound=float(c))
        done += c
    return guard("forward_sweep", acc / n_traj, bound=1.0)


def echo_sweep(cfg, sched, params, noise, key, *, t_chunk: int = 8) -> np.ndarray:
    """Echo A0(t) per instance, trajectory-averaged: (inst, T).

    Noiseless echo is exactly 1 (U^dag U = I) — returned analytically, which
    is also the reference's own self-validation invariant (SURVEY.md §4.1).
    """
    from dtc_tpu.core.sigma_evolve import sigma_echo_batch

    hs, phis = params
    p = noise.p
    if p == 0.0:
        return np.ones((cfg.inst, cfg.tf))
    kw = dict(L=cfg.L, T=cfg.tf, K=sched.K, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=noise.ancilla_factor,
              has_y=cfg.polarization != "x")
    n_traj = cfg.n_trajectories
    chunk = traj_chunks(n_traj, cfg.L, extra_factor=2 * cfg.inst * t_chunk)
    out = np.zeros((cfg.inst, cfg.tf))
    for t0 in range(0, cfg.tf, t_chunk):
        ts = np.arange(t0, min(t0 + t_chunk, cfg.tf))
        ts_pad = jnp.asarray(np.pad(ts, (0, t_chunk - len(ts)), mode="edge"))
        acc = np.zeros((cfg.inst, t_chunk))
        done = 0
        while done < n_traj:
            c = min(chunk, n_traj - done)
            keys = _inst_keys(key, cfg.inst, 7919 + done, c)
            vals = sigma_echo_batch(hs, phis, sched.angles, keys, ts_pad,
                                    **kw)
            acc += guard("echo_batch", jnp.sum(vals, axis=1), bound=float(c))
            done += c
        out[:, t0 : t0 + len(ts)] = (acc / n_traj)[:, : len(ts)]
    return guard("echo_sweep", out, bound=1.0)


def apply_shot_noise(values: np.ndarray, shots: int, seed: int = 0) -> np.ndarray:
    """Binomial measurement sampling: <Z> -> (2*Binom(shots, (1+A)/2)/shots - 1).

    Shot-noise studies (autocorr-delta-a-single-qiskit-fast-shots.py:48-49)
    sample the terminal measurement; trajectory noise is already in `values`.
    """
    rng = np.random.default_rng(seed)
    p0 = np.clip((1.0 + values) / 2.0, 0.0, 1.0)
    return 2.0 * rng.binomial(shots, p0) / shots - 1.0
