"""Energy sweep experiments.

Capability parity with autocorr-delta-a-single-qiskit-fast-energy.py
(SURVEY.md §3.2): E(t) = <H(t)> per noise level over nprobs=[0,0.001,0.01,0.1],
E/L normalization, CSV schema `time, energy_p_{p}`; component Hamiltonians
(full/z_only/zz_only/x_only/z_zz, ...-energy-ham-comparison.py:85-118); and
per-qubit <Z_i(t)> trajectories (dtc_qasm.py:109-126 parity).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.core.evolve import evolve_observables
from dtc_tpu.experiments.engine import build_context, resolve_dtype, traj_chunks
from dtc_tpu.io import csvio, naming
from dtc_tpu.io.disorder import get_disorder
from dtc_tpu.models.hamiltonian import hamiltonian_terms
from dtc_tpu.utils.validation import guard
from dtc_tpu.ops.diag import zz_z_diag_energy
from dtc_tpu.utils.profiling import phase_timer

DEFAULT_NPROBS = (0.0, 0.001, 0.01, 0.1)


def apply_estimator_noise(values: np.ndarray, shots: int,
                          seed: int = 0) -> np.ndarray:
    """Estimator shot-precision emulation: E -> E + N(0, 1/sqrt(shots)).

    The reference's hardware energy runners evaluate <H> with
    `BackendEstimatorV2(..., precision=1/sqrt(1024))`
    (autocorr-delta-a-single-ibm-energy.py:228-231,
    autocorr-delta-a-single-iqm-energy.py), so every recorded energy value
    carries gaussian sampling noise with that standard error. shots=0
    returns the exact expectations unchanged.
    """
    if not shots:
        return values
    rng = np.random.default_rng(seed)
    return values + rng.normal(0.0, 1.0 / np.sqrt(shots), np.shape(values))


import functools


@functools.partial(
    jax.jit,
    static_argnames=("L", "T", "K", "p", "with_x", "initial_state", "dtype_name"),
)
def _observables_batch(hs, phis, term_hs, term_phis, x_coeff, angles, keys, *,
                       L, T, K, p, with_x, initial_state, dtype_name):
    """Real-boundary batch: (inst,L),(inst,L-1),term arrays,(T,K,2),(inst,c,2)
    -> energies (inst, c, T), per-qubit Z (inst, c, T, L)."""
    from dtc_tpu.core.statevector import initial_statevector
    from dtc_tpu.experiments.engine import resolve_dtype
    from dtc_tpu.ops.diag import zz_z_phase_mask

    dtype = resolve_dtype(dtype_name)
    real_dt = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    psi0 = initial_statevector(L, initial_state, dtype=dtype)

    def per_instance(h, ph, th, tph, ks):
        diag = zz_z_phase_mask(h, ph, L, dtype=dtype)
        diag_e = zz_z_diag_energy(th, tph, L, dtype=real_dt)
        return jax.vmap(
            lambda k: evolve_observables(
                psi0, angles, diag, diag_e, x_coeff, k,
                L=L, T=T, K=K, p=p, with_x=with_x)
        )(ks)

    return jax.vmap(per_instance)(hs, phis, term_hs, term_phis, keys)


def _energy_single_noise(cfg, hs, phis, p, component="full"):
    """(inst, T) energies and (inst, T, L) per-qubit Z, trajectory-averaged,
    on the presampled XLA scan (core.evolve.evolve_observables)."""
    cfgp = cfg.replace(noise_prob=p, use_noise=1 if p > 0 else 0)
    sched, (hs_j, phis_j), noise = build_context(cfgp, hs, phis)

    terms0 = hamiltonian_terms(cfg.L, cfg.g, hs[0], phis[0], component)
    with_x = bool(float(terms0.x_coeff) != 0.0)
    term_hs = jnp.stack([
        hamiltonian_terms(cfg.L, cfg.g, hs[i], phis[i], component).hs
        for i in range(cfg.inst)])
    term_phis = jnp.stack([
        hamiltonian_terms(cfg.L, cfg.g, hs[i], phis[i], component).phis
        for i in range(cfg.inst)])
    x_coeff = jnp.asarray(float(terms0.x_coeff))

    n_traj = cfg.n_trajectories if noise.p > 0 else 1
    chunk = traj_chunks(n_traj, cfg.L, extra_factor=cfg.inst)
    ki = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.inst)
    acc_e = np.zeros((cfg.inst, cfg.tf))
    acc_z = np.zeros((cfg.inst, cfg.tf, cfg.L))
    done = 0
    while done < n_traj:
        c = min(chunk, n_traj - done)
        keys = jnp.stack([jax.random.split(jax.random.fold_in(k, done), c) for k in ki])
        e, zs = _observables_batch(
            hs_j, phis_j, term_hs, term_phis, x_coeff, sched.angles,
            keys, L=cfg.L, T=cfg.tf, K=sched.K, p=noise.p,
            with_x=with_x, initial_state=cfg.initial_state,
            dtype_name=cfg.dtype)
        acc_e += guard("energy_batch", jnp.sum(e, axis=1))
        acc_z += guard("perqubit_z_batch", jnp.sum(zs, axis=1), bound=float(c))
        done += c
    return acc_e / n_traj, acc_z / n_traj


def run_energy(cfg, hs=None, phis=None, *, nprobs=DEFAULT_NPROBS, component="full",
               out_dir=None, disorder_dir=None, write=True, per_qubit_norm=True,
               checkpoint_path=None) -> dict:
    """E(t)/L per noise probability; CSV `time, energy_p_{p}`.

    checkpoint_path: crash-safe journal — each completed noise level is
    persisted and skipped on resume (the counterpart of the reference's
    append-per-timestep hardware checkpointing, SURVEY.md §5)."""
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    journal = None
    if checkpoint_path:
        from dtc_tpu.utils.checkpoints import SweepJournal

        journal = SweepJournal(checkpoint_path)
    data = {"time": np.arange(cfg.tf)}
    z_data = {}
    # the journal key carries the FULL run identity — config knobs that
    # change the physics plus a digest of the actual disorder arrays —
    # so resuming a checkpoint with a changed g/tf/seed/drive (or freshly
    # drawn disorder) recomputes instead of silently returning stale
    # cached energies under the new config's labels
    import hashlib

    dig = hashlib.sha1(
        np.ascontiguousarray(np.asarray(hs, dtype=np.float64)).tobytes()
        + np.ascontiguousarray(np.asarray(phis, dtype=np.float64)).tobytes()
    ).hexdigest()[:10]
    ident = (f"L{cfg.L}_inst{cfg.inst}_g{cfg.g}_tf{cfg.tf}"
             f"_traj{cfg.n_trajectories}_pol{cfg.polarization}"
             f"_seed{cfg.seed}_init{cfg.initial_state}_d{dig}")
    for p in nprobs:
        jkey = f"energy_{component}_p{p}_{ident}"
        if journal is not None and jkey in journal:
            e = journal.get(jkey)
            zs = journal.get(jkey + "_z")
        else:
            with phase_timer(f"energy p={p}"):
                e, zs = _energy_single_noise(cfg, hs, phis, float(p), component)
            if journal is not None:
                journal.put(jkey, e)
                journal.put(jkey + "_z", zs)
        # per-(instance, t) estimator sampling noise, like one estimator job
        # per circuit in the reference's hardware loop
        e = apply_estimator_noise(e, cfg.estimator_shots,
                                  seed=cfg.seed * 1000003 + int(p * 1e6))
        av = e.mean(axis=0)
        data[f"energy_p_{_fmt(p)}"] = av / cfg.L if per_qubit_norm else av
        z_data[float(p)] = zs.mean(axis=0)  # (T, L)
    result = dict(data)
    result["per_qubit_z"] = z_data
    if write:
        folder = out_dir or naming.energy_folder_name(cfg)
        path = os.path.join(folder, naming.energy_csv_name(cfg))
        csvio.write_columns(path, data)
        result["csv_path"] = path
    return result


def run_ham_comparison(cfg, hs=None, phis=None, *, components=("full", "z_only",
                       "zz_only", "x_only", "z_zz"), nprob=None, out_dir=None,
                       disorder_dir=None, write=True) -> dict:
    """Component-Hamiltonian comparison
    (autocorr-delta-a-single-qiskit-fast-energy-ham-comparison.py:85-118)."""
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    p = cfg.noise_p if nprob is None else nprob
    data = {"time": np.arange(cfg.tf)}
    for ci, comp in enumerate(components):
        e, _ = _energy_single_noise(cfg, hs, phis, float(p), comp)
        e = apply_estimator_noise(e, cfg.estimator_shots,
                                  seed=cfg.seed * 1000003 + ci)
        data[f"energy_{comp}"] = e.mean(axis=0) / cfg.L
    if write:
        folder = out_dir or f"energy-data_L{cfg.L}-ham-comparison"
        path = os.path.join(folder, naming.energy_csv_name(cfg).replace(
            "energy_data_", "energy_ham_comparison_"))
        csvio.write_columns(path, data)
        data["csv_path"] = path
    return data


def run_per_qubit_z(cfg, hs=None, phis=None, *, out_dir=None, disorder_dir=None,
                    write=True) -> dict:
    """Per-qubit <Z_i(t)> sweep (QASM-export path parity, dtc_qasm.py:109-126)."""
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    e, zs = _energy_single_noise(cfg, hs, phis, cfg.noise_p, "full")
    av = zs.mean(axis=0)  # (T, L)
    data = {"time": np.arange(cfg.tf)}
    for q in range(cfg.L):
        data[f"z_q{q}"] = av[:, q]
    if write:
        folder = out_dir or f"zdata_L{cfg.L}"
        path = os.path.join(folder, f"per_qubit_z_{cfg.initial_state}_g{cfg.g}_L{cfg.L}"
                            f"_inst{cfg.inst}_noise{cfg.noise_prob}.csv")
        csvio.write_columns(path, data)
        data["csv_path"] = path
    return data


def _fmt(p: float) -> str:
    return str(int(p)) if p == int(p) else str(p)
