"""Multi-device (amplitude-sharded) experiment driver: statevector
trajectory ensembles past one card's memory (e.g. L=32 over four cards), the
capability the reference entirely lacks (its ceiling is single-GPU Aer;
SURVEY.md §6).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.experiments.autocorr import _raw_sqrt
from dtc_tpu.io import csvio, naming
from dtc_tpu.io.disorder import get_disorder
from dtc_tpu.models.drives import build_kick_schedule
from dtc_tpu.models.noise import NoiseSpec
from dtc_tpu.parallel.mesh import make_mesh
from dtc_tpu.utils.validation import guard
from dtc_tpu.parallel.sharded import (
    make_sharded_autocorr_forward,
    make_sharded_echo,
    make_sharded_observables,
)
from dtc_tpu.utils.profiling import phase_timer


def _auto_mesh(L: int, n_amp=None):
    n_dev = len(jax.devices())
    if n_amp is None:
        n_amp = 1
        while (n_amp * 2 <= n_dev and n_dev % (n_amp * 2) == 0
               and (1 << L) // (n_amp * 2) >= 2):
            n_amp *= 2
    return make_mesh(n_amp=n_amp, n_traj=n_dev // n_amp)


def run_autocorr_sharded(cfg, hs=None, phis=None, *, n_amp=None, mesh=None,
                         out_dir=None, disorder_dir=None, write=True,
                         with_echo=True, echo_ts=None) -> dict:
    """Forward (+echo) autocorrelator on an amplitude-sharded mesh.

    n_amp: amplitude shards (power of two; remaining devices become the
    trajectory axis). The 2**L statevector never exists on one device.
    """
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    if mesh is None:
        mesh = _auto_mesh(cfg.L, n_amp)
    noise = NoiseSpec(p=cfg.noise_p)
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    kw = dict(L=cfg.L, T=cfg.tf, K=sched.K, p=noise.p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state)
    # has_y engages the sigma-conjugated kick machinery for drives with a
    # Y component (required for correct noisy evolution)
    has_y = cfg.polarization != "x"
    fwd = make_sharded_autocorr_forward(mesh, has_y=has_y, **kw)

    n_traj = max(cfg.n_trajectories if noise.p > 0 else 1,
                 mesh.shape["traj"])
    n_traj -= n_traj % mesh.shape["traj"]

    autocorr = np.zeros((cfg.inst, cfg.tf))
    # p == 0: echo == 1 exactly (the noiseless U^dag U = I invariant), so
    # ones ARE the correct values everywhere. With noise, time points not
    # evaluated below (with_echo=False, or an echo_ts subset) must read as
    # NaN in the contract CSV — a fabricated 1.0 is indistinguishable from
    # a measured noise-free echo.
    echo = (np.ones((cfg.inst, cfg.tf)) if noise.p == 0
            else np.full((cfg.inst, cfg.tf), np.nan))
    key = jax.random.PRNGKey(cfg.seed)
    for i in range(cfg.inst):
        keys = jax.random.split(jax.random.fold_in(key, i), n_traj)
        with phase_timer(f"sharded forward inst {i}"):
            autocorr[i] = guard(
                "sharded_forward",
                fwd(sched.angles, jnp.asarray(hs[i][: cfg.L]),
                    jnp.asarray(phis[i][: cfg.L - 1]), keys), bound=1.0)
    if with_echo and noise.p > 0:
        ech = make_sharded_echo(mesh, has_y=has_y, **kw)
        ts = list(range(cfg.tf)) if echo_ts is None else list(echo_ts)
        for i in range(cfg.inst):
            keys = jax.random.split(jax.random.fold_in(key, 7919 + i), n_traj)
            for t in ts:
                echo[i, t] = float(guard(
                    "sharded_echo",
                    ech(sched.angles, jnp.asarray(hs[i][: cfg.L]),
                        jnp.asarray(phis[i][: cfg.L - 1]), keys,
                        jnp.asarray(t)), bound=1.0))

    av = autocorr.mean(axis=0)
    av_echo = echo.mean(axis=0)
    data = {
        "time": np.arange(cfg.tf),
        "av_autocorr": av,
        "av_autocorr_echo": av_echo,
        # raw sqrt like the reference's base schema (fast.py:263): a
        # negative trajectory-averaged echo records NaN, not a clamped 0
        "sqrt_av_autocorr_echo": _raw_sqrt(av_echo),
    }
    result = dict(data)
    result["mesh_shape"] = dict(mesh.shape)
    if write:
        folder = out_dir or f"autocorr_data_L{cfg.L}_sharded"
        path = os.path.join(folder, naming.autocorr_csv_name(cfg))
        csvio.write_columns(path, data)
        result["csv_path"] = path
    return result


def run_energy_sharded(cfg, hs=None, phis=None, *, n_amp=None, mesh=None,
                       nprobs=(0.0, 0.001, 0.01, 0.1), component="full",
                       out_dir=None, disorder_dir=None, write=True,
                       per_qubit_norm=True) -> dict:
    """Energy sweep E(t)/L on an amplitude-sharded mesh — the multi-device
    counterpart of experiments.energy.run_energy (reference energy path at
    autocorr-delta-a-single-qiskit-fast-energy.py:210-231 is single-GPU;
    this scales past one card's memory). Same CSV schema `time, energy_p_{p}`.
    """
    from dtc_tpu.models.hamiltonian import hamiltonian_terms

    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    if mesh is None:
        mesh = _auto_mesh(cfg.L, n_amp)
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    key = jax.random.PRNGKey(cfg.seed)
    data = {"time": np.arange(cfg.tf)}
    z_data = {}
    for p in nprobs:
        fn = make_sharded_observables(
            mesh, L=cfg.L, T=cfg.tf, K=sched.K, p=float(p),
            initial_state=cfg.initial_state)
        n_traj = max(cfg.n_trajectories if p > 0 else 1, mesh.shape["traj"])
        n_traj -= n_traj % mesh.shape["traj"]
        inst_e = np.zeros((cfg.inst, cfg.tf))
        acc_z = np.zeros((cfg.tf, cfg.L))
        with phase_timer(f"sharded energy p={p}"):
            for i in range(cfg.inst):
                terms = hamiltonian_terms(cfg.L, cfg.g, hs[i], phis[i], component)
                keys = jax.random.split(jax.random.fold_in(key, i), n_traj)
                e, zs = fn(sched.angles, jnp.asarray(hs[i][: cfg.L]),
                           jnp.asarray(phis[i][: cfg.L - 1]),
                           terms.hs, terms.phis,
                           jnp.asarray(float(terms.x_coeff)), keys)
                inst_e[i] = np.asarray(e)
                acc_z += np.asarray(zs)
        from dtc_tpu.experiments.energy import apply_estimator_noise

        # per-(instance, t) estimator sampling noise BEFORE the instance
        # mean — one estimator job per circuit, exactly like run_energy
        # (averaging first would shrink the emulated 1/sqrt(shots) error
        # by sqrt(inst) vs the unsharded path)
        av = apply_estimator_noise(inst_e, cfg.estimator_shots,
                                   seed=cfg.seed * 1000003 + int(p * 1e6)
                                   ).mean(axis=0)
        pkey = str(int(p)) if p == int(p) else str(p)
        data[f"energy_p_{pkey}"] = av / cfg.L if per_qubit_norm else av
        z_data[float(p)] = acc_z / cfg.inst
    result = dict(data)
    result["per_qubit_z"] = z_data
    result["mesh_shape"] = dict(mesh.shape)
    if write:
        folder = out_dir or f"energy-data_L{cfg.L}-sharded"
        path = os.path.join(folder, naming.energy_csv_name(cfg))
        csvio.write_columns(path, data)
        result["csv_path"] = path
    return result
