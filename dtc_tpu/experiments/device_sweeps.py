"""Device-noise sweep wrappers (use_fakebackend=1 mode, BASELINE config 4)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.core.device_evolve import device_autocorr_echo, device_autocorr_forward
from dtc_tpu.experiments.engine import _inst_keys, traj_chunks
from dtc_tpu.models.device_noise import fake_device_model
from dtc_tpu.utils.validation import guard


def _model(cfg):
    return fake_device_model(
        cfg.L, getattr(cfg, "fake_device", "brisbane"), seed=cfg.seed + 7,
        calibration_path=getattr(cfg, "calibration_path", None))


def device_forward_sweep(cfg, sched, params, key) -> np.ndarray:
    hs, phis = params
    model = _model(cfg)
    af = model.ancilla_interferometric_factor() * model.readout_z_factor(cfg.probe_qubit)
    p1 = jnp.asarray(model.p_1q)
    p2 = jnp.asarray(model.p_2q)
    if cfg.polarization == "x" and sched.K == 1:
        # gather-free sigma-frame device engine
        from dtc_tpu.core.device_evolve import device_sigma_forward_batch

        kw = dict(L=cfg.L, T=cfg.tf, q=cfg.probe_qubit,
                  initial_state=cfg.initial_state, dtype_name=cfg.dtype,
                  ancilla_factor=af)
        run = lambda h, ph, keys: device_sigma_forward_batch(
            h, ph, p1, p2, sched.angles, keys, **kw)
    else:
        # general drives (y/xy/yx/circular, K > 1): lab-frame gather engine
        kw = dict(L=cfg.L, T=cfg.tf, K=sched.K, q=cfg.probe_qubit,
                  initial_state=cfg.initial_state, dtype_name=cfg.dtype,
                  ancilla_factor=af)
        run = lambda h, ph, keys: device_autocorr_forward(
            h, ph, p1, p2, sched.angles, keys, **kw)
    # instances ride a vmap axis like engine.forward_sweep (the reference's
    # serial per-instance loop is the O(inst) structure we replace —
    # autocorr-delta-a-single-qiskit-fast.py:228-239); the chunker budgets
    # the inst x traj live-state product
    run_v = jax.vmap(run, in_axes=(0, 0, 0))
    hs_j = jnp.asarray(np.asarray(hs)[:, : cfg.L])
    phis_j = jnp.asarray(np.asarray(phis)[:, : cfg.L - 1])
    n_traj = cfg.n_trajectories
    chunk = traj_chunks(n_traj, cfg.L, extra_factor=2 * cfg.inst)
    out = np.zeros((cfg.inst, cfg.tf))
    done = 0
    while done < n_traj:
        c = min(chunk, n_traj - done)
        # per-instance keys are SPLIT before the chunk salt folds in
        # (engine._inst_keys): folding 31*i + done directly would alias
        # instance and chunk offsets (inst 0 at done=31 == inst 1 at
        # done=0), silently correlating the disorder-instance ensembles
        keys = _inst_keys(key, cfg.inst, done, c)
        out += guard("device_forward_sweep",
                     np.asarray(jnp.sum(run_v(hs_j, phis_j, keys), axis=1)),
                     bound=float(c))
        done += c
    return out / n_traj


def device_echo_sweep(cfg, sched, params, key, *, t_chunk: int = 4) -> np.ndarray:
    """Device-noise echo A0(t) sweep. Engine dispatch mirrors
    device_forward_sweep: x-polarized K=1 drives run the gather-free
    sigma-frame echo engine (core.device_evolve.device_sigma_echo_batch),
    general drives the lab-frame gather engine (device_autocorr_echo)."""
    hs, phis = params
    model = _model(cfg)
    af = model.ancilla_interferometric_factor() * model.readout_z_factor(cfg.probe_qubit)
    p1 = jnp.asarray(model.p_1q)
    p2 = jnp.asarray(model.p_2q)
    n_traj = cfg.n_trajectories
    hs_j = jnp.asarray(np.asarray(hs)[:, : cfg.L])
    phis_j = jnp.asarray(np.asarray(phis)[:, : cfg.L - 1])
    out = np.zeros((cfg.inst, cfg.tf))

    if cfg.polarization == "x" and sched.K == 1:
        from dtc_tpu.core.device_evolve import device_sigma_echo_batch

        kw = dict(L=cfg.L, T=cfg.tf, q=cfg.probe_qubit,
                  initial_state=cfg.initial_state, dtype_name=cfg.dtype,
                  ancilla_factor=af)
        run_v = jax.vmap(
            lambda h, ph, keys, ts: device_sigma_echo_batch(
                h, ph, p1, p2, sched.angles, keys, ts, **kw),
            in_axes=(0, 0, 0, None))
        ts_all = jnp.arange(cfg.tf)  # t=0 rows measure the init state (= af)
        chunk = max(1, traj_chunks(n_traj, cfg.L,
                                   extra_factor=2 * cfg.inst * cfg.tf))
        done = 0
        while done < n_traj:
            c = min(chunk, n_traj - done)
            keys = _inst_keys(key, cfg.inst, 7919 + done, c)
            out += guard(
                "device_echo_sweep",
                np.asarray(jnp.sum(run_v(hs_j, phis_j, keys, ts_all),
                                   axis=1)),  # (inst, c, tf) -> (inst, tf)
                bound=float(c))
            done += c
        return out / n_traj

    kw = dict(L=cfg.L, T=cfg.tf, K=sched.K, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af)
    chunk = traj_chunks(n_traj, cfg.L, extra_factor=4 * cfg.inst * t_chunk)
    # vmap axes: t-chunk inner, instance outer (mirrors engine.echo_sweep)
    run = jax.jit(jax.vmap(jax.vmap(
        lambda h, ph, keys, t: device_autocorr_echo(h, ph, p1, p2,
                                                    sched.angles, keys, t, **kw),
        in_axes=(None, None, None, 0)), in_axes=(0, 0, 0, None)))
    for t0 in range(0, cfg.tf, t_chunk):
        ts = np.arange(t0, min(t0 + t_chunk, cfg.tf))
        ts_pad = jnp.asarray(np.pad(ts, (0, t_chunk - len(ts)), mode="edge"))
        acc = np.zeros((cfg.inst, t_chunk))
        done = 0
        while done < n_traj:
            c = min(chunk, n_traj - done)
            keys = _inst_keys(key, cfg.inst, 7919 + done, c)
            vals = run(hs_j, phis_j, keys, ts_pad)  # (inst, t_chunk, c)
            acc += guard("device_echo_sweep_gather",
                         np.asarray(jnp.sum(vals, axis=2)), bound=float(c))
            done += c
        out[:, t0 : t0 + len(ts)] = (acc / n_traj)[:, : len(ts)]
    return out
