"""Adaptive-g control experiments (real-time feedback, optimizer, batch).

Capability parity with autocorr-delta-a-single-qiskit-fast-g-optimization.py
and ...-fast-controlled-g.py (SURVEY.md §3.3, C12-C14):

- real-time causal loop: at cycle t run forward+echo with the accumulated
  per-cycle g schedule, then choose g(t+1) by linear/exponential feedback or
  by bounded scalar optimization of (echo - target)^2;
- batch (non-causal) control: full echo trajectory -> adjust whole schedule ->
  re-run forward;
- fixed-g comparison runs.

Re-design: the reference re-simulates every circuit from t=0 (objective
eval = full 2(t+1)-cycle Aer run; O(inst*tf^2*evals) total,
g-optimization.py:377-390). Here the causal forward state (a batch of noise
trajectories) is CARRIED: one step advances it by a single cycle, and an echo
evaluation applies masked inverse cycles from the carried state, so an
optimizer eval costs O(t) fused cycle applications on-device with no
recompilation (t is a traced scalar; one jitted program serves every step).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.core.evolve import _branch_autocorr, _branch_pair, forward_cycle, inverse_cycle
from dtc_tpu.core.statevector import initial_statevector
from dtc_tpu.experiments.engine import build_context, resolve_dtype
from dtc_tpu.io import csvio, naming
from dtc_tpu.io.disorder import get_disorder
from dtc_tpu.models.drives import build_kick_schedule, n_kick_slots, slot_unitary_inverse
from dtc_tpu.models.noise import NoiseSpec
from dtc_tpu.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu.utils.validation import guard
from dtc_tpu.ops.kick import apply_uniform_1q_layer
from dtc_tpu.core.evolve import _noise_layer


# ---------------------------------------------------------------------------
# feedback laws (pure math; g-optimization.py:429-475 semantics)


def linear_g_adjustment(echo_val, target_echo, current_g, feedback_gain, g_min, g_max):
    return float(np.clip(current_g + feedback_gain * (target_echo - echo_val),
                         g_min, g_max))


def exponential_g_adjustment(echo_val, target_echo, current_g, time_step,
                             feedback_gain, decay_compensation, g_min, g_max):
    """Exponential-compensation feedback: gain scaled by exp(decay*t), plus a
    log-ratio amplification term for small echo, the combined adjustment
    rescaled by (1 + decay*t)."""
    echo_error = target_echo - echo_val
    time_factor = np.exp(decay_compensation * time_step)
    exp_adj = feedback_gain * echo_error * time_factor
    if echo_val > 0.01:
        log_adj = feedback_gain * 0.1 * (np.log(target_echo / echo_val)
                                         if echo_val < target_echo else 0.0)
    else:
        log_adj = feedback_gain * 2.0
    total = (exp_adj + log_adj) * (1.0 + decay_compensation * time_step)
    return float(np.clip(current_g + total, g_min, g_max))


def adjust_g_schedule(echo_values, g_values, target_echo, feedback_gain, g_min, g_max):
    """Batch (non-causal) whole-schedule adjustment from the previous echo
    trajectory (g-optimization.py:345-357): g[t] += gain*(target-echo[t-1])."""
    new_g = np.array(g_values, dtype=float)
    for t in range(1, len(echo_values)):
        new_g[t] = np.clip(
            g_values[t] + feedback_gain * (target_echo - echo_values[t - 1]),
            g_min, g_max,
        )
    return new_g


# ---------------------------------------------------------------------------
# carried-state stepper


class AdaptiveStepper:
    """Carries trajectory-batched branch states through a per-cycle g schedule.

    States shape: (n_traj, 2, 2**L). All device work happens in three jitted
    programs shared across the whole run: advance-one-cycle, measure-forward,
    and echo-eval (inverse masked scan from the carried state).
    """

    def __init__(self, cfg, hs_row, phis_row, *, n_traj=None):
        self.cfg = cfg
        self.L = cfg.L
        self.T = cfg.tf
        self.K = n_kick_slots(cfg.polarization)
        self.p = cfg.noise_p
        self.q = cfg.probe_qubit
        self.dtype = resolve_dtype(cfg.dtype)
        self.noise = NoiseSpec(p=self.p)
        self.af = self.noise.ancilla_factor if self.p > 0 else 1.0
        self.n_traj = n_traj or (cfg.n_trajectories if self.p > 0 else 1)
        # complex buffers are built on the device via jit from real inputs,
        # then passed between jitted programs as explicit arguments.
        L, dtype, n_tr = self.L, self.dtype, self.n_traj
        init_state, q = cfg.initial_state, self.q

        @jax.jit
        def _make_diag(h, ph):
            return zz_z_phase_mask(h, ph, L, dtype=dtype)

        @jax.jit
        def _make_state0():
            zq = z_sign_mask(q, L)
            psi0 = initial_statevector(L, init_state, dtype=dtype)
            single = _branch_pair(psi0, zq)
            return jnp.broadcast_to(single, (n_tr,) + single.shape)

        self.diag = _make_diag(jnp.asarray(hs_row[: self.L]),
                               jnp.asarray(phis_row[: self.L - 1]))
        self.zq = z_sign_mask(self.q, self.L)
        self.state0 = _make_state0()
        self._build_programs()

    def _angles_for(self, g_schedule):
        sched = build_kick_schedule(
            self.cfg.polarization, jnp.asarray(g_schedule), self.T,
            circular_frequency=self.cfg.circular_frequency,
            xy_cycle_period=self.cfg.xy_cycle_period,
        )
        return sched.angles  # (T, K, 2)

    def _build_programs(self):
        L, K, p, dtype, T = self.L, self.K, self.p, self.dtype, self.T
        zq, af = self.zq, self.af

        @jax.jit
        def advance(states, diag, angles_t, key):
            keys = jax.random.split(key, states.shape[0])
            return jax.vmap(
                lambda s, k: forward_cycle(s, angles_t, diag, L=L, K=K, p=p,
                                           key=k, dtype=dtype)
            )(states, keys)

        @jax.jit
        def measure(states):
            vals = jax.vmap(lambda s: _branch_autocorr(s, zq, af))(states)
            return jnp.mean(vals)

        def _echo_one(state, diag, angles, key, t_next):
            # state: branch pair AFTER t_next forward cycles; apply t_next
            # inverse cycles in reverse time order (masked fixed-length scan).
            keys = jax.random.split(key, T)

            def body(carry, inp):
                k, key_k = inp
                active = k < t_next
                idx = jnp.clip(t_next - 1 - k, 0, T - 1)
                ang = angles[idx]
                s = jnp.where(active, jnp.conj(diag), jnp.ones((), dtype)) * carry
                for pos in range(K - 1, -1, -1):
                    u_i = slot_unitary_inverse(ang[pos, 0], ang[pos, 1], dtype)
                    u = jnp.where(active, u_i, jnp.eye(2, dtype=dtype))
                    s = apply_uniform_1q_layer(s, u, L)
                    if p > 0.0:
                        s = _noise_layer(s, jax.random.fold_in(key_k, pos), p, L,
                                         active=active)
                return s, None

            state, _ = jax.lax.scan(body, state, (jnp.arange(T), keys))
            return _branch_autocorr(state, zq, af)

        @jax.jit
        def echo_eval(states, diag, angles_last, angles_full, key, t_next):
            # advance carried states one cycle with candidate angles, then
            # inverse-evolve; returns trajectory-mean echo at t_next cycles.
            keys = jax.random.split(key, states.shape[0] * 2).reshape(
                states.shape[0], 2, 2)

            def one(s, ks):
                s = forward_cycle(s, angles_last, diag, L=L, K=K, p=p,
                                  key=ks[0], dtype=dtype)
                return _echo_one(s, diag, angles_full, ks[1], t_next)

            return jnp.mean(jax.vmap(one)(states, keys))

        self._advance = advance
        self._measure = measure
        self._echo_eval = echo_eval

    # public API -----------------------------------------------------------
    def reset(self):
        return self.state0

    def advance(self, states, g_value, time_step, key):
        angles = self._angles_for(jnp.full((self.T,), g_value))[time_step]
        return self._advance(states, self.diag, angles, key)

    def forward_value(self, states) -> float:
        return float(self._measure(states))

    def echo_value(self, states_prev, g_schedule, g_last, t_next, key) -> float:
        """Echo at t_next cycles: carried states_prev (after t_next-1 cycles) +
        one cycle at g_last + t_next reversed inverse cycles."""
        g_full = np.array(g_schedule, dtype=float)
        g_full[t_next - 1] = g_last
        angles_full = self._angles_for(jnp.asarray(g_full))
        angles_last = angles_full[t_next - 1]
        return float(self._echo_eval(states_prev, self.diag, angles_last,
                                     angles_full, key, jnp.asarray(t_next)))


class KernelAdaptiveStepper:
    """Schedule-sweep stepper on the whole-trajectory batchers.

    Same public API as AdaptiveStepper, but `states` is just the number of
    applied cycles: every query re-evolves from t=0 through the accumulated
    per-cycle g schedule via the sigma engine's whole-trajectory batchers.
    Total work is O(T^2) cycle applications like the reference's
    rebuild-per-step loop (g-optimization.py:497-623).

    Noise trajectories ride FIXED per-instance keys (common random numbers):
    every optimizer candidate g sees the same presampled Pauli strings, so
    the echo objective is deterministic in g — smoother to minimize than the
    carried stepper's per-call resampling.
    """

    def __init__(self, cfg, hs_row, phis_row, *, n_traj=None, key=None):
        self.cfg = cfg
        self.T = cfg.tf
        self.K = n_kick_slots(cfg.polarization)
        self.p = NoiseSpec(p=cfg.noise_p).p
        self.af = NoiseSpec(p=cfg.noise_p).ancilla_factor if self.p > 0 else 1.0
        self.n_traj = n_traj or (cfg.n_trajectories if self.p > 0 else 1)
        key = jax.random.PRNGKey(cfg.seed) if key is None else key
        kf, ke = jax.random.split(key)
        self._keys_f = jax.random.split(kf, self.n_traj)[None]
        self._keys_e = jax.random.split(ke, self.n_traj)[None]
        self._h = jnp.asarray(np.asarray(hs_row)[: cfg.L])[None]
        self._ph = jnp.asarray(np.asarray(phis_row)[: cfg.L - 1])[None]
        self._g = np.full(self.T + 1, cfg.g, dtype=float)
        self._kw = dict(L=cfg.L, T=self.T + 1, K=self.K, p=self.p,
                        q=cfg.probe_qubit, initial_state=cfg.initial_state,
                        dtype_name=cfg.dtype, ancilla_factor=self.af,
                        has_y=cfg.polarization != "x")

    def _angles(self, g_schedule):
        sched = build_kick_schedule(
            self.cfg.polarization, jnp.asarray(g_schedule), self.T + 1,
            circular_frequency=self.cfg.circular_frequency,
            xy_cycle_period=self.cfg.xy_cycle_period)
        return np.asarray(sched.angles)

    # public API (AdaptiveStepper-compatible) ------------------------------
    def reset(self):
        self._g[:] = self.cfg.g
        return 0

    def advance(self, states, g_value, time_step, key):
        self._g[time_step] = g_value
        return states + 1

    def forward_value(self, states) -> float:
        from dtc_tpu.core.sigma_evolve import sigma_forward_batch

        vals = sigma_forward_batch(self._h, self._ph, self._angles(self._g),
                              self._keys_f, **self._kw)
        return float(jnp.mean(vals[0, :, states]))

    def echo_value(self, states_prev, g_schedule, g_last, t_next, key) -> float:
        from dtc_tpu.core.sigma_evolve import sigma_echo_batch

        g_full = np.array(self._g)
        g_full[: len(g_schedule)] = g_schedule
        g_full[t_next - 1] = g_last
        vals = sigma_echo_batch(self._h, self._ph, self._angles(g_full),
                           self._keys_e, jnp.asarray([t_next]), **self._kw)
        return float(jnp.mean(vals[0, :, 0]))


def make_stepper(cfg, hs_row, phis_row, *, n_traj=None, key=None):
    """Pick the stepper implementation: the carried-state AdaptiveStepper,
    or the rerun KernelAdaptiveStepper when DTC_TPU_ADAPTIVE=kernel."""
    mode = os.environ.get("DTC_TPU_ADAPTIVE", "auto")
    if mode == "kernel":
        return KernelAdaptiveStepper(cfg, hs_row, phis_row, n_traj=n_traj,
                                     key=key)
    return AdaptiveStepper(cfg, hs_row, phis_row, n_traj=n_traj)


# ---------------------------------------------------------------------------
# optimizers (g-optimization.py:359-427)


def golden_section_minimize(f, lo, hi, iters=20):
    """Fixed-iteration golden-section minimizer (deterministic, jit-friendly
    replacement for scipy's bounded Brent; behavioral — not bitwise — parity)."""
    invphi = (np.sqrt(5) - 1) / 2
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    return (a + b) / 2


def grid_search_minimize(f, lo, hi, num_points=10):
    gs = np.linspace(lo, hi, num_points)
    vals = [f(g) for g in gs]
    return float(gs[int(np.argmin(vals))])


def optimize_g_for_target_echo(stepper, states_prev, g_schedule, t, target_echo,
                               g_min, g_max, key, *, method="bounded", iters=20):
    """argmin_g (echo(t+1; g_hist[0..t-1] + [g]) - target)^2."""

    def objective(g_cand):
        e = stepper.echo_value(states_prev, g_schedule, float(g_cand), t + 1, key)
        return (e - target_echo) ** 2

    if method == "bounded":
        from scipy.optimize import minimize_scalar

        res = minimize_scalar(objective, bounds=(g_min, g_max), method="bounded")
        if res.success:
            return float(res.x)
        return grid_search_minimize(objective, g_min, g_max)
    if method == "golden":
        return float(golden_section_minimize(objective, g_min, g_max, iters))
    return grid_search_minimize(objective, g_min, g_max)


# ---------------------------------------------------------------------------
# drivers


def run_adaptive_realtime(cfg, hs=None, phis=None, *, out_dir=None,
                          disorder_dir=None, write=True,
                          optimizer_method="golden",
                          realtime_csv: bool = False,
                          compare_g_high: float = 0.97) -> dict:
    """Real-time causal adaptive-g loop + fixed-g standard comparison.

    Per reference convention the row at time index t corresponds to t+1
    applied cycles (g-optimization.py:541-545). With realtime_csv, each
    completed timestep is appended+flushed to a per-instance CSV (the
    reference's hardware checkpointing pattern,
    autocorr-delta-a-single-ibm-energy.py:239-255).
    """
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    T = cfg.tf
    all_fwd, all_echo, all_g = [], [], []
    for i in range(cfg.inst):
        rt_writer = None
        if realtime_csv and write:
            from dtc_tpu.io.csvio import RealtimeCSVWriter

            folder = out_dir or f"controlled-autocorr_data_L{cfg.L}"
            # resume=False: this loop always recomputes from t=0, so a
            # rerun must overwrite, not append duplicate rows
            rt_writer = RealtimeCSVWriter(
                os.path.join(folder, f"adaptive_realtime_inst{i+1}_"
                             + naming.adaptive_csv_name(cfg)),
                ["time", "g", "forward", "echo"], resume=False)
        key = jax.random.PRNGKey(cfg.seed + 101 * i)
        stepper = make_stepper(cfg, hs[i], phis[i], key=key)
        states_prev = stepper.reset()
        g_schedule = np.full(T, cfg.g)
        current_g = cfg.g
        fwd, ech, ghist = [], [], []
        for t in range(T):
            g_schedule[t] = current_g
            ghist.append(current_g)
            k_adv, k_echo, k_opt, key = jax.random.split(key, 4)
            states = stepper.advance(states_prev, current_g, t, k_adv)
            fwd.append(stepper.forward_value(states))
            ech.append(stepper.echo_value(states_prev, g_schedule, current_g,
                                          t + 1, k_echo))
            if rt_writer is not None:
                rt_writer.write_row({"time": t, "g": float(current_g),
                                     "forward": fwd[-1], "echo": ech[-1]})
            if t < T - 1:
                if cfg.use_optimization:
                    current_g = optimize_g_for_target_echo(
                        stepper, states_prev, g_schedule, t, cfg.target_echo,
                        cfg.g_min, cfg.g_max, k_opt, method=optimizer_method,
                        iters=max(cfg.optimization_iterations * 3, 12),
                    )
                elif cfg.exponential_feedback:
                    current_g = exponential_g_adjustment(
                        ech[-1], cfg.target_echo, current_g, t,
                        cfg.feedback_gain, cfg.decay_compensation,
                        cfg.g_min, cfg.g_max)
                else:
                    current_g = linear_g_adjustment(
                        ech[-1], cfg.target_echo, current_g,
                        cfg.feedback_gain, cfg.g_min, cfg.g_max)
            states_prev = states
        if rt_writer is not None:
            rt_writer.close()
        all_fwd.append(fwd)
        all_echo.append(ech)
        all_g.append(ghist)

    all_fwd = np.asarray(all_fwd)
    all_echo = np.asarray(all_echo)
    all_g = np.asarray(all_g)

    # fixed-g standard comparisons (same seeds): the initial g AND the
    # reference's hardcoded high comparison g=0.97 — its output schema
    # labels these g84/g97 regardless of the actual g_initial
    # (controlled-g.py:614-637,665-677; g-optimization.py:816-832)
    std = run_fixed_g(cfg, hs, phis)
    std97 = run_fixed_g(cfg, hs, phis, g_value=compare_g_high)

    av_fwd_a = all_fwd.mean(axis=0)
    av_echo_a = all_echo.mean(axis=0)
    av_fwd_84 = std["forward"].mean(axis=0)
    av_echo_84 = std["echo"].mean(axis=0)
    av_fwd_97 = std97["forward"].mean(axis=0)
    av_echo_97 = std97["echo"].mean(axis=0)
    data = {
        "time": np.arange(T),
        "av_autocorr_adaptive": av_fwd_a,
        "av_autocorr_echo_adaptive": av_echo_a,
        "av_g_values": all_g.mean(axis=0),
        "av_autocorr_standard": av_fwd_84,
        "av_autocorr_echo_standard": av_echo_84,
        "av_autocorr_standard_g84": av_fwd_84,
        "av_autocorr_echo_standard_g84": av_echo_84,
        "av_autocorr_standard_g97": av_fwd_97,
        "av_autocorr_echo_standard_g97": av_echo_97,
        # sqrt columns use sqrt(|x|) like every extant reference adaptive
        # schema (controlled-g.py:675-677, g-optimization.py:766-768);
        # the plain *_standard names survive from the older script version
        # whose shipped L4 CSVs the parity tests replay
        "sqrt_av_autocorr_echo_adaptive": np.sqrt(np.abs(av_echo_a)),
        "sqrt_av_autocorr_echo_standard": np.sqrt(np.abs(av_echo_84)),
        "sqrt_av_autocorr_echo_standard_g84": np.sqrt(np.abs(av_echo_84)),
        "sqrt_av_autocorr_echo_standard_g97": np.sqrt(np.abs(av_echo_97)),
    }
    # envelope columns (window_size=3, controlled-g.py:647-653,681-697)
    from dtc_tpu.analysis.envelope import find_envelope

    for label, f_sig, e_sig in (("adaptive", av_fwd_a, av_echo_a),
                                ("g84", av_fwd_84, av_echo_84),
                                ("g97", av_fwd_97, av_echo_97)):
        uf, lf = find_envelope(f_sig, window_size=3)
        ue, le = find_envelope(e_sig, window_size=3)
        data[f"upper_env_{label}_forward"] = uf
        data[f"lower_env_{label}_forward"] = lf
        data[f"upper_env_{label}_echo"] = ue
        data[f"lower_env_{label}_echo"] = le
    for i in range(cfg.inst):
        data[f"g_history_inst{i+1}"] = all_g[i]
        data[f"echo_adaptive_inst{i+1}"] = all_echo[i]
        data[f"forward_adaptive_inst{i+1}"] = all_fwd[i]
        data[f"echo_standard_g84_inst{i+1}"] = std["echo"][i]
        data[f"forward_standard_g84_inst{i+1}"] = std["forward"][i]
        data[f"echo_standard_g97_inst{i+1}"] = std97["echo"][i]
        data[f"forward_standard_g97_inst{i+1}"] = std97["forward"][i]

    result = dict(data)
    result.update(g_history=all_g, echo=all_echo, forward=all_fwd)
    if write:
        folder = out_dir or f"controlled-autocorr_data_L{cfg.L}"
        path = os.path.join(folder, naming.adaptive_csv_name(cfg))
        csvio.write_columns(path, data)
        ghist_cols = {}
        for i in range(cfg.inst):
            ghist_cols[f"inst{i+1}_g_values"] = all_g[i]
            ghist_cols[f"inst{i+1}_echo_values"] = all_echo[i]
        gpath = os.path.join(folder, naming.g_history_csv_name(cfg))
        csvio.write_columns(gpath, ghist_cols)
        # separate adaptive-vs-fixed comparison file
        # (controlled-g.py:719-737, shipped in controlled-autocorr_data_L20/)
        comp = {
            "time": np.arange(T),
            "av_g_values": all_g.mean(axis=0),
            "av_echo_adaptive": av_echo_a,
            "av_echo_g84": av_echo_84,
            "av_echo_g97": av_echo_97,
            "av_forward_adaptive": av_fwd_a,
            "av_forward_g84": av_fwd_84,
            "av_forward_g97": av_fwd_97,
        }
        for i in range(cfg.inst):
            comp[f"inst{i+1}_g_values"] = all_g[i]
            comp[f"inst{i+1}_echo_adaptive"] = all_echo[i]
            comp[f"inst{i+1}_echo_g84"] = std["echo"][i]
            comp[f"inst{i+1}_echo_g97"] = std97["echo"][i]
        cpath = os.path.join(folder, naming.adaptive_comparison_csv_name(cfg))
        csvio.write_columns(cpath, comp)
        result["csv_path"] = path
        result["g_history_csv_path"] = gpath
        result["comparison_csv_path"] = cpath
    return result


def run_fixed_g(cfg, hs, phis, g_value=None) -> dict:
    """Fixed-g forward+echo with the t+1-cycle row convention.

    Whole-sweep engine batcher calls (one forward scan + one echo sweep per
    instance) instead of T carried steps — the schedule is constant, so the
    O(T) scan covers every row at once.
    """
    from dtc_tpu.core.sigma_evolve import sigma_echo_batch, sigma_forward_batch

    g = cfg.g if g_value is None else g_value
    T = cfg.tf
    noise = NoiseSpec(p=cfg.noise_p)
    p = noise.p
    af = noise.ancilla_factor if p > 0 else 1.0
    n_traj = cfg.n_trajectories if p > 0 else 1
    sched = build_kick_schedule(
        cfg.polarization, g, T + 1,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    kw = dict(L=cfg.L, T=T + 1, K=sched.K, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af, has_y=cfg.polarization != "x")
    fwd = np.zeros((cfg.inst, T))
    ech = np.zeros((cfg.inst, T))
    for i in range(cfg.inst):
        h = jnp.asarray(np.asarray(hs[i])[: cfg.L])[None]
        ph = jnp.asarray(np.asarray(phis[i])[: cfg.L - 1])[None]
        kf, ke = jax.random.split(jax.random.PRNGKey(cfg.seed + 977 * i))
        keys_f = jax.random.split(kf, n_traj)[None]
        keys_e = jax.random.split(ke, n_traj)[None]
        f = guard("fixed_g_forward", sigma_forward_batch(
            h, ph, sched.angles, keys_f, **kw)).mean(axis=1)[0]
        fwd[i] = f[1:]  # row t = A(t+1)
        e = guard("fixed_g_echo", sigma_echo_batch(
            h, ph, sched.angles, keys_e, jnp.arange(1, T + 1),
            **kw)).mean(axis=1)[0]
        ech[i] = e
    return {"forward": fwd, "echo": ech}


def run_adaptive_batch(cfg, hs=None, phis=None, *, out_dir=None,
                       disorder_dir=None, write=True) -> dict:
    """Non-causal batch control (C14, g-optimization.py:625-669): echo pass
    with the initial schedule, whole-schedule feedback adjustment, forward
    re-run with the adjusted schedule."""
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    T = cfg.tf
    noise = NoiseSpec(p=cfg.noise_p)
    p = noise.p
    af = noise.ancilla_factor if p > 0 else 1.0
    n_traj = cfg.n_trajectories if p > 0 else 1
    all_fwd, all_echo, all_g = [], [], []
    from dtc_tpu.core.sigma_evolve import sigma_echo_batch, sigma_forward_batch

    def schedule_angles(schedule):
        # per-cycle x-kick angles (T, 1, 2): theta_x = pi * g_t
        ang = np.zeros((T, 1, 2), dtype=np.float32)
        ang[:, 0, 0] = np.pi * np.asarray(schedule)
        return jnp.asarray(ang)

    kw = dict(L=cfg.L, T=T, K=1, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af, has_y=False)
    for i in range(cfg.inst):
        h = jnp.asarray(np.asarray(hs[i])[: cfg.L])[None]
        ph = jnp.asarray(np.asarray(phis[i])[: cfg.L - 1])[None]
        key = jax.random.PRNGKey(cfg.seed + 31 * i)
        k1, k2 = jax.random.split(key)

        # echo pass with the initial schedule: echo_vals[t] = A0(t+1)
        # (matching the reference's per-cycle echo probe, then the whole
        # schedule is adjusted at once — g-optimization.py:625-669)
        g0 = np.full(T, cfg.g)
        keys1 = jax.random.split(k1, n_traj)[None]
        echo_vals = np.asarray(
            sigma_echo_batch(h, ph, schedule_angles(g0), keys1,
                        jnp.arange(1, T + 1), **kw)).mean(axis=1)[0]
        adj = adjust_g_schedule(echo_vals, g0, cfg.target_echo,
                                cfg.feedback_gain, cfg.g_min, cfg.g_max)
        keys2 = jax.random.split(k2, n_traj)[None]
        fwd_vals = np.asarray(
            sigma_forward_batch(h, ph, schedule_angles(adj), keys2,
                           **kw)).mean(axis=1)[0]
        all_fwd.append(fwd_vals)
        all_echo.append(echo_vals)
        all_g.append(adj)

    result = {
        "time": np.arange(T),
        "av_autocorr_adaptive": np.mean(all_fwd, axis=0),
        "av_autocorr_echo_adaptive": np.mean(all_echo, axis=0),
        "av_g_values": np.mean(all_g, axis=0),
        "g_history": np.asarray(all_g),
    }
    if write:
        folder = out_dir or f"controlled-autocorr_data_L{cfg.L}"
        path = os.path.join(
            folder, naming.adaptive_csv_name(cfg).replace("realtime_adaptive",
                                                          "batch_adaptive"))
        csvio.write_columns(path, {k: v for k, v in result.items()
                                   if k != "g_history"})
        result["csv_path"] = path
    return result
