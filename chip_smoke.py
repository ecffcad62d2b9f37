"""On-card smoke test: the main path, run as a user runs it, checked.

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-cards  # four GPUs: the amplitude-sharded path

Phases (each prints one line with its numbers; any failure exits non-zero
before the final line):

1. device      JAX sees a GPU first (the CPU stays available for phase 3);
               prints device_kind, count and `nvidia-smi` name/power limit.
2. main path   `python -m dtc_tpu autocorr` at L=20, T=50, 2 instances x 256
               trajectories through dtc_tpu.utils.cli.main; checks the CSV
               schema, A(0) = (1-p)^6, finiteness, |A| <= 1, period doubling
               and the echo range.
3. parity      the sigma engine on the card vs the in-process CPU backend,
               identical presampled keys, x and y drives, forward and echo.
4. device noise  FakeBrisbane x-drive forward + echo through device_sweeps;
               a zero-rate calibration must reproduce the noiseless run.
5. energy      the XLA observables route (energy + per-qubit Z), card vs CPU.

--four-cards runs only the amplitude-sharded phase: the sharded forward and
echo builders at L=28 against the one-card engine with the same keys, and
L=32 (8 GB of state per card) against exact invariants.

The last stdout line is {"ok": true, "device": {...}} and appears only when
every phase passed.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

CSV_COLUMNS = ["time", "av_autocorr", "av_autocorr_echo",
               "sqrt_av_autocorr_echo"]
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


def say(phase: str, **nums) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()),
          flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class CompileClock:
    """Sums JAX's own compile-duration events (trace, lowering, backend
    compile) so a wall time splits into compile and steady parts."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.total += duration


def phase_device(want_count: int):
    import jax

    from dtc_tpu.utils.runtime import card_identity, require_gpu

    dev = require_gpu()
    n = len(jax.devices())
    check(n >= want_count, f"need {want_count} GPUs, JAX sees {n}")
    smi = card_identity()
    print(smi, flush=True)
    say("device", platform=dev.platform, kind=repr(dev.device_kind), count=n,
        cpu_devices=len(jax.devices("cpu")))
    return dev


def phase_main_path(clock: CompileClock, *, L=20, tf=50, p=0.05, inst=2,
                    n_traj=256, g=0.97):
    from dtc_tpu.utils.cli import main as cli_main

    with tempfile.TemporaryDirectory() as out:
        c0 = clock.total
        t0 = time.perf_counter()
        rc = cli_main(["autocorr", "--L", str(L), "--tf", str(tf),
                       "--g", str(g), "--noise_prob", str(p),
                       "--inst", str(inst), "--n_trajectories", str(n_traj),
                       "--out_dir", out, "--disorder_dir", out])
        wall = time.perf_counter() - t0
        compile_s = clock.total - c0
        check(rc == 0, f"cli exit code {rc}")
        paths = glob.glob(os.path.join(out, "*.csv"))
        check(len(paths) == 1, f"expected one CSV, found {paths}")
        with open(paths[0]) as f:
            rows = list(csv.reader(f))
    check(rows[0] == CSV_COLUMNS, f"CSV columns {rows[0]} != {CSV_COLUMNS}")
    vals = np.array([[float(x) for x in r] for r in rows[1:]])
    check(vals.shape == (tf, 4), f"CSV shape {vals.shape}")
    a, e = vals[:, 1], vals[:, 2]
    af = (1 - p) ** 6
    check(np.all(np.isfinite(a)) and np.all(np.isfinite(e)),
          "non-finite A(t) or echo")
    check(abs(a[0] - af) <= 1e-3, f"A(0)={a[0]} != (1-p)^6={af}")
    check(np.all(np.abs(a) <= 1.0), f"max|A|={np.abs(a).max()} > 1")
    n_alt = 6
    signs = np.sign(a[:n_alt])
    check(np.all(signs == (-1.0) ** np.arange(n_alt)),
          f"no period doubling in A(0..{n_alt - 1})={a[:n_alt]}")
    check(np.all(np.abs(e) <= 1.0), f"echo outside [-1, 1]: {e}")
    say("main_path", L=L, tf=tf, inst=inst, n_traj=n_traj,
        A0=f"{a[0]:.6f}", A1=f"{a[1]:.6f}", A_last=f"{a[-1]:.6f}",
        echo_last=f"{e[-1]:.6f}", wall_s=f"{wall:.2f}",
        compile_s=f"{compile_s:.2f}", steady_s=f"{wall - compile_s:.2f}")


def _sigma_on(device, pol, *, L, T, p, n_traj, ts, seed=3):
    """(forward (n_traj, T), echo (n_traj, len(ts))) from the sigma engine
    with every input committed to ``device``."""
    import jax

    from dtc_tpu.core.sigma_evolve import sigma_echo_batch, sigma_forward_batch
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule

    hs, phis = generate_disorder(L, 1, seed=seed)
    sched = build_kick_schedule(pol, 0.97, T)
    kw = dict(L=L, T=T, K=sched.K, p=p, q=L // 2, initial_state="vacuum",
              dtype_name="complex64", ancilla_factor=(1 - p) ** 6,
              has_y=pol != "x")
    put = lambda x: jax.device_put(np.asarray(x), device)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n_traj))
    args = (put(hs[:, :L]), put(phis[:, :L - 1]), put(sched.angles),
            put(keys[None]))
    fwd = np.asarray(sigma_forward_batch(*args, **kw))[0]
    ech = np.asarray(sigma_echo_batch(*args, put(np.asarray(ts, np.int32)),
                                 **kw))[0]
    return fwd, ech


def phase_parity(gpu, *, L=20, T=10, p=0.05, n_traj=4, ts=(1, 5, 9),
                 tol=1e-4):
    """Card vs CPU, same engine and keys: the two differ only in summation
    order, so the expected gap is float32 rounding (~1e-5); tol=1e-4."""
    import jax

    cpu = jax.devices("cpu")[0]
    for pol in ("x", "y"):
        fg, eg = _sigma_on(gpu, pol, L=L, T=T, p=p, n_traj=n_traj, ts=ts)
        fc, ec = _sigma_on(cpu, pol, L=L, T=T, p=p, n_traj=n_traj, ts=ts)
        df = float(np.max(np.abs(fg - fc)))
        de = float(np.max(np.abs(eg - ec)))
        check(np.all(np.isfinite(fg)) and np.all(np.isfinite(eg)),
              f"{pol}: non-finite card values")
        check(df <= tol and de <= tol,
              f"{pol}: card vs CPU forward {df:.3e}, echo {de:.3e} > {tol}")
        say("parity", pol=pol, L=L, T=T, n_traj=n_traj, ts=list(ts),
            max_dfwd=f"{df:.3e}", max_decho=f"{de:.3e}")


def _zero_rate_calibration(path: str) -> None:
    from dtc_tpu.models.device_noise import synthetic_eagle_calibration

    cal = synthetic_eagle_calibration(127)
    for k in ("single_qubit_error", "two_qubit_error", "readout_error"):
        cal[k] = {q: 0.0 for q in cal[k]}
    with open(path, "w") as f:
        json.dump(cal, f)


def phase_device_noise(*, L=20, T=20, n_traj=64, tol=1e-4):
    """FakeBrisbane device-noise sweeps, then the same sweeps on a zero-rate
    calibration against the noiseless sigma engine (exact unitary evolution
    on both sides: float32 rounding only, tol=1e-4)."""
    import jax

    from dtc_tpu.experiments.device_sweeps import (
        device_echo_sweep,
        device_forward_sweep,
    )
    from dtc_tpu.experiments.engine import build_context, forward_sweep
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.utils.config import SimConfig

    cfg = SimConfig(L=L, tf=T, g=0.97, use_fakebackend=1,
                    fake_device="brisbane", n_trajectories=n_traj)
    hs, phis = generate_disorder(L, 1, seed=5)
    sched, params, _ = build_context(cfg, hs, phis)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    a = device_forward_sweep(cfg, sched, params, key)[0]
    e = device_echo_sweep(cfg, sched, params, key)[0]
    wall = time.perf_counter() - t0
    check(np.all(np.isfinite(a)) and np.all(np.isfinite(e)),
          "non-finite device-noise rows")
    check(np.all(np.abs(a) <= 1.0) and np.all(np.abs(e) <= 1.0),
          "device-noise rows outside [-1, 1]")
    check(abs(a[0] - e[0]) <= 1e-5, f"A(0)={a[0]} != echo(0)={e[0]}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "zero_rates.json")
        _zero_rate_calibration(path)
        cfg0 = cfg.replace(calibration_path=path)
        a0 = device_forward_sweep(cfg0, sched, params, key)[0]
        e0 = device_echo_sweep(cfg0, sched, params, key)[0]
    clean = cfg.replace(use_fakebackend=0, use_noise=0)
    sched_c, params_c, noise_c = build_context(clean, hs, phis)
    ref = forward_sweep(clean, sched_c, params_c, noise_c, key)[0]
    da = float(np.max(np.abs(a0 - ref)))
    de = float(np.max(np.abs(e0 - 1.0)))
    check(da <= tol, f"zero-rate device forward vs noiseless: {da:.3e}")
    check(de <= tol, f"zero-rate device echo vs 1: {de:.3e}")
    say("device_noise", L=L, T=T, n_traj=n_traj, A0=f"{a[0]:.6f}",
        A_last=f"{a[-1]:.6f}", echo_last=f"{e[-1]:.6f}",
        zero_rate_max_dfwd=f"{da:.3e}", zero_rate_max_decho=f"{de:.3e}",
        wall_s=f"{wall:.2f}")


def _observables_on(device, *, L, T, p, n_traj, seed=11):
    import jax

    from dtc_tpu.experiments.energy import _observables_batch
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule
    from dtc_tpu.models.hamiltonian import hamiltonian_terms

    hs, phis = generate_disorder(L, 1, seed=seed)
    terms = hamiltonian_terms(L, 0.97, hs[0], phis[0], "full")
    sched = build_kick_schedule("x", 0.97, T)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n_traj))
    put = lambda x: jax.device_put(np.asarray(x), device)
    e, zs = _observables_batch(
        put(hs[:, :L]), put(phis[:, :L - 1]), put(np.asarray(terms.hs)[None]),
        put(np.asarray(terms.phis)[None]),
        put(np.float32(terms.x_coeff)), put(sched.angles),
        put(keys[None]), L=L, T=T, K=1, p=p, with_x=True,
        initial_state="vacuum", dtype_name="complex64")
    return np.asarray(e)[0], np.asarray(zs)[0]


def phase_energy(gpu, *, L=20, T=20, p=0.1, n_traj=4, tol_e=1e-3,
                 tol_z=1e-4):
    """Energy and per-qubit Z on the card vs the CPU backend, same keys.
    float32 sums over 2^L amplitudes in different orders: ~1e-5 relative;
    E is O(L), hence tol_e=1e-3 absolute."""
    import jax

    cpu = jax.devices("cpu")[0]
    eg, zg = _observables_on(gpu, L=L, T=T, p=p, n_traj=n_traj)
    ec, zc = _observables_on(cpu, L=L, T=T, p=p, n_traj=n_traj)
    check(np.all(np.isfinite(eg)) and np.all(np.isfinite(zg)),
          "non-finite card energies")
    de = float(np.max(np.abs(eg - ec)))
    dz = float(np.max(np.abs(zg - zc)))
    check(de <= tol_e, f"card vs CPU energy {de:.3e} > {tol_e}")
    check(dz <= tol_z, f"card vs CPU <Z_q> {dz:.3e} > {tol_z}")
    say("energy", L=L, T=T, p=p, n_traj=n_traj, E0=f"{eg[:, 0].mean():.6f}",
        max_dE=f"{de:.3e}", max_dZ=f"{dz:.3e}")


def _sharded_run(devices, *, L, T, p, n_traj, n_amp, t_echo):
    """Sharded forward A(t) and echo A0(t) for t in ``t_echo`` over an
    (amp=n_amp, traj=1) mesh, one trajectory per call (bounds the per-card
    state to one trajectory's shard), averaged over ``n_traj`` keys."""
    import jax
    import jax.numpy as jnp

    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule
    from dtc_tpu.parallel.mesh import make_mesh
    from dtc_tpu.parallel.sharded import (
        make_sharded_autocorr_forward,
        make_sharded_echo,
    )

    hs, phis = generate_disorder(L, 1, seed=2)
    sched = build_kick_schedule("x", 0.97, T)
    keys = jax.random.split(jax.random.PRNGKey(2), n_traj)
    mesh = make_mesh(n_amp=n_amp, n_traj=1, devices=devices[:n_amp])
    kw = dict(L=L, T=T, K=1, p=p, q=L // 2)
    fwd = make_sharded_autocorr_forward(mesh, **kw)
    ech = make_sharded_echo(mesh, **kw)
    h, ph = jnp.asarray(hs[0, :L]), jnp.asarray(phis[0, :L - 1])
    a = np.mean([np.asarray(fwd(sched.angles, h, ph, keys[i:i + 1]))
                 for i in range(n_traj)], axis=0)
    e = {t: float(np.mean([float(ech(sched.angles, h, ph, keys[i:i + 1],
                                     jnp.asarray(t)))
                           for i in range(n_traj)]))
         for t in t_echo}
    return (hs, phis, sched, keys), a, e


def phase_four_cards(*, L_ref=28, L_big=32, p=0.05, T=4, n_traj=4,
                     tol=1e-4):
    """L=28: sharded (n_amp=4) vs one-card engine, same keys (float32
    rounding only, tol=1e-4). L=32: invariants only (one card cannot hold
    the reference)."""
    import jax

    from dtc_tpu.core.sigma_evolve import sigma_echo_batch, sigma_forward_batch

    devs = jax.devices()
    L = L_ref
    c0 = time.perf_counter()
    (hs, phis, sched, keys), a, e = _sharded_run(
        devs, L=L, T=T, p=p, n_traj=n_traj, n_amp=4, t_echo=(T,))
    kw = dict(L=L, T=T, K=1, p=p, q=L // 2, initial_state="vacuum",
              dtype_name="complex64", ancilla_factor=(1 - p) ** 6)
    with jax.default_device(devs[0]):
        ref_a = np.mean([np.asarray(sigma_forward_batch(
            hs[:, :L], phis[:, :L - 1], sched.angles, keys[None, i:i + 1],
            **kw))[0, 0] for i in range(n_traj)], axis=0)
        ref_e = np.mean([float(np.asarray(sigma_echo_batch(
            hs[:, :L], phis[:, :L - 1], sched.angles, keys[None, i:i + 1],
            np.asarray([T], np.int32), **kw))[0, 0, 0])
            for i in range(n_traj)])
    da = float(np.max(np.abs(a - ref_a)))
    de = abs(e[T] - ref_e)
    check(da <= tol and de <= tol,
          f"L={L} sharded vs one card: forward {da:.3e}, echo {de:.3e}")
    say("four_cards", L=L, n_amp=4, T=T, n_traj=n_traj,
        max_dfwd=f"{da:.3e}", decho=f"{de:.3e}",
        wall_s=f"{time.perf_counter() - c0:.2f}")

    L = L_big
    c0 = time.perf_counter()
    _, a, e = _sharded_run(devs, L=L, T=T, p=p, n_traj=n_traj, n_amp=4,
                           t_echo=(0, T))
    af = (1 - p) ** 6
    check(np.all(np.isfinite(a)) and all(np.isfinite(v) for v in e.values()),
          f"L={L}: non-finite values")
    check(abs(a[0] - af) <= 1e-3, f"L={L}: A(0)={a[0]} != {af}")
    check(abs(e[0] - af) <= 1e-3, f"L={L}: echo(0)={e[0]} != {af}")
    check(np.all(np.abs(a) <= 1.0) and abs(e[T]) <= 1.0,
          f"L={L}: |A| > 1")
    peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in devs[:4])
    say("four_cards", L=L, n_amp=4, T=T, n_traj=n_traj, A0=f"{a[0]:.6f}",
        A_last=f"{a[-1]:.6f}", echo_T=f"{e[T]:.6f}",
        peak_GiB_per_card=f"{peak / 2**30:.2f}",
        wall_s=f"{time.perf_counter() - c0:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card amplitude-sharded phase")
    args = ap.parse_args(argv)

    import jax

    # the CPU backend rides along for the parity phases; a CUDA plugin that
    # fails to load is then an error, not a silent CPU run
    jax.config.update("jax_platforms", "cuda,cpu")

    from dtc_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    want = 4 if args.four_cards else 1
    dev = phase_device(want)
    if args.four_cards:
        phase_four_cards()
    else:
        clock = CompileClock()
        phase_main_path(clock)
        phase_parity(dev)
        phase_device_noise()
        phase_energy(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
