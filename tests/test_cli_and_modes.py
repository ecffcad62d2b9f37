"""CLI subcommands, exact-DM experiment mode, sharded driver, checkpoints."""

import os

import numpy as np
import pytest

from dtc_tpu.experiments.autocorr import run_autocorr
from dtc_tpu.experiments.energy import run_energy
from dtc_tpu.experiments.sharded_run import run_autocorr_sharded
from dtc_tpu.io import csvio
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.utils.cli import main as cli_main
from dtc_tpu.utils.config import SimConfig

import exact_oracle as oracle


def test_exact_method_matches_oracle(tmp_path):
    cfg = SimConfig(L=3, g=0.9, tf=4, noise_prob=0.08, use_noise=1, inst=1,
                    dtype="complex128")
    hs, phis = generate_disorder(cfg.L, 1, seed=70)
    r = run_autocorr(cfg, hs, phis, out_dir=str(tmp_path), method="exact")
    for t in range(cfg.tf):
        want_f = oracle.autocorr_dm(cfg.L, cfg.g, hs[0], phis[0], t, 0.08)
        want_e = oracle.autocorr_dm(cfg.L, cfg.g, hs[0], phis[0], t, 0.08,
                                    echo=True)
        np.testing.assert_allclose(r["av_autocorr"][t], want_f, atol=1e-9)
        np.testing.assert_allclose(r["av_autocorr_echo"][t], want_e, atol=1e-9)


def test_sharded_experiment_driver(tmp_path):
    cfg = SimConfig(L=6, tf=4, noise_prob=0.05, use_noise=1, inst=1,
                    n_trajectories=32, dtype="complex64")
    r = run_autocorr_sharded(cfg, out_dir=str(tmp_path), echo_ts=[0, 2])
    assert r["mesh_shape"]["amp"] >= 2  # actually sharded on the 8-dev mesh
    assert abs(r["av_autocorr"][0] - 0.95**6) < 1e-3
    assert os.path.exists(r["csv_path"])


def test_energy_checkpoint_resume(tmp_path):
    cfg = SimConfig(L=3, tf=3, use_noise=1, noise_prob=0.05,
                    n_trajectories=16, inst=1, dtype="complex128")
    hs, phis = generate_disorder(cfg.L, 1, seed=71)
    jp = str(tmp_path / "ckpt.bin")
    r1 = run_energy(cfg, hs, phis, nprobs=(0.05,), out_dir=str(tmp_path),
                    checkpoint_path=jp)
    # resume must reproduce exactly from the journal (no recompute drift)
    r2 = run_energy(cfg, hs, phis, nprobs=(0.05,), out_dir=str(tmp_path),
                    checkpoint_path=jp)
    np.testing.assert_array_equal(r1["energy_p_0.05"], r2["energy_p_0.05"])


def test_adaptive_realtime_csv(tmp_path):
    from dtc_tpu.experiments.adaptive import run_adaptive_realtime

    cfg = SimConfig(L=3, tf=3, use_noise=0, inst=1, dtype="complex128",
                    use_optimization=0, exponential_feedback=0)
    r = run_adaptive_realtime(cfg, *generate_disorder(3, 1, seed=72),
                              out_dir=str(tmp_path), realtime_csv=True)
    files = [f for f in os.listdir(tmp_path) if f.startswith("adaptive_realtime")]
    assert files
    cols = csvio.read_columns(str(tmp_path / files[0]))
    assert list(cols) == ["time", "g", "forward", "echo"]
    assert len(cols["time"]) == 3


def test_cli_draw_layout_qasm(tmp_path):
    cfg_csv = str(tmp_path / "a.csv")
    csvio.write_columns(cfg_csv, {
        "time": np.arange(20),
        "av_autocorr": np.cos(np.pi * np.arange(20)) * np.exp(-0.05 * np.arange(20)),
        "av_autocorr_echo": np.exp(-0.08 * np.arange(20)),
        "sqrt_av_autocorr_echo": np.exp(-0.04 * np.arange(20)),
    })
    out = str(tmp_path / "a.png")
    assert cli_main(["draw", cfg_csv, "--kind", "autocorr", "--out", out]) == 0
    assert os.path.getsize(out) > 1000
    assert cli_main(["draw", cfg_csv, "--kind", "sincos-fit",
                     "--out", str(tmp_path / "b.png")]) == 0
    assert cli_main(["draw", cfg_csv, "--kind", "fft",
                     "--out", str(tmp_path / "c.png")]) == 0

    lay_png = str(tmp_path / "lay.png")
    assert cli_main(["layout", "--device", "garnet", "--L", "19",
                     "--out", lay_png]) == 0
    assert os.path.getsize(lay_png) > 1000

    qasm_out = str(tmp_path / "c.qasm")
    assert cli_main(["qasm", "--L", "4", "--tf", "3", "--t", "2",
                     "--disorder_dir", str(tmp_path), "--out", qasm_out]) == 0
    text = open(qasm_out).read()
    assert text.startswith("OPENQASM 2.0;") and "rzz(" in text


def test_parse_config_from_name():
    from dtc_tpu.io.naming import (adaptive_csv_name, autocorr_csv_name,
                                   parse_config_from_name)
    from dtc_tpu.utils.config import SimConfig

    cfg = SimConfig(L=20, g=0.97, inst=2, tf=50, randomphi=1, phi_delta=0.1,
                    phi_amplitude=1.5, noise_prob=0.05, use_noise=1)
    m = parse_config_from_name(autocorr_csv_name(cfg, pol="xy_cycle"))
    assert m["initial_state"] == "vacuum" and m["L"] == 20 and m["g"] == 0.97
    assert m["tf"] == 50 and m["phi_delta"] == 0.1 and m["phi_amplitude"] == 1.5
    assert m["noise_prob"] == 0.05 and m["use_noise"] == 1
    assert m["polarization"] == "xy_cycle" and not m["with_envelopes"]

    cfg2 = SimConfig(L=4, use_optimization=1, optimization_iterations=7,
                     target_echo=1.0, feedback_gain=0.05)
    m2 = parse_config_from_name("/tmp/x/" + adaptive_csv_name(cfg2))
    assert m2["adaptive"] and m2["method"] == "optimization"
    assert m2["optimization_iterations"] == 7
    assert m2["target_echo"] == 1.0 and m2["feedback_gain"] == 0.05

    m3 = parse_config_from_name(autocorr_csv_name(cfg, with_envelopes=True))
    assert m3["with_envelopes"] and "polarization" not in m3


def test_cli_draw_multi_csv_kinds(tmp_path):
    t = np.arange(20)
    energy_csvs = []
    for d, a in [(0.0, 1.0), (0.1, 1.0), (0.0, 2.0)]:
        p = str(tmp_path / f"autocorr_data_vacuum_g0.9_L4_inst1_tf20_randomphi1"
                f"_delta{d}_amplitude{a}_noise0.05_usenoise1.csv")
        csvio.write_columns(p, {
            "time": t,
            "av_autocorr": np.cos(np.pi * t) * np.exp(-(0.03 + d) * t),
        })
        energy_csvs.append(p)
    e_csv = str(tmp_path / "energy_data_vacuum_g0.9_L4_inst1_randomphi1"
                "_delta0.0_amplitude1.0_noise0.05_usenoise1.csv")
    csvio.write_columns(e_csv, {
        "time": t, "energy_p_0.0": -4.0 + 0.1 * t,
        "energy_p_0.05": -4.0 + 0.3 * np.sqrt(t + 1.0)})

    fit_csv = str(tmp_path / "fits.csv")
    assert cli_main(["draw", *energy_csvs, "--kind", "fit-grid",
                     "--fit_csv", fit_csv,
                     "--out", str(tmp_path / "grid.png")]) == 0
    rows = csvio.read_columns(fit_csv)
    assert len(rows["row"]) == 3 and "frequency_fitted" in rows

    assert cli_main(["draw", e_csv, "--kind", "energy-all", "--per_qubit",
                     "--out", str(tmp_path / "ea.png")]) == 0
    assert cli_main(["draw", e_csv, "--kind", "power-law",
                     "--out", str(tmp_path / "pl.png")]) == 0
    assert cli_main(["draw", e_csv, "--kind", "sub-echo",
                     "--echo_csv", energy_csvs[0],
                     "--out", str(tmp_path / "se.png")]) == 0
    assert cli_main(["draw", *energy_csvs, "--kind", "xy-cycle",
                     "--period", "5", "--out", str(tmp_path / "xy.png")]) == 0

    merged = str(tmp_path / "merged.csv")
    csvio.write_columns(merged, {
        "time": t,
        "av_autocorr_x": np.cos(np.pi * t), "av_autocorr_echo_x": 0 * t + 1.0,
        "sqrt_av_autocorr_echo_x": 0 * t + 1.0,
        "av_autocorr_y": np.cos(np.pi * t) * 0.9,
        "av_autocorr_echo_y": 0 * t + 0.9,
        "sqrt_av_autocorr_echo_y": 0 * t + 0.95,
    })
    assert cli_main(["draw", merged, "--kind", "polarization-comparison",
                     "--out", str(tmp_path / "pc.png")]) == 0
    for f in ["grid.png", "ea.png", "pl.png", "se.png", "xy.png", "pc.png"]:
        assert os.path.getsize(str(tmp_path / f)) > 1000


def test_cli_gate_counts_emission(tmp_path):
    out = str(tmp_path / "gc")
    assert cli_main(["autocorr", "--L", "4", "--tf", "2", "--use_noise", "0",
                     "--out_dir", out, "--emit_gate_counts",
                     "--disorder_dir", str(tmp_path)]) == 0
    files = os.listdir(out)
    assert any(f.startswith("gate_counts_t1_forward") for f in files)
    assert any(f.startswith("gate_counts_t1_echo") for f in files)


def test_cli_sharded_autocorr(tmp_path):
    assert cli_main(["autocorr", "--L", "6", "--tf", "3", "--noise_prob",
                     "0.05", "--n_trajectories", "16", "--sharded",
                     "--out_dir", str(tmp_path / "sh"),
                     "--disorder_dir", str(tmp_path)]) == 0


def test_cli_platform_flag_subprocess(tmp_path):
    """--platform cpu --num_devices N retargets JAX before backend init
    (through jax.config) and the sharded path then sees the virtual mesh."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run(
        [sys.executable, "-m", "dtc_tpu", "--platform", "cpu",
         "--num_devices", "4", "autocorr", "--L", "5", "--tf", "3",
         "--n_trajectories", "16", "--sharded",
         "--out_dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=420,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "amp" in r.stdout  # mesh banner printed by the sharded driver
    assert any(f.name.startswith("autocorr_data") for f in tmp_path.iterdir())


def test_cli_platform_flag_after_init_raises():
    """In-process, once backends are up the flag must fail loudly instead
    of silently running on the wrong platform."""
    import jax

    jax.devices()  # force backend init (standalone runs)
    with pytest.raises(RuntimeError, match="already"):
        cli_main(["--platform", "cpu", "params", "--out", "/dev/null"])
