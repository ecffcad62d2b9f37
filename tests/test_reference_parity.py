"""End-to-end parity vs the reference's own shipped artifacts.

Uses the reference's hs_L4/phis_L4 disorder files as INPUT DATA and compares
our exact density-matrix results against its Aer 1024-shot measurements
(autocorr_data_L4/autocorr_data_*_realtime_adaptive_g0.84_*.csv, fixed-g
'standard' columns, rows = t+1 applied cycles). Each reference point carries
shot noise sigma ~ 1/sqrt(1024) ~ 0.031; exact values must sit inside that
band. Skipped when the reference tree isn't mounted.
"""

import os

import numpy as np
import pytest

REF = "/root/reference"


def csvio_read(path):
    from dtc_tpu.io import csvio

    return csvio.read_columns(path)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference tree not mounted")


def test_exact_dm_matches_reference_shot_data():
    from dtc_tpu.experiments.autocorr import run_autocorr
    from dtc_tpu.io import csvio
    from dtc_tpu.utils.config import SimConfig

    ref = csvio.read_columns(os.path.join(
        REF, "autocorr_data_L4",
        "autocorr_data_vacuum_realtime_adaptive_g0.84_L4_inst1_randomphi1_"
        "delta0.0_amplitude1.0_noise0.05_usenoise1_target1.0_gain0.01.csv"))
    n_pts = 10
    cfg = SimConfig(L=4, g=0.84, inst=1, tf=n_pts + 1, noise_prob=0.05,
                    use_noise=1, dtype="complex128")
    r = run_autocorr(cfg, disorder_dir=REF, write=False, method="exact")

    sigma = 1.0 / np.sqrt(1024)
    devs_f = []
    devs_e = []
    for t in range(n_pts):
        devs_f.append(r["av_autocorr"][t + 1] - ref["av_autocorr_standard"][t])
        devs_e.append(r["av_autocorr_echo"][t + 1]
                      - ref["av_autocorr_echo_standard"][t])
    devs_f = np.asarray(devs_f)
    devs_e = np.asarray(devs_e)
    # each point within ~3.5 sigma of the 1024-shot measurement, and no
    # systematic bias beyond the ensemble's standard error
    assert np.abs(devs_f).max() < 3.5 * sigma, devs_f
    assert np.abs(devs_e).max() < 3.5 * sigma, devs_e
    assert abs(devs_f.mean()) < 3 * sigma / np.sqrt(n_pts) + 0.01, devs_f.mean()


@pytest.mark.slow
def test_l20_trajectory_engine_matches_reference_shot_data():
    """External parity at the HEADLINE scale: the
    trajectory engine (the path that actually runs at L=20) against the
    reference's shipped 1024-shot L=20 polarization data, using its own
    hs_L20/phis_L20 disorder inputs. CPU-sized: pol x, forward t<=10 +
    echo at t=2, with bands from shot noise + the empirical trajectory
    ensemble error."""
    import jax
    import jax.numpy as jnp

    from dtc_tpu.core.sigma_evolve import sigma_echo_batch, sigma_forward_batch
    from dtc_tpu.experiments.engine import build_context
    from dtc_tpu.io.disorder import load_disorder
    from dtc_tpu.models.noise import NoiseSpec
    from dtc_tpu.utils.config import SimConfig

    ref = csvio_read(os.path.join(
        REF, "autocorr_data_L20_polarization",
        "autocorr_data_vacuum_g0.97_L20_inst1_randomphi1_delta0.0_"
        "amplitude1.0_noise0.05_usenoise1_polx_with_envelopes.csv"))
    ref_f = np.asarray(ref["av_autocorr"], dtype=float)
    ref_e = np.asarray(ref["av_autocorr_echo"], dtype=float)
    sigma_shot = 1.0 / np.sqrt(1024)

    hs, phis = load_disorder(os.path.join(REF, "hs_L20.csv"),
                             os.path.join(REF, "phis_L20.csv"), 20, 1)
    cfg = SimConfig(L=20, g=0.97, inst=1, tf=10, noise_prob=0.05,
                    use_noise=1, n_trajectories=40)
    sched, params, noise = build_context(cfg, hs, phis)
    kw = dict(L=20, T=10, K=1, p=0.05, q=10, initial_state="vacuum",
              dtype_name="complex64", ancilla_factor=NoiseSpec(p=0.05
                                                               ).ancilla_factor)
    keys = jax.random.split(jax.random.PRNGKey(11), 40)[None]
    vals = np.asarray(sigma_forward_batch(*params, sched.angles, keys, **kw))[0]
    mean_f = vals.mean(axis=0)
    se_f = vals.std(axis=0) / np.sqrt(vals.shape[0])
    band = 3.5 * np.sqrt(sigma_shot**2 + se_f**2)
    devs = mean_f - ref_f[:10]
    assert np.all(np.abs(devs) < band), (devs, band)
    # no systematic bias beyond the combined standard error
    tot = np.sqrt(np.mean(sigma_shot**2 + se_f**2) / 10)
    assert abs(devs.mean()) < 3.0 * tot + 0.01, devs.mean()

    ekw = dict(kw)
    ekw["T"] = 3
    keys_e = jax.random.split(jax.random.PRNGKey(5), 16)[None]
    ev = np.asarray(sigma_echo_batch(*params, sched.angles, keys_e,
                                jnp.asarray([2]), **ekw))[0, :, 0]
    se_e = ev.std() / np.sqrt(len(ev))
    dev_e = ev.mean() - ref_e[2]
    assert abs(dev_e) < 3.5 * np.sqrt(sigma_shot**2 + se_e**2), (dev_e, se_e)


def test_gate_counts_match_reference_artifacts_on_disk():
    from dtc_tpu.device.transpile import gate_counts
    from dtc_tpu.io import csvio

    ref = csvio.read_columns(os.path.join(
        REF, "autocorr_data_L4",
        "gate_counts_t1_forward_opt0_aer_simulator_coupling_routelookahead_"
        "layoutdense_iqm.csv"))
    want = dict(zip(ref["gate"], [int(c) for c in ref["count"]]))
    got = gate_counts(4, 1)
    assert got == want, (got, want)


def test_disorder_loader_reads_reference_files():
    from dtc_tpu.io.disorder import load_disorder

    hs, phis = load_disorder(os.path.join(REF, "hs_L4.csv"),
                             os.path.join(REF, "phis_L4.csv"), 4, 1)
    assert hs.shape == (1, 4) and phis.shape == (1, 3)
    # values from the shipped file (first row)
    np.testing.assert_allclose(hs[0, 0], 2.6380584912243643)
    np.testing.assert_allclose(phis[0, 0], -2.6283238608399797)


@pytest.mark.parametrize("gain", ["0.01", "0.05"])
def test_l4_adaptive_g_history_replay(gain):
    """Replay the reference's SHIPPED adaptive g-history through the
    per-cycle-g engine: the controlled-g datasets
    record the exact g value the feedback loop applied at every cycle
    (g_history_inst1), so feeding that column back in as a (T,) g vector
    must reproduce the shipped forward/echo measurements within their
    1024-shot bands. This anchors the time-dependent-g path (C6/C12)
    end-to-end against external data, independent of any feedback law.

    Reference producer: autocorr-delta-a-single-qiskit-fast-controlled-g.py
    (qc_qiskit g_values[time_step] convention at :196-233; row t = t+1
    applied cycles at :311-338).
    """
    from dtc_tpu.experiments.autocorr import run_autocorr
    from dtc_tpu.io import csvio
    from dtc_tpu.utils.config import SimConfig

    ref = csvio.read_columns(os.path.join(
        REF, "autocorr_data_L4",
        "autocorr_data_vacuum_realtime_adaptive_g0.84_L4_inst1_randomphi1_"
        f"delta0.0_amplitude1.0_noise0.05_usenoise1_target1.0_gain{gain}.csv"))
    g_hist = np.asarray(ref["g_history_inst1"], dtype=float)
    n_pts = len(g_hist)
    # row t uses cycles 0..t with per-cycle g = g_hist[0..t]; our output row
    # j = j applied cycles, so pad the schedule to tf = n_pts + 1 slots
    g_vec = np.concatenate([g_hist, g_hist[-1:]])
    cfg = SimConfig(L=4, g=g_vec, inst=1, tf=n_pts + 1, noise_prob=0.05,
                    use_noise=1, dtype="complex128")
    r = run_autocorr(cfg, disorder_dir=REF, write=False, method="exact")

    sigma = 1.0 / np.sqrt(1024)
    dev_f = r["av_autocorr"][1:n_pts + 1] - np.asarray(
        ref["forward_adaptive_inst1"], dtype=float)
    dev_e = r["av_autocorr_echo"][1:n_pts + 1] - np.asarray(
        ref["echo_adaptive_inst1"], dtype=float)
    assert np.abs(dev_f).max() < 3.5 * sigma, dev_f
    assert np.abs(dev_e).max() < 3.5 * sigma, dev_e
    assert abs(dev_f.mean()) < 3 * sigma / np.sqrt(n_pts) + 0.01, dev_f.mean()
    assert abs(dev_e.mean()) < 3 * sigma / np.sqrt(n_pts) + 0.01, dev_e.mean()


def test_adaptive_csv_schema_matches_shipped_controlled_g_artifacts(tmp_path):
    """The controlled-g output contract (SURVEY.md section 5): a tiny
    adaptive-optimization run must produce BOTH files of the reference's
    shipped L=20 controlled-g dataset — same filename tokenization and a
    column superset of each shipped header (controlled-g.py:669-737;
    g-optimization.py:812-835)."""
    import jax

    from dtc_tpu.experiments.adaptive import run_adaptive_realtime
    from dtc_tpu.io import csvio
    from dtc_tpu.utils.config import SimConfig

    cfg = SimConfig(L=6, g=0.84, inst=1, tf=5, noise_prob=0.05, use_noise=1,
                    n_trajectories=8, seed=3, target_echo=1.0,
                    feedback_gain=0.01, use_optimization=1,
                    optimization_iterations=5)
    r = run_adaptive_realtime(cfg, write=True, out_dir=str(tmp_path))

    ref_dir = os.path.join(REF, "controlled-autocorr_data_L20")
    ref_data = csvio.read_columns(os.path.join(
        ref_dir, "autocorr_data_vacuum_realtime_adaptive_optimization_iter5_"
        "g0.84_L20_inst1_randomphi1_delta0.0_amplitude1.0_noise0.05_"
        "usenoise1_target1.0_gain0.01.csv"))
    ours = csvio.read_columns(r["csv_path"])
    assert set(ref_data) <= set(ours), set(ref_data) - set(ours)
    # filename tokens: identical up to the L/tf substitution
    want = ("autocorr_data_vacuum_realtime_adaptive_optimization_iter5_"
            "g0.84_L6_inst1_randomphi1_delta0.0_amplitude1.0_noise0.05_"
            "usenoise1_target1.0_gain0.01.csv")
    assert os.path.basename(r["csv_path"]) == want

    ref_comp = csvio.read_columns(os.path.join(
        ref_dir, "comparison_vacuum_adaptive_optimization_vs_fixed_g0.84_"
        "L20_inst1_target1.0_gain0.01.csv"))
    comp = csvio.read_columns(r["comparison_csv_path"])
    assert set(ref_comp) <= set(comp), set(ref_comp) - set(comp)
    assert os.path.basename(r["comparison_csv_path"]) == (
        "comparison_vacuum_adaptive_optimization_vs_fixed_g0.84_L6_inst1_"
        "target1.0_gain0.01.csv")
