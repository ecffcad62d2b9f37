"""Device layer: gate counts, QASM export, layouts, jobs, device noise."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from dtc_tpu.device.jobs import (
    counts_to_z_expectation,
    decode_jobs_to_expectations,
    measurement_bits_to_counts,
    merge_job_records,
)
from dtc_tpu.device.layouts import (
    find_snake_path,
    garnet_coupling,
    heavy_hex_coupling,
    linear_with_ancilla_coupling,
    render_layout,
    snake_layout,
)
from dtc_tpu.device.qasm import circuit_to_qasm, parse_qasm_gates
from dtc_tpu.device.transpile import (
    circuit_depth,
    gate_counts,
    noisy_1q_gate_events,
    write_gate_count_csv,
)
from dtc_tpu.models.device_noise import (
    brisbane_like_model,
    model_from_calibration,
    synthetic_eagle_calibration,
)

import exact_oracle as oracle


def test_gate_counts_match_reference_artifacts():
    # autocorr_data_L4/gate_counts_t1_forward_*.csv: u3=4 rz=7 cx=8 u2=6
    c = gate_counts(4, 1)
    assert c == {"u3": 4, "rz": 7, "cx": 8, "u2": 6, "measure": 1}
    # echo t=1: u3=8 rz=14 cx=14 u2=6
    c = gate_counts(4, 1, echo=True)
    assert c == {"u3": 8, "rz": 14, "cx": 14, "u2": 6, "measure": 1}
    # t=0 forward: u2=6 cx=2 measure=1 (no cycles)
    c = gate_counts(4, 0)
    assert c == {"cx": 2, "u2": 6, "measure": 1}
    # L=20 t=29, 2-slot kick (circular): u3=1160 rz=1131 cx=1104
    c = gate_counts(20, 29, polarization="circular_left")
    assert c["u3"] == 1160 and c["rz"] == 1131 and c["cx"] == 1104


def test_noisy_event_count():
    assert noisy_1q_gate_events(4, 1) == 10  # 4 kicks + 6 ancilla u2
    assert noisy_1q_gate_events(4, 2, echo=True) == 22
    assert circuit_depth(4, 2) > circuit_depth(4, 1)


def test_gate_count_csv(tmp_path):
    from dtc_tpu.io import csvio

    p = write_gate_count_csv(str(tmp_path / "gc.csv"), 4, 1)
    cols = csvio.read_columns(p)
    assert "u3" in list(cols["gate"])


def test_qasm_roundtrip_gate_stream():
    L, t = 4, 2
    hs = np.linspace(-1, 1, L)
    phis = np.linspace(-2, -1, L - 1)
    from dtc_tpu.models.drives import build_kick_schedule

    sched = build_kick_schedule("x", 0.9, t)
    text = circuit_to_qasm(L, hs, phis, t, sched)
    gates = parse_qasm_gates(text)
    names = [g[0] for g in gates]
    counts = {n: names.count(n) for n in set(names)}
    # logical stream: h=2, cz=2, rx=L*t, rzz=(L-1)*t, rz=L*t, measure=1
    assert counts["h"] == 2 and counts["cz"] == 2
    assert counts["rx"] == L * t and counts["rzz"] == (L - 1) * t
    assert counts["rz"] == L * t and counts["measure"] == 1
    # echo doubles the cycle gates with negated angles
    text_e = circuit_to_qasm(L, hs, phis, t, sched, echo=True)
    gates_e = parse_qasm_gates(text_e)
    rx = [g for g in gates_e if g[0] == "rx"]
    assert len(rx) == 2 * L * t
    assert any(p[0] < 0 for _, p, _ in rx)


def test_heavy_hex_graphs():
    n, edges, coords = heavy_hex_coupling(7, 15)
    assert n == 127  # Eagle / Brisbane scale
    assert len(coords) == n
    deg = {}
    for a, b in edges:
        deg[a] = deg.get(a, 0) + 1
        deg[b] = deg.get(b, 0) + 1
    assert max(deg.values()) <= 3  # heavy-hex property
    n2, _, _ = heavy_hex_coupling(7, 16)
    assert n2 > 127
    ng, ge, gc = garnet_coupling()
    assert ng == 20


def test_snake_layout_and_render(tmp_path):
    lay = snake_layout(27, "brisbane")
    path = lay["path"]
    assert len(path) == 27 and len(set(path)) == 27
    edge_set = {frozenset(e) for e in lay["edges"]}
    for a, b in zip(path, path[1:]):
        assert frozenset((a, b)) in edge_set  # contiguous physical chain
    png = render_layout(lay, str(tmp_path / "layout.png"), "L=27 on Brisbane")
    import os

    assert os.path.getsize(png) > 5000

    lay_g = snake_layout(19, "garnet")
    assert len(lay_g["path"]) == 19

    n, edges = linear_with_ancilla_coupling(6)
    assert (0, 4) in edges and n == 7


def test_find_snake_path_impossible():
    # a star graph has no length-4 path
    edges = [(0, 1), (0, 2), (0, 3)]
    assert find_snake_path(4, edges, 4) is None


def test_snake_layout_longer_than_device_raises():
    # L > device size must surface the clear ValueError, not an IndexError
    # from the segmented-snake stitcher running out of nodes
    import pytest

    with pytest.raises(ValueError, match="no length-21 snake"):
        snake_layout(21, "garnet")


def test_segmented_snake_hop_count_is_true_nonadjacency():
    """n_hops counts only junctions that are NOT physical couplings, and
    matches validate_snake's non-adjacency count for the same path."""
    from dtc_tpu.device.layouts import find_segmented_snake, validate_snake

    # two triangles bridged by one edge: a full 6-path exists, so the
    # greedy segment search stitches with adjacent junctions only
    edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (2, 3)]
    path, n_hops = find_segmented_snake(6, edges, 6)
    assert len(path) == 6
    assert n_hops == validate_snake(path, 6, edges, distinct=True)["n_hops"]


def test_job_decode_pipeline(tmp_path):
    # synthetic raw jobs: 2 instances x 3 time points, 1 incomplete record
    rng = np.random.default_rng(0)
    recs = []
    truth = []
    for i in range(6):
        p1 = 0.1 + 0.1 * i
        bits = [[1 if rng.random() < p1 else 0] for _ in range(400)]
        truth.append(1 - 2 * np.mean([b[0] for b in bits]))
        recs.append({"id": f"j{i}", "created": f"2025-01-0{i+1}",
                     "status": "completed",
                     "measurements": {"c_1_0_0": bits}})
    recs.insert(3, {"id": "bad", "created": "2025-01-09", "status": "failed",
                    "measurements": {}})
    rng.shuffle(recs)
    merged = merge_job_records(recs)
    assert len(merged) == 6 and [r["id"] for r in merged] == [f"j{i}" for i in range(6)]
    series = decode_jobs_to_expectations(merged, jobs_per_instance=3)
    assert len(series) == 2 and len(series[0]) == 3
    np.testing.assert_allclose(np.concatenate(series), truth, atol=1e-12)


def test_counts_expectation_little_endian():
    counts = {"01": 300, "10": 100}  # qubit0 = rightmost char
    z = counts_to_z_expectation(counts, 2)
    np.testing.assert_allclose(z[0], (100 - 300) / 400)
    np.testing.assert_allclose(z[1], (300 - 100) / 400)
    c = measurement_bits_to_counts([[1, 0], [1, 0], [0, 1]])
    assert c == {"01": 2, "10": 1}


def test_device_noise_model_mapping():
    cal = synthetic_eagle_calibration(127, seed=3)
    lay = snake_layout(12, "brisbane")
    m = model_from_calibration(cal, lay["path"], lay["ancilla"])
    assert m.p_1q.shape == (12,) and m.p_2q.shape == (11,)
    assert 0 < m.p_1q.mean() < 0.01 and 0 < m.p_2q.mean() < 0.1
    assert 0 < m.ancilla_interferometric_factor() < 1


def test_device_autocorr_vs_oracle_per_qubit_noise():
    """Device path with uniform p, 1 event/kick, zero 2q/readout noise must
    reproduce the flat-model oracle."""
    from dtc_tpu.core.device_evolve import device_autocorr_forward
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule

    L, T, p = 3, 4, 0.1
    hs, phis = generate_disorder(L, 1, seed=40)
    sched = build_kick_schedule("x", 0.9, T)
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    vals = device_autocorr_forward(
        jnp.asarray(hs[0]), jnp.asarray(phis[0]),
        jnp.full((L,), p), jnp.zeros((L - 1,)),
        sched.angles, keys, L=L, T=T, K=1, q=L // 2,
        dtype_name="complex128", ancilla_factor=(1 - p) ** 6,
        events_per_kick=1)
    mean = np.asarray(vals).mean(axis=0)
    for t in range(T):
        want = oracle.autocorr_dm(L, 0.9, hs[0], phis[0], t, p)
        assert abs(mean[t] - want) < 0.04, (t, mean[t], want)


def test_device_echo_noiseless_identity():
    from dtc_tpu.core.device_evolve import device_autocorr_echo
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule

    L, T = 4, 4
    hs, phis = generate_disorder(L, 1, seed=41)
    sched = build_kick_schedule("x", 0.9, T)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    e = device_autocorr_echo(
        jnp.asarray(hs[0]), jnp.asarray(phis[0]),
        jnp.zeros((L,)), jnp.zeros((L - 1,)),
        sched.angles, keys, jnp.asarray(3),
        L=L, T=T, K=1, q=L // 2, dtype_name="complex128")
    np.testing.assert_allclose(np.asarray(e), 1.0, atol=1e-10)


def test_run_autocorr_fakebackend_mode(tmp_path):
    from dtc_tpu.experiments.autocorr import run_autocorr
    from dtc_tpu.utils.config import SimConfig

    cfg = SimConfig(L=6, tf=4, use_fakebackend=1, n_trajectories=256,
                    dtype="complex128", inst=1)
    r = run_autocorr(cfg, out_dir=str(tmp_path))
    # device noise is weak (1q ~ 2.5e-4): A(0) ~ ancilla+readout factor < 1
    assert 0.9 < r["av_autocorr"][0] < 1.0
    # t=1 echo true mean ~ 0.91 (af ~ 0.946, ~6% 2q-event rate over 2
    # steps); 256-trajectory SEM ~ 0.025 -> 4 sigma band above 0.8
    assert 0.8 < r["av_autocorr_echo"][1] <= 1.0


def test_device_sigma_engine_matches_gather_engine():
    """Gather-free device engine vs the reference gather implementation
    (same noise model, statistical agreement)."""
    from dtc_tpu.core.device_evolve import (
        device_autocorr_forward,
        device_sigma_forward_batch,
    )
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule

    L, T = 4, 5
    hs, phis = generate_disorder(L, 1, seed=45)
    sched = build_kick_schedule("x", 0.9, T)
    p1 = jnp.full((L,), 0.05)
    p2 = jnp.full((L - 1,), 0.1)
    kw = dict(L=L, T=T, q=L // 2, initial_state="vacuum",
              dtype_name="complex128", ancilla_factor=0.9,
              events_per_kick=2)
    keys = jax.random.split(jax.random.PRNGKey(1), 3000)
    a_sigma = np.asarray(device_sigma_forward_batch(
        jnp.asarray(hs[0]), jnp.asarray(phis[0]), p1, p2, sched.angles,
        keys, **kw)).mean(axis=0)
    a_gather = np.asarray(device_autocorr_forward(
        jnp.asarray(hs[0]), jnp.asarray(phis[0]), p1, p2, sched.angles,
        jax.random.split(jax.random.PRNGKey(2), 3000), K=1, **kw)).mean(axis=0)
    # statistical bound: per-engine SEM ~ 0.3/sqrt(3000) ~ 0.0055, combined
    # ~0.008 -> 5 sigma ~ 0.04 (verified vs a 30k-trajectory run: agreement
    # within 2 sigma; the old 0.03 sat inside the expected fluctuation band)
    assert np.all(np.abs(a_sigma - a_gather) < 0.045), (a_sigma, a_gather)


def test_exact_device_graphs():
    """Exact IBM Eagle 127q / Heron-r1 133q / IQM Garnet 20q graphs, in the
    devices' own numbering (derived from the reference's coordinate tables
    and explicit connection lists)."""
    from dtc_tpu.device.layouts import (
        eagle_coupling,
        garnet_coupling,
        heron_coupling,
    )

    n, e, c = eagle_coupling()
    assert (n, len(e)) == (127, 144)
    n, e, c = heron_coupling()
    assert (n, len(e)) == (133, 150)
    # Heron has five degree-1 qubits (corner q14 + the four trailing row-13
    # connectors); a path contains at most two of them as endpoints, so a
    # hop-free 132-node snake cannot exist — hence the reference layout's
    # purple-arrow hops
    deg = {}
    for a, b in e:
        deg[a] = deg.get(a, 0) + 1
        deg[b] = deg.get(b, 0) + 1
    assert sorted(q for q in range(133) if deg[q] == 1) == [
        14, 129, 130, 131, 132]
    n, e, c = garnet_coupling()
    assert (n, len(e)) == (20, 30)


def test_reference_snakes_on_exact_graphs():
    """The reference's shipped snake index lists, replayed on our exact
    graphs: Garnet is a perfect path with the ancilla on the probe; the IBM
    hand snakes carry exactly the stub-detour hops their own renderers mark
    with purple arrows (pinned counts guard graph regressions)."""
    from dtc_tpu.device.layouts import (
        REFERENCE_SNAKES,
        eagle_coupling,
        garnet_coupling,
        heron_coupling,
        validate_snake,
    )

    n, e, _ = garnet_coupling()
    g = REFERENCE_SNAKES["garnet_autocorr"]
    v = validate_snake(g[1:], n, e)
    assert v["n_hops"] == 0 and v["in_range"] and v["distinct"]
    # ancilla (physical 14) adjacent to the probe site q=9 -> chain[9]=18
    assert frozenset((g[0], g[1 + 9])) in {frozenset(x) for x in e}

    n, e, _ = heron_coupling()
    t = REFERENCE_SNAKES["torino_autocorr"]
    assert len(t) == 133 and len(set(t)) == 133
    v = validate_snake(t[1:], n, e)
    assert v["in_range"] and v["n_hops"] == 21, v["n_hops"]
    # the ancilla (74) sits on a connector adjacent to two chain qubits
    eset = {frozenset(x) for x in e}
    assert sum(frozenset((t[0], q)) in eset for q in t[1:]) == 2

    n, e, _ = eagle_coupling()
    b = REFERENCE_SNAKES["brisbane_energy"]
    assert len(b) == 127 and len(set(b)) == 127
    v = validate_snake(b, n, e)
    assert v["in_range"] and v["n_hops"] == 19, v["n_hops"]


def test_snake_search_matches_or_beats_reference():
    """Auto-search on the exact graphs: full-length snakes whose hop counts
    match or beat the reference's hand layouts (21 torino / 19 brisbane /
    0 garnet)."""
    from dtc_tpu.device.layouts import snake_layout, validate_snake

    for dev, L, ref_hops in (("torino", 132, 21), ("brisbane", 127, 19),
                             ("garnet", 19, 0)):
        lay = snake_layout(L, dev)
        v = validate_snake(lay["path"], lay["n"], lay["edges"])
        assert len(lay["path"]) == L and v["distinct"] and v["in_range"]
        assert v["n_hops"] <= ref_hops, (dev, v["n_hops"])


def test_synthetic_calibration_covers_every_snake_bond():
    """Calibrations are keyed by the EXACT device graphs, so every bond of
    a snake layout must find its per-edge 2q error — no silent median
    fallback (the old heavy-hex approximation missed ~1/3 of real edges)."""
    from dtc_tpu.device.layouts import validate_snake

    for device, n_cal, Lq in (("brisbane", 127, 127), ("torino", 133, 132)):
        cal = synthetic_eagle_calibration(n_cal, seed=3)
        lay = snake_layout(Lq, device)
        te = cal["two_qubit_error"]
        hops = {tuple(sorted(hp)) for hp in validate_snake(
            lay["path"], lay["n"], lay["edges"], distinct=True)["hops"]}
        missing = [
            (a, b)
            for a, b in zip(lay["path"], lay["path"][1:])
            if f"{a}-{b}" not in te and f"{b}-{a}" not in te
            and tuple(sorted((a, b))) not in hops  # stitch hops aren't edges
        ]
        assert not missing, (device, missing)


def test_garnet_like_model_and_selector():
    """use_fakebackend=1 Garnet mode: calibration keyed by the exact 20q
    garnet graph, mapped through the garnet snake (IQMFakeGarnet analogue,
    ...-ham-comparison-iqm.py:83); selector rejects unknown devices."""
    import pytest

    from dtc_tpu.models.device_noise import fake_device_model

    m = fake_device_model(19, "garnet", seed=3)
    assert m.L == 19
    assert np.all(m.p_1q > 0) and np.all(m.p_1q < 0.1)
    assert np.all(m.p_2q > 0) and len(m.p_2q) == 18
    assert 0 < m.readout_ancilla < 0.2
    b = fake_device_model(19, "brisbane", seed=3)
    assert not np.allclose(m.p_1q, b.p_1q)  # distinct calibrations
    with pytest.raises(ValueError, match="fake_device"):
        fake_device_model(19, "torino")


def _dense_device_echo_literal(h, ph, p1, p2, theta, key, t_value, *, L, T,
                               q, epk, af):
    """Gate-by-gate dense echo consuming the SAME presampled events as the
    sigma device echo path: kick; 1q events; D_even; even 2q event;
    D_odd; odd event; D_field forward, the exact dagger-reversed order
    inverse (device_inverse_cycle). Measures the PHYSICAL state (no sigma
    bookkeeping at all) — the strongest independent check of the frame
    algebra in device_sigma_echo_batch."""
    from dtc_tpu.core.device_evolve import _device_presample_echo, _masks_split
    from dtc_tpu.core.statevector import initial_statevector
    from dtc_tpu.models.drives import slot_unitary, slot_unitary_inverse
    from dtc_tpu.ops.diag import z_sign_mask
    from dtc_tpu.ops.kick import apply_uniform_1q_layer
    from dtc_tpu.ops.paulis import apply_pauli_string

    dtype = jnp.complex128
    ev = _device_presample_echo(key, p1, p2, epk, jnp.asarray(t_value), T, L)
    xmk, zm1, xme, zme, xmo, zmo = [np.asarray(m) for m in ev[:6]]
    m_even, m_odd, m_field = _masks_split(h, ph, L, dtype)
    u = slot_unitary(theta, jnp.zeros(()), dtype)
    ui = slot_unitary_inverse(theta, jnp.zeros(()), dtype)
    st = initial_statevector(L, "vacuum", dtype=dtype)
    z = jnp.int32(0)
    for k in range(2 * t_value):
        if k < t_value:
            st = apply_uniform_1q_layer(st, u, L)
            st = apply_pauli_string(st, jnp.uint32(xmk[k]), jnp.uint32(zm1[k]), z)
            st = st * m_even
            st = apply_pauli_string(st, jnp.uint32(xme[k]), jnp.uint32(zme[k]), z)
            st = st * m_odd
            st = apply_pauli_string(st, jnp.uint32(xmo[k]), jnp.uint32(zmo[k]), z)
            st = st * m_field
        else:
            st = st * jnp.conj(m_field) * jnp.conj(m_odd)
            st = apply_pauli_string(st, jnp.uint32(xmo[k]), jnp.uint32(zmo[k]), z)
            st = st * jnp.conj(m_even)
            st = apply_pauli_string(st, jnp.uint32(xme[k]), jnp.uint32(zme[k]), z)
            st = apply_uniform_1q_layer(st, ui, L)
            st = apply_pauli_string(st, jnp.uint32(xmk[k]), jnp.uint32(zm1[k]), z)
    zq = z_sign_mask(q, L)
    return af * float(jnp.sum(jnp.abs(st) ** 2 * zq.astype(jnp.float64)))


def test_device_sigma_echo_matches_dense_literal():
    """device_sigma_echo_batch (gather-free, frame-corrected eager masks)
    vs the literal gate-by-gate dense evolution with identical presampled
    events: exact agreement at complex128."""
    from dtc_tpu.core.device_evolve import device_sigma_echo_batch
    from dtc_tpu.io.disorder import generate_disorder
    from dtc_tpu.models.drives import build_kick_schedule

    L, T, epk, af = 6, 4, 2, 0.9
    hs, phis = generate_disorder(L, 1, seed=11)
    h, ph = jnp.asarray(hs[0]), jnp.asarray(phis[0])
    p1 = jnp.linspace(0.1, 0.4, L)
    p2 = jnp.linspace(0.15, 0.5, L - 1)
    sched = build_kick_schedule("x", 0.93, T)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    ts = jnp.asarray([1, 2, 3, 4])
    vals = np.asarray(device_sigma_echo_batch(
        h, ph, p1, p2, sched.angles, keys, ts, L=L, T=T, q=L // 2,
        dtype_name="complex128", ancilla_factor=af, events_per_kick=epk))
    for ci, key in enumerate(keys):
        for ti, t in enumerate((1, 2, 3, 4)):
            want = _dense_device_echo_literal(
                h, ph, p1, p2, sched.angles[0, 0, 0], key, t,
                L=L, T=T, q=L // 2, epk=epk, af=af)
            assert abs(vals[ci, ti] - want) < 1e-12, (ci, t, vals[ci, ti], want)
    # noiseless: A0(t) == ancilla_factor exactly
    e0 = np.asarray(device_sigma_echo_batch(
        h, ph, jnp.zeros((L,)), jnp.zeros((L - 1,)), sched.angles, keys[:1],
        ts, L=L, T=T, q=L // 2, dtype_name="complex128", ancilla_factor=af,
        events_per_kick=epk))
    np.testing.assert_allclose(e0, af, atol=1e-12)


def test_qiskit_properties_import_roundtrip(tmp_path):
    """C9 calibration ingest: a Qiskit BackendProperties.to_dict() snapshot
    (the schema FakeBrisbane().properties() exports — what the reference's
    NoiseModel.from_backend consumes, fast.py:77-79) converts into the
    native calibration schema and drives fake_device_model via
    calibration_path, mapped through the same snake layout."""
    import json

    from dtc_tpu.device.layouts import eagle_coupling
    from dtc_tpu.models.device_noise import (
        fake_device_model,
        qiskit_properties_to_calibration,
    )

    n, edges, _ = eagle_coupling()
    props = {
        "qubits": [
            [{"name": "T1", "value": 250.0, "unit": "us"},
             {"name": "readout_error", "value": 0.01 + 1e-5 * i}]
            for i in range(n)
        ],
        "gates": (
            [{"gate": "sx", "qubits": [i],
              "parameters": [{"name": "gate_error", "value": 2e-4 + 1e-8 * i},
                             {"name": "gate_length", "value": 60.0}]}
             for i in range(n)]
            + [{"gate": "rz", "qubits": [i],
                "parameters": [{"name": "gate_error", "value": 0.0}]}
               for i in range(n)]
            + [{"gate": "ecr", "qubits": [a, b],
                "parameters": [{"name": "gate_error",
                                "value": 8e-3 + 1e-7 * (a + b)}]}
               for a, b in edges]
        ),
    }
    cal = qiskit_properties_to_calibration(props)
    assert cal["n_qubits"] == n
    assert cal["single_qubit_error"]["5"] == 2e-4 + 1e-8 * 5  # sx, not rz
    a, b = edges[0]
    assert cal["two_qubit_error"][f"{a}-{b}"] == 8e-3 + 1e-7 * (a + b)
    assert cal["readout_error"]["3"] == 0.01 + 3e-5

    path = tmp_path / "props.json"
    path.write_text(json.dumps(props))
    m = fake_device_model(8, "brisbane", calibration_path=str(path))
    assert m.L == 8
    # values must come from the snapshot (the sx band), not the synthetic
    # log-normal calibration
    assert np.all((m.p_1q >= 2e-4) & (m.p_1q <= 2e-4 + 1e-8 * n))
    assert np.all((m.p_2q >= 8e-3) & (m.p_2q <= 8e-3 + 1e-7 * 2 * n))
    assert np.all(np.abs(m.readout - 0.01) <= 1e-5 * n)


