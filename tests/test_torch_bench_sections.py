"""The port's benchmark sections against the same computation through the
JAX package's `repro.core`, on a `Bench` at 10 frames trained on a
3-mix grid; then the harness `repro_torch.bench.run` and its record.

Each section's own evaluation grid is kept (the paper's mixes and
rates); only the training grid and the frames are cut. On the JAX side
the sweeps of all sections run merged, one batched sweep per mode in
chunks of one size, so each mode compiles once: a scenario's result does
not depend on its chunk (`tests/test_batch.py`). Counts, thresholds and
decision-tree accuracies must be equal, logistic-regression accuracies
within 1e-3 (`tests/test_torch_oracle_das.py`), every other float within
1e-6 relative (XLA's FMAs in the energy sums, its order in the latency
mean).
"""
import functools
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import classifier as jclf, das as jdas  # noqa: E402
from repro.core import faults as jf, oracle as joracle  # noqa: E402
from repro.core import simulator as jsim, workloads as jwl  # noqa: E402
from repro_torch.bench import common, faults, fig2, fig3, heuristic  # noqa: E402
from repro_torch.bench import overhead, run as bench_run, table2  # noqa: E402
from repro_torch.core import simulator as sim, soc  # noqa: E402

N_INST = 10
TRAIN_MIXES, TRAIN_RATES = (0, 1, 2), (0, 1, 2, 11, 12, 13)
CHUNK = len(TRAIN_MIXES) * len(TRAIN_RATES)   # every JAX sweep's chunk
REL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


# a chunk size above every sweep here: one chunk a sweep, as on the JAX
# side, and the chunk-size autotune's probe never runs
ONE_CHUNK = 1 << 20


@pytest.fixture(autouse=True, scope="module")
def _one_chunk_a_sweep():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_BENCH_BATCH", str(ONE_CHUNK))
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors here are tiny: one intra-op thread is faster
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the port: one Bench, every section on it
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _bench():
    return common.Bench("cpu", n_instances=N_INST, train_mixes=TRAIN_MIXES,
                        train_rates=TRAIN_RATES)


@functools.lru_cache(maxsize=None)
def _section(name):
    mod = {"fig2": fig2, "fig3": fig3, "table2": table2,
           "heuristic": heuristic, "overhead": overhead,
           "faults": faults}[name]
    return mod.run(_bench())


# ---------------------------------------------------------------------------
# the reference: the same pipeline through repro.core
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jsuite():
    return jwl.default_suite(n_instances=N_INST)


@functools.lru_cache(maxsize=None)
def _jds():
    return joracle.generate(_jsuite(), mix_indices=TRAIN_MIXES,
                            rate_indices=TRAIN_RATES, batch_size=CHUNK)


@functools.lru_cache(maxsize=None)
def _jpolicies():
    """The paper-pair policy and the greedy-selected one
    (`benchmarks/common.py`'s `das_policy` and `das_policy_auto`)."""
    ds = _jds()
    tr, _ = joracle.train_test_split(ds)
    idx = np.random.RandomState(0).permutation(len(tr))[:6000]
    sel = jclf.greedy_select(tr.features[idx], tr.labels[idx], k=2)
    return jdas.fit_policy(ds), jdas.fit_policy(ds, feature_ids=sel)


def _np(res):
    return jsim.SimResult(*[np.asarray(x) for x in res])


def _jgrid(mode, cells, trees=None, thr=None, plan=None):
    """One JAX sweep of `mode` over `cells`, per-lane trees and
    thresholds, in chunks of `CHUNK`."""
    kw = {}
    if trees is not None:
        kw["tree"] = jsim.DTree(*[np.stack([np.asarray(getattr(t, f))
                                            for t in trees])
                                  for f in jsim.DTree._fields])
    if thr is not None:
        kw["rate_threshold"] = np.asarray(thr, np.float32)
    stacked = jwl.stack_workloads([_jsuite().build(*c) for c in cells])
    return _np(jsim.run_batch(mode, stacked, batch_size=CHUNK, plan=plan,
                              **kw))


FIG2_CELLS = [(mi, ri) for _, mi in fig2.WL for ri in fig2.RATE_IDX]
FIG3_CELLS = [(fig3.MIX, ri) for ri in range(14)]
HEUR_CELLS = [(mi, ri) for mi in heuristic.MIXES
              for ri in heuristic.EVAL_RATES]
OVERHEAD_CELL = [(5, 12)]


@functools.lru_cache(maxsize=None)
def _jmerged():
    """Every section's evaluation sweeps, merged by mode: returns
    {(section, mode name): per-lane numpy results}."""
    pol, auto = _jpolicies()
    out = {}
    base = FIG2_CELLS + FIG3_CELLS
    for name, mode in (("LUT", sim.MODE_LUT), ("ETF", sim.MODE_ETF),
                       ("ETF-ideal", sim.MODE_ETF_IDEAL)):
        r = _jgrid(mode, base)
        out["fig2", name] = sim.result_at(r, slice(0, len(FIG2_CELLS)))
        out["fig3", name] = sim.result_at(r, slice(len(FIG2_CELLS), None))
    das_cells = FIG2_CELLS + FIG2_CELLS + FIG3_CELLS + HEUR_CELLS \
        + OVERHEAD_CELL
    trees = [pol.tree] * len(das_cells)
    trees[len(FIG2_CELLS):2 * len(FIG2_CELLS)] = [auto.tree] * len(
        FIG2_CELLS)
    r = _jgrid(sim.MODE_DAS, das_cells, trees=trees)
    n2, n3, nh = len(FIG2_CELLS), len(FIG3_CELLS), len(HEUR_CELLS)
    out["fig2", "DAS"] = sim.result_at(r, slice(0, n2))
    out["fig2", "DAS-FS"] = sim.result_at(r, slice(n2, 2 * n2))
    out["fig3", "DAS"] = sim.result_at(r, slice(2 * n2, 2 * n2 + n3))
    out["heuristic", "DAS"] = sim.result_at(
        r, slice(2 * n2 + n3, 2 * n2 + n3 + nh))
    out["overhead", "DAS"] = sim.result_at(r, -1)
    # the threshold: candidates x the selection grid, one lane each
    cand = np.unique(np.asarray(_jds().rates, np.float32))
    sel = [(mi, ri) for mi in heuristic.MIXES
           for ri in heuristic.SELECT_RATES]
    rs = _jgrid(sim.MODE_THRESHOLD, sel * len(cand),
                thr=np.repeat(cand, len(sel)))
    thr = float(cand[np.argmin(rs.avg_exec_us.reshape(
        len(cand), len(sel)).mean(axis=1))])
    out["heuristic", "threshold"] = thr
    out["heuristic", "THR"] = _jgrid(sim.MODE_THRESHOLD, HEUR_CELLS,
                                     thr=[thr] * nh)
    # the degradation curves
    ks = list(range(len(faults.ACCEL_PES) + 1))
    plan = jf.stack_plans([
        jf.fail_pes(jf.healthy_plan(), faults.ACCEL_PES[:k].tolist(),
                    at=0.0) if k else jf.healthy_plan() for k in ks])
    cells = [(faults.MIX_IDX, faults.RATE_IDX)] * len(ks)
    for name, mode in (("LUT", sim.MODE_LUT), ("ETF", sim.MODE_ETF),
                       ("DAS", sim.MODE_DAS)):
        trees = [pol.tree] * len(ks) if mode == sim.MODE_DAS else None
        out["faults", name] = _jgrid(mode, cells, trees=trees, plan=plan)
    return out


def _close(got, want, tag):
    assert got == pytest.approx(want, rel=REL, abs=0), tag


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------
def test_bench_trains_the_reference_policies():
    pol, auto = _jpolicies()
    for jp, tp in ((pol, _bench().das_policy()),
                   (auto, _bench().das_policy_auto())):
        for f in jsim.DTree._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jp.tree, f)),
                                          getattr(tp.tree, f).numpy())
        assert list(jp.feature_ids) == list(tp.feature_ids)
    assert np.asarray(pol.tree.leaf).min() == 0 and \
        np.asarray(pol.tree.leaf).max() == 1     # DAS takes both


def test_fig2_matches_jax():
    rows = _section("fig2")
    ref = _jmerged()
    assert len(rows) == len(FIG2_CELLS)
    for k, (row, (mi, ri)) in enumerate(zip(rows, FIG2_CELLS)):
        title = [t for t, m in fig2.WL if m == mi][0]
        assert row["workload"] == title
        assert row["rate_mbps"] == float(jwl.DATA_RATES_MBPS[ri])
        for name in ("LUT", "ETF", "ETF-ideal", "DAS", "DAS-FS"):
            r = sim.result_at(ref["fig2", name], k)
            _close(row[f"exec_{name}"], float(r.avg_exec_us), (k, name))
            _close(row[f"edp_{name}"], float(r.edp), (k, name))


def test_fig3_matches_jax():
    rows = _section("fig3")
    ref = _jmerged()
    for ri, row in enumerate(rows):
        d = sim.result_at(ref["fig3", "DAS"], ri)
        n = max(int(d.n_decisions), 1)
        assert row["fast_frac"] == int(d.n_fast) / n
        assert row["slow_frac"] == 1 - int(d.n_fast) / n
        _close(row["das_ns_per_decision"], float(d.sched_time_us) / n * 1e3,
               ri)
        _close(row["das_nj_per_decision"],
               float(d.sched_energy_uj) / n * 1e3, ri)
        for name, key in (("LUT", "sched_e_lut"), ("ETF", "sched_e_etf"),
                          ("DAS", "sched_e_das")):
            _close(row[key], float(sim.result_at(
                ref["fig3", name], ri).sched_energy_uj), (ri, key))
    assert 0 < rows[-1]["slow_frac"]      # the tree picks the slow path


def test_table2_matches_jax():
    """`benchmarks/table2.py`'s classifiers on the reference's dataset."""
    rows = _section("table2")
    tr, te = joracle.train_test_split(_jds())
    sub = np.random.RandomState(0).permutation(len(tr))[:20000]
    Xs, ys = tr.features[sub], tr.labels[sub]
    order = np.argsort(-jclf.feature_scores(Xs[:4000], ys[:4000], depth=2))
    top6 = [int(i) for i in order[:6]]
    paper2 = [sim.FEAT_RATE, sim.FEAT_BIG_AVAIL]
    allc = list(range(Xs.shape[1]))
    want = [jclf.LogisticRegression.fit(Xs[:, paper2], ys),
            jclf.LogisticRegression.fit(Xs, ys),
            jclf.DecisionTree.fit(Xs[:, [sim.FEAT_RATE]], ys, 2),
            jclf.DecisionTree.fit(Xs[:, paper2], ys, 2),
            jclf.DecisionTree.fit(Xs[:, top6[:2]], ys, 2),
            jclf.DecisionTree.fit(Xs[:, top6], ys, 4),
            jclf.DecisionTree.fit(Xs, ys, 16)]
    cols = [paper2, allc, [sim.FEAT_RATE], paper2, top6[:2], top6, allc]
    assert len(rows) == len(want)
    for row, model, c in zip(rows, want, cols):
        acc = model.accuracy(te.features[:, c], te.labels)
        assert row["n_features"] == len(c)
        assert row["storage_kb"] == model.storage_kb(), row["classifier"]
        if row["classifier"].startswith("LR"):
            assert abs(row["accuracy"] - acc) <= 1e-3, row["classifier"]
        else:
            assert row["accuracy"] == acc, row["classifier"]


def test_heuristic_matches_jax():
    got = _section("heuristic")
    ref = _jmerged()
    assert got["threshold"] == ref["heuristic", "threshold"]
    gains = (ref["heuristic", "THR"].avg_exec_us.astype(np.float64)
             / ref["heuristic", "DAS"].avg_exec_us.astype(np.float64))
    assert got["total"] == len(HEUR_CELLS)
    assert got["das_wins"] == int((gains >= 1.0).sum())
    _close(got["mean_gain"], float(np.mean(gains)), "mean_gain")
    labels = [s["label"] for s in _bench().sweeps]
    assert "heuristic-select" in labels


def test_overhead_matches_jax():
    got = _section("overhead")
    d = _jmerged()["overhead", "DAS"]
    n = max(int(d.n_decisions), 1)
    assert got["LUT_ns"] == float(soc.LUT_LATENCY_US) * 1e3
    assert got["LUT_nJ"] == float(soc.LUT_ENERGY_UJ) * 1e3
    assert got["ETF_ns_q8"] == float(soc.etf_latency_us(8)) * 1e3
    _close(got["DAS_heavy_ns"], float(d.sched_time_us) / n * 1e3, "ns")
    _close(got["DAS_heavy_nJ"], float(d.sched_energy_uj) / n * 1e3, "nJ")
    # on the CPU only the plain versions are timed, at both shapes
    assert got["path_batch"] == CHUNK
    timed = sorted(k for k in got if "_us_per_" in k)
    assert timed == sorted(f"etf_ft{m}_plain_us_per_{s}"
                           for m in ("", "_masked")
                           for s in ("batch64", "path_batch"))
    assert all(got[k] > 0 for k in timed)


def test_faults_section_matches_jax():
    got = _section("faults")
    ref = _jmerged()
    assert got["ok"] is True
    for name, curve in got["curves"].items():
        r = ref["faults", name]
        assert curve["k"] == list(range(len(faults.ACCEL_PES) + 1))
        assert curve["dropped_jobs"] == r.n_dropped_jobs.tolist() \
            == [0] * len(curve["k"])
        assert curve["retries"] == r.n_retries.tolist()
        for a, b in zip(curve["avg_exec_us"], r.avg_exec_us):
            _close(a, float(b), name)
        for a, b in zip(curve["edp"], r.edp):
            _close(a, float(b), name)
        assert curve["monotone"] == faults._monotone(
            [float(x) for x in r.avg_exec_us])
    assert set(got["curves"]) == {"LUT", "ETF", "DAS"}
    assert got["curves"]["LUT"]["avg_exec_us"][-1] > \
        got["curves"]["LUT"]["avg_exec_us"][0]


# ---------------------------------------------------------------------------
# the harness and its record
# ---------------------------------------------------------------------------
def _small(monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_INSTANCES", "4")
    monkeypatch.setenv("REPRO_BENCH_FULL", "0")


def test_bench_run_writes_its_record(tmp_path, monkeypatch):
    _small(monkeypatch)
    path = tmp_path / "sub" / "record.json"
    bench_run.main(["--device", "cpu", "--only", "summary40,overhead",
                    "--json", str(path)])
    rec = json.loads(path.read_text())
    assert set(rec) == {"total_s", "env", "derived", "campaign", "kernels",
                        "sweeps", "not_ported", "sections"}
    assert rec["env"]["device"] == "cpu" and rec["env"]["n_instances"] == 4
    assert rec["env"]["n_devices"] == 1
    assert rec["env"]["batch_size"] == ONE_CHUNK
    assert rec["env"]["batch_size_source"] == "env"
    assert rec["env"]["train_grid"] == [len(common.SUBSET_MIXES),
                                        len(common.SUBSET_RATES)]
    assert rec["env"]["torch"] == torch.__version__
    assert set(rec["derived"]) == set(bench_run.summary40.DERIVED)
    assert set(rec["sections"]) == {"summary40", "overhead"}
    for sec in rec["sections"].values():
        assert sec["wall_s"] > 0 and "result" in sec
    assert rec["sections"]["summary40"]["result"]["n_mixes"] == 14
    # the plain versions count no launch
    assert set(rec["kernels"]) == set(bench_run.ops.LAUNCHES)
    assert not any(rec["kernels"].values())
    assert rec["not_ported"] == {}
    labels = {s["label"] for s in rec["sweeps"]}
    assert {"oracle oracle", "oracle ETF", "grid DAS-EDP"} <= labels
    # every sweep went through the campaign: one chunk each, none reused
    camp = rec["campaign"]
    assert camp["n_sweeps"] == len(rec["sweeps"]) == camp["n_chunks"]
    assert camp["chunks_computed"] == camp["n_chunks"]
    assert not (camp["retries"] or camp["timeouts"] or camp["oom_events"]
                or camp["chunks_reused"] or camp["checkpoint_bytes"])
    assert 0 < camp["occupancy"] <= 1
    assert camp["steps"] == sum(s["steps"] for s in rec["sweeps"])


def test_bench_run_resume_reuses_every_chunk(tmp_path, monkeypatch):
    """`bench.run --resume DIR` checkpoints every sweep's chunks; the same
    command again reuses all of them and gives the same sections."""
    _small(monkeypatch)
    recs = []
    for k in (1, 2):
        path = tmp_path / f"record_{k}.json"
        bench_run.main(["--device", "cpu", "--only", "faults,serving_das",
                        "--resume", str(tmp_path / "ckpt"), "--json",
                        str(path)])
        recs.append(json.loads(path.read_text()))
    first, again = (r["campaign"] for r in recs)
    assert first["chunks_computed"] == first["n_chunks"] > 0
    assert first["checkpoint_bytes"] > 0
    assert again["chunks_reused"] == first["n_chunks"]
    assert again["chunks_computed"] == 0
    results = [{k: v["result"] for k, v in r["sections"].items()}
               for r in recs]
    assert results[0] == results[1] and set(results[0]) == {
        "faults", "serving_das"}
    assert recs[1]["env"]["campaign_dir"] == str(tmp_path / "ckpt")


def test_bench_run_refuses_the_reference_record(monkeypatch):
    ref = ROOT / "benchmarks" / "BENCH_sweep.json"
    before = ref.read_bytes()
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit, match="refusing"):
        bench_run.main(["--device", "cpu", "--json",
                        "benchmarks/BENCH_sweep.json"])
    with pytest.raises(SystemExit, match="unknown"):
        bench_run.main(["--device", "cpu", "--only", "fig9"])
    assert ref.read_bytes() == before


def test_faults_smoke_cli(monkeypatch, capsys):
    """`python -m repro_torch.bench.faults --smoke`: four points, LUT and
    ETF, no training; it exits 0 when the checks pass."""
    _small(monkeypatch)
    faults.main(["--device", "cpu", "--smoke"])
    out = capsys.readouterr().out
    assert "k=11" in out and "DAS" not in out.split("check")[0]
