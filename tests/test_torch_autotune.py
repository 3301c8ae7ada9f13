"""The port's chunk-size autotune and its on-disk cache
(`repro_torch.bench.common.batch_size`), against the reference's
(`benchmarks/common.py`): the reference's four cases
(`tests/test_campaign.py`: the cache round trip, a corrupt file probed
again, a stale key missed, `REPRO_BENCH_BATCH` over the cache), and the
port's own: a key a device (a CPU and a card share one file), the CPU's
ladder and probe grid equal to the reference's, the card's candidates
each a chunking of their own, and `Bench.sweep` running at the resolved
value. No case runs the real probe (each replaces `_probe_batch_size`
or the sweeps it times), and the cache lives in `tmp_path`.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import common, run as bench_run  # noqa: E402
from repro_torch.core import campaign as camp  # noqa: E402
from repro_torch.core import simulator as sim, workloads  # noqa: E402

CARD = "Stand-in H100 80GB HBM3"


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_BENCH_BATCH", raising=False)
    monkeypatch.delenv("REPRO_BENCH_DEVICES", raising=False)
    common._autotuned.cache_clear()
    yield tmp_path
    common._autotuned.cache_clear()


def _no_probe(reason):
    return lambda device: pytest.fail(f"probe ran {reason}")


def _stand_in_card(monkeypatch):
    """torch sees one card named `CARD`; nothing is launched on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: CARD)


def test_autotune_cache_roundtrip(monkeypatch):
    monkeypatch.setattr(common, "_probe_batch_size", lambda device: 12)
    assert common.resolve_batch_size("cpu") == (12, "probe")
    with open(common._autotune_cache_path()) as f:
        assert f.read().count("12")
    # second process (simulated): the cache must answer without probing
    common._autotuned.cache_clear()
    monkeypatch.setattr(common, "_probe_batch_size",
                        _no_probe("despite a warm cache"))
    assert common.resolve_batch_size("cpu") == (12, "cache")
    assert common.batch_size("cpu") == 12


def test_autotune_cache_corrupt_file_reprobes(monkeypatch, capsys):
    with open(common._autotune_cache_path(), "w") as f:
        f.write("{ not json")
    monkeypatch.setattr(common, "_probe_batch_size", lambda device: 24)
    assert common.batch_size("cpu") == 24
    assert "unreadable; deleting and re-probing" in capsys.readouterr().out
    with open(common._autotune_cache_path()) as f:
        cache = json.load(f)          # re-written, valid again
    assert cache == {common._autotune_key("cpu"): 24}


def test_autotune_cache_stale_key_misses(monkeypatch):
    camp.atomic_write_json(common._autotune_cache_path(),
                           {"cuda|Other card|dev8|torch9.9.9": 256})
    monkeypatch.setattr(common, "_probe_batch_size", lambda device: 8)
    assert common.batch_size("cpu") == 8   # stale entry ignored
    with open(common._autotune_cache_path()) as f:
        cache = json.load(f)
    assert cache["cuda|Other card|dev8|torch9.9.9"] == 256   # kept


def test_env_batch_overrides_cache(monkeypatch):
    camp.atomic_write_json(common._autotune_cache_path(),
                           {common._autotune_key("cpu"): 64})
    monkeypatch.setenv("REPRO_BENCH_BATCH", "6")
    monkeypatch.setattr(common, "_probe_batch_size",
                        _no_probe("despite REPRO_BENCH_BATCH"))
    assert common.resolve_batch_size("cpu") == (6, "env")
    monkeypatch.setenv("REPRO_BENCH_BATCH", "0")
    with pytest.raises(ValueError, match="must be a positive integer"):
        common.batch_size("cpu")


def test_cpu_and_card_keys_coexist(monkeypatch):
    """A CPU and a card are keyed apart (the card by its name), resolved
    once each in a process, and kept side by side in one file."""
    _stand_in_card(monkeypatch)
    probed = []

    def probe(device):
        probed.append(str(device))
        return {"cpu": 16, "cuda": 1024}[str(device)]

    monkeypatch.setattr(common, "_probe_batch_size", probe)
    cpu_key, card_key = (common._autotune_key("cpu"),
                         common._autotune_key("cuda"))
    assert cpu_key == f"cpu|cpu|dev1|torch{torch.__version__}"
    assert card_key == f"cuda|{CARD}|dev1|torch{torch.__version__}"
    for _ in range(2):
        assert common.batch_size("cpu") == 16
        assert common.batch_size("cuda") == 1024
    assert probed == ["cpu", "cuda"]
    with open(common._autotune_cache_path()) as f:
        assert json.load(f) == {cpu_key: 16, card_key: 1024}


class _Recorder:
    """Stands in for the workload suite and the sweep of a probe: records
    the frames, the cells and each sweep's chunk size, runs nothing."""

    def __init__(self):
        self.frames, self.cells, self.batches = [], [], []

    def suite(self, n_instances):
        self.frames.append(n_instances)
        return types.SimpleNamespace(
            build_many=lambda cells: self.cells.append(list(cells)))

    def run_batch(self, mode, stacked, params, batch_size=None, **kw):
        assert mode == sim.MODE_LUT
        self.batches.append(batch_size)
        return types.SimpleNamespace(avg_exec_us=np.zeros(1))


def test_cpu_ladder_and_probe_grid_are_the_references(monkeypatch):
    """`batch_size("cpu")` probes the reference's ladder on the
    reference's grid (8 mixes x 4 rates at 6 frames), a warm-up and a
    timed LUT sweep a candidate, as `benchmarks.common` does."""
    jcommon = pytest.importorskip("benchmarks.common")
    ref, mine = _Recorder(), _Recorder()
    monkeypatch.setattr(jcommon.workloads, "default_suite", ref.suite)
    monkeypatch.setattr(jcommon.sim, "run_batch", ref.run_batch)
    jcommon._probe_batch_size("cpu")
    monkeypatch.setattr(common.workloads, "default_suite", mine.suite)
    monkeypatch.setattr(common.sim, "run_batch", mine.run_batch)
    monkeypatch.setattr(common.sim, "to_numpy", lambda r: r)
    assert common.resolve_batch_size("cpu")[1] == "probe"
    assert mine.frames == ref.frames == [6]
    assert mine.cells == ref.cells and len(mine.cells[0]) == 32
    assert mine.batches == ref.batches
    assert common._BATCH_CANDIDATES["cpu"] == \
        jcommon._BATCH_CANDIDATES["cpu"] == (8, 16, 32)
    assert mine.batches == [b for b in (8, 16, 32) for _ in range(2)]


def test_card_candidates_are_distinct_chunkings(monkeypatch):
    """On the card's probe grid each candidate cuts the sweep into a
    chunk count of its own (on the reference's 32 scenarios every
    candidate from 32 up would be one chunk), and one candidate runs
    every sweep of the benchmark (560 scenarios at most) as one chunk."""
    cands = common._BATCH_CANDIDATES["cuda"]
    n = len(common._probe_cells("cuda"))
    assert n == 40 * 14 and len(set(common._probe_cells("cuda"))) == n
    chunks = [-(-n // min(b, n)) for b in cands]
    assert len(set(chunks)) == len(cands) and chunks[-1] == 1
    assert max(cands) >= 560
    _stand_in_card(monkeypatch)
    rec = _Recorder()
    monkeypatch.setattr(common.workloads, "default_suite", rec.suite)
    monkeypatch.setattr(common.sim, "run_batch", rec.run_batch)
    monkeypatch.setattr(common.sim, "to_numpy", lambda r: r)
    monkeypatch.setattr(common.sim, "make_params", lambda device: None)
    assert common.resolve_batch_size("cuda")[1] == "probe"
    assert rec.cells == [common._probe_cells("cuda")]
    assert rec.batches == [b for b in cands for _ in range(2)]


def test_bench_sweep_runs_at_the_resolved_value(monkeypatch):
    """`Bench.sweep` cuts its sweep at `batch_size(device)`, probed once
    for all its sweeps, and `bench.run`'s record names the value and
    where it came from."""
    probed = []
    monkeypatch.setattr(common, "_probe_batch_size",
                        lambda device: probed.append(device) or 2)
    bench = common.Bench("cpu", n_instances=4)
    cells = [(0, 0), (1, 7), (5, 13), (3, 5), (4, 9)]
    stacked = workloads.stack_workloads(
        [bench.cell_workload(*c) for c in cells])
    bench.sweep(sim.MODE_LUT, stacked, cells=cells)
    bench.sweep(sim.MODE_LUT, stacked, cells=cells)
    assert [c["n_chunks"] for c in bench.campaigns] == [3, 3]
    assert probed == ["cpu"]
    env = bench_run.env_record(bench, full_grid=True)
    assert (env["batch_size"], env["batch_size_source"]) == (2, "probe")
