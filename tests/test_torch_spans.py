"""The port's spans: the host phases of a campaign and of each engine call
(`repro_torch.core.campaign.Span`, `simulator.ENGINE_SPANS`), on the
CPU at `tests/test_torch_campaign.py`'s size.

A campaign's spans are well formed (each inside its parent, the chunks'
attempts as run), leave the results bit for bit those of `run_batch`,
keep a failed attempt, and carry the stats' seconds; the engine's graph
path, with the capture stood in for by an eager block, times one eager
block, one capture and one stretch of replays the first call of a shape,
and a setup and one stretch of replays each later call, which replays
the kept graph (its record's `graph` is "hit").
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import campaign as camp, faults as flt  # noqa: E402
from repro_torch.core import simulator as sim, workloads  # noqa: E402

PARAMS = sim.make_params(device="cpu")
SUITE = workloads.default_suite(n_instances=4)
CELLS = [(0, 0), (1, 7), (5, 13), (3, 5), (4, 9)]
WLS = [SUITE.build(mi, ri) for mi, ri in CELLS]
FAST = camp.RetryPolicy(backoff_base_s=0.0, backoff_max_s=0.0,
                        jitter_frac=0.0)
CAMPAIGN_SPANS = ("campaign.run", "campaign.prepare", "campaign.chunk",
                  "campaign.backoff", "campaign.checkpoint_read",
                  "campaign.checkpoint_write", "campaign.to_host",
                  "campaign.reassemble")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_kept_graphs():
    """Each test starts and ends with no captured block kept."""
    sim.clear_graph_cache()
    yield
    sim.clear_graph_cache()


@functools.lru_cache(maxsize=None)
def _ref(mode, plans=False):
    return sim.to_numpy(sim.run_batch(mode, WLS, PARAMS, device="cpu",
                                      plan=_plans() if plans else None))


def _plans():
    return flt.stack_plans([flt.random_plan(s, deadline_us=3000.0)
                            for s in range(len(WLS))])


def _campaign(mode=sim.MODE_LUT, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("retry", FAST)
    return camp.run_campaign(mode, WLS, PARAMS, device="cpu", **kw)


def _assert_bit_exact(ref, out):
    for name in sim.SimResult._fields:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(out, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def _parent(spans, s):
    """The span that `s` names as its parent."""
    found = [p for p in spans if p.name == s.parent
             and (p.chunk is None or p.chunk == s.chunk)]
    assert len(found) == 1, (s, found)
    return found[0]


def _assert_well_formed(spans):
    assert spans[0].name == "campaign.run" and spans[0].parent is None
    assert [s for s in spans if s.parent is None] == spans[:1]
    for s in spans:
        assert isinstance(s, camp.Span), s
        assert s.name in CAMPAIGN_SPANS + sim.ENGINE_SPANS, s
        assert s.start_ns <= s.end_ns, s
        if s.parent is not None:
            p = _parent(spans, s)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        assert (s.outcome is not None) == (s.name == "campaign.chunk"), s
    # each engine call's phases follow one another, end to end
    inner = [s for s in spans if s.name in sim.ENGINE_SPANS]
    for a, b in zip(inner, inner[1:]):
        if a.chunk == b.chunk and b.name != "engine.setup":
            assert a.end_ns == b.start_ns, (a, b)


@pytest.mark.parametrize("mode,batch,pack,plans", [
    (sim.MODE_LUT, 2, True, False),
    (sim.MODE_ETF, 2, False, False),
    (sim.MODE_ETF, 5, None, False),
    (sim.MODE_LUT, 3, True, True),
], ids=["lut-3-chunks-packed", "etf-3-chunks", "etf-1-chunk",
        "lut-2-chunks-plans"])
def test_campaign_spans_are_well_formed(mode, batch, pack, plans):
    out = _campaign(mode, batch_size=batch, pack=pack,
                    plan=_plans() if plans else None)
    spans = out.stats["spans"]
    _assert_well_formed(spans)
    n = out.stats["n_chunks"]
    chunks = [s for s in spans if s.name == "campaign.chunk"]
    assert [s.chunk for s in chunks] == [(ci, 0) for ci in range(n)]
    assert {s.outcome for s in chunks} == {"ok"}
    names = [s.name for s in spans]
    for one in ("campaign.prepare", "campaign.reassemble"):
        assert names.count(one) == 1
    assert names.count("campaign.to_host") == n
    assert names.count("engine.setup") == names.count("engine.finalize") == n
    # on the CPU every block runs eagerly: no capture, no replays
    assert "engine.capture" not in names and "engine.replays" not in names
    assert names.count("engine.eager_block") * sim.POLL_EVERY \
        == out.stats["steps"]
    _assert_bit_exact(_ref(mode, plans), out.result)


def _stand_in_capture(block, s, it):
    """`simulator._capture` without a card: the replay runs the block
    eagerly and copies its result into the buffers, as a graph replay
    leaves them."""
    def replay():
        out, out_it = block(s, it)
        for buf, new in zip(s, out):
            if new is not buf:
                buf.copy_(new)
        it.copy_(out_it)
    return replay


@pytest.mark.parametrize("mode,plans", [
    (sim.MODE_LUT, False), (sim.MODE_ETF, False), (sim.MODE_ETF, True),
], ids=["lut", "etf", "etf-plans"])
def test_graph_path_spans_one_capture_a_call(mode, plans, monkeypatch):
    monkeypatch.setattr(sim, "_capture", _stand_in_capture)
    tel = []
    res = sim.to_numpy(sim._run_batch(
        functools.partial(sim._simulate, graph=True), mode, WLS, PARAMS,
        batch_size=2, plan=_plans() if plans else None, device="cpu",
        telemetry=tel))
    assert len(tel) == 3
    # the first part of a key captures, the next ones replay its graph
    # (the fault phases and the drops' `W` that a part builds are keys)
    assert tel[0]["graph"] == "captured"
    if not plans:
        assert [r["graph"] for r in tel[1:]] == ["hit", "hit"]
    for rec in tel:
        names = [n for n, _, _ in rec["spans"]]
        blocks = rec["steps"] // sim.POLL_EVERY
        if rec["graph"] == "captured":
            assert names == list(sim.ENGINE_SPANS), names
            assert blocks >= 2 and rec["replays"] == blocks - 1, rec
        else:
            assert rec["graph"] == "hit", rec
            assert names == ["engine.setup", "engine.replays",
                             "engine.finalize"], names
            assert blocks >= 1 and rec["replays"] == blocks, rec
        assert rec["spans"][0][1] == rec["start_ns"]
        for (_, a0, a1), (_, b0, b1) in zip(rec["spans"], rec["spans"][1:]):
            assert a0 <= a1 == b0 <= b1
    _assert_bit_exact(_ref(mode, plans), res)


@pytest.mark.parametrize("batch", [2, 5], ids=["3-chunks", "1-chunk"])
def test_campaign_counts_graph_replays(batch, monkeypatch):
    """On the graph path the campaign's stats carry the engine calls'
    replays, captures and hits: the first chunk captures and times one
    eager block, the others replay its kept graph; each chunk times the
    copy back."""
    monkeypatch.setattr(sim, "_capture", _stand_in_capture)
    monkeypatch.setattr(sim, "simulate_batch",
                        functools.partial(sim._simulate, graph=True))
    out = _campaign(sim.MODE_ETF, batch_size=batch)
    st, spans = out.stats, out.stats["spans"]
    _assert_well_formed(spans)
    names = [s.name for s in spans]
    n = st["n_chunks"]
    for one in ("engine.replays", "campaign.to_host"):
        assert names.count(one) == n, one
    assert st["captures"] == 1 and st["graph_hits"] == n - 1
    assert names.count("engine.capture") == st["captures"]
    assert names.count("engine.eager_block") == st["captures"]
    assert st["replays"] == st["steps"] // sim.POLL_EVERY - 1 > 0
    _assert_bit_exact(_ref(sim.MODE_ETF), out.result)


def _oom_once(real):
    seen = []

    def oomy(*a, **kw):
        if not seen:
            seen.append(1)
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(*a, **kw)
    return oomy


def _timeout_once(real):
    seen = []

    def late(*a, **kw):
        if not seen:
            seen.append(1)
            raise camp.ChunkTimeout("chunk exceeded the 1s watchdog")
        return real(*a, **kw)
    return late


@pytest.mark.parametrize("failure", ["oom", "timeout", "stall"])
def test_failed_attempt_leaves_its_spans(failure, monkeypatch):
    kw = {}
    if failure == "stall":
        kw = {"step_budget": 8, "retry": camp.RetryPolicy(
            max_retries=6, backoff_base_s=0.0, backoff_max_s=0.0,
            jitter_frac=0.0)}
    else:
        wrap = _oom_once if failure == "oom" else _timeout_once
        monkeypatch.setattr(camp, "_compute_chunk",
                            wrap(camp._compute_chunk))
    out = _campaign(**kw)
    spans = out.stats["spans"]
    _assert_well_formed(spans)
    first = [s for s in spans if s.name == "campaign.chunk"
             and s.chunk == (0, 0)]
    assert [s.outcome for s in first] == [failure]
    backoff = [s for s in spans if s.name == "campaign.backoff"]
    assert backoff and backoff[0].chunk == (0, 1)
    assert backoff[0].start_ns == first[0].end_ns
    retried = [s for s in spans if s.name == "campaign.chunk"
               and s.chunk == (0, 1)]
    assert retried[0].start_ns == backoff[0].end_ns
    assert [s.outcome for s in spans if s.name == "campaign.chunk"
            and s.chunk[0] == 0][-1] == "ok"
    if failure == "stall":
        # the stalled attempt ran its engine call to the end
        assert any(s.chunk == (0, 0) and s.name == "engine.finalize"
                   for s in spans)
    _assert_bit_exact(_ref(sim.MODE_LUT), out.result)


def _seconds(spans, name, chunk=None):
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name
               and (chunk is None or s.chunk[0] == chunk)) * 1e-9


@pytest.mark.parametrize("case", ["retries", "checkpoint-write",
                                  "checkpoint-read"])
def test_stats_seconds_are_their_spans(case, tmp_path, monkeypatch):
    kw = {}
    if case == "retries":
        monkeypatch.setattr(camp, "_compute_chunk",
                            _oom_once(camp._compute_chunk))
    else:
        kw["checkpoint_dir"] = str(tmp_path)
        if case == "checkpoint-read":
            _campaign(**kw)
    out = _campaign(**kw)
    st, spans = out.stats, out.stats["spans"]
    for ci, wall in enumerate(st["chunk_wall_s"]):
        own = [s for s in spans if s.name == "campaign.chunk"
               and s.chunk[0] == ci]
        if case == "checkpoint-read":
            assert wall == 0.0 and not own
            continue
        attempts = _seconds(spans, "campaign.chunk", ci) \
            + _seconds(spans, "campaign.backoff", ci)
        assert wall == round(attempts, 4) == round(
            (own[-1].end_ns - own[0].start_ns) * 1e-9, 4)
    prepare, = [s for s in spans if s.name == "campaign.prepare"]
    assert st["wall_s"] == round((spans[0].end_ns - prepare.end_ns) * 1e-9,
                                 4)
    for key in ("checkpoint_read", "checkpoint_write"):
        assert st[f"{key}_s"] == camp.span_s(spans, f"campaign.{key}") \
            == _seconds(spans, f"campaign.{key}")
    reads = _seconds(spans, "campaign.checkpoint_read")
    writes = _seconds(spans, "campaign.checkpoint_write")
    assert (reads > 0) == (case == "checkpoint-read")
    assert (writes > 0) == (case == "checkpoint-write")
    if case == "retries":
        assert st["retries"] == 1 and st["chunk_wall_s"][0] > _seconds(
            spans, "campaign.chunk", 0)
    _assert_bit_exact(_ref(sim.MODE_LUT), out.result)


def test_no_telemetry_records_nothing():
    """A plain `run_batch` call takes no telemetry and keeps no spans;
    with a list, each part's record starts where the part began."""
    assert sim._open_record(None) is None
    sim._lap(None, "engine.setup")            # a no-op
    tel = []
    sim.run_batch(sim.MODE_LUT, WLS[:2], PARAMS, device="cpu",
                  telemetry=tel)
    rec, = tel
    assert [n for n, _, _ in rec["spans"]][0] == "engine.setup"
    assert rec["start_ns"] == rec["spans"][0][1]
