"""The program's spans read by the benchmark's trace (`dasbench.spans`):
a gap inside an engine span is named by it, idle summed by span covers
every gap, self times leave out what child spans cover, and a cell's
sweeps give a positive rebuild and host time on the CPU."""
import time

import pytest

from dasbench import harness, spans as dspans, trace
from dasbench.tests.conftest import ROOT
from dasbench.tests.test_bench_harness import _FakeSlice
from repro_torch.core.campaign import Span

SEED = 2**31 + 8191


class _Event:
    def __init__(self, t0, dur, name="k"):
        self.t0, self.dur, self._n = t0, dur, name

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA"

    def start_ns(self):
        return self.t0

    def duration_ns(self):
        return self.dur


class _Results:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


# the harness's spans and a program's, one chunk of one attempt:
# run 100-900 holds prepare 100-150, the chunk 150-800 and reassemble
# 800-880; the chunk holds setup 160-200, the eager block 200-300, the
# capture 300-500, the replays 500-700 and the copy back 710-790
HARNESS = [("run_campaign", 90, 950), ("slice", 0, 1000)]
PROGRAM = [
    Span("campaign.run", 100, 900, None, None),
    Span("campaign.prepare", 100, 150, "campaign.run", None),
    Span("campaign.chunk", 150, 800, "campaign.run", (0, 0), "ok"),
    Span("engine.setup", 160, 200, "campaign.chunk", (0, 0)),
    Span("engine.eager_block", 200, 300, "campaign.chunk", (0, 0)),
    Span("engine.capture", 300, 500, "campaign.chunk", (0, 0)),
    Span("engine.replays", 500, 700, "campaign.chunk", (0, 0)),
    Span("engine.finalize", 700, 705, "campaign.chunk", (0, 0)),
    Span("campaign.to_host", 710, 790, "campaign.chunk", (0, 0)),
    Span("campaign.reassemble", 800, 880, "campaign.run", None),
]


@pytest.mark.parametrize("program", [False, True],
                         ids=["harness-spans", "with-program-spans"])
def test_a_gap_in_the_capture_is_named_by_it(program):
    """Device work 200-300 (the eager block) and 500-700 (the replays):
    the gap 300-500 lies inside `engine.capture` nested in
    `run_campaign`, and is named by the innermost span."""
    res = _Results([_Event(200, 100), _Event(500, 200)])
    s = trace.reduce(res, HARNESS + (PROGRAM if program else []))
    gaps = {round(g * 1e9): w for w, g in s["gaps"]}
    assert gaps[200] == ("engine.capture" if program else "run_campaign")
    idle = dspans.idle_by_span(s)
    assert sum(idle.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    if program:
        # the gaps 0-200 and 700-1000 by their midpoints: prepare, reassemble
        assert idle["engine.capture"] == pytest.approx(200e-9)
        assert "run_campaign" not in idle
        assert dspans.cover(s, PROGRAM)["longest_gap"][0] == \
            "campaign.reassemble"


def test_self_times_leave_out_the_children():
    own = dspans.self_ns(PROGRAM + HARNESS)
    assert "run_campaign" not in own and "slice" not in own
    assert own["campaign.run"] == 800 - 50 - 650 - 80
    # the chunk's own: 150-160, 705-710 and 790-800
    assert own["campaign.chunk"] == 10 + 5 + 10
    assert own["engine.capture"] == 200
    assert dspans.self_ms(PROGRAM, dspans.REBUILD) == pytest.approx(
        340 * 1e-6)
    assert dspans.self_ms(PROGRAM, dspans.HOST) == pytest.approx(
        (50 + 80 + 80) * 1e-6)
    # two attempts of one chunk: each attempt's children are its own
    second = [Span("campaign.chunk", 150, 400, "campaign.run", (0, 1),
                   "ok"),
              Span("engine.setup", 150, 400, "campaign.chunk", (0, 1))]
    first = [s for s in PROGRAM if s.chunk != (0, 0)] + [
        Span("campaign.chunk", 100, 150, "campaign.run", (0, 0), "oom")]
    assert dspans.self_ns(first + second)["campaign.chunk"] == 50


def test_a_cell_reads_positive_spans_on_the_cpu(small_batch):
    spec = harness.resolve_cell(ROOT, "healthy.etf-grid")
    spec["config"] = dict(spec["config"], frames=4, n_mixes=1)
    made = []
    t0 = time.time_ns()
    recs = dspans.measure(spec, SEED, 1, "cpu",
                          slice_factory=lambda: made.append(_FakeSlice())
                          or made[-1], log=lambda *a: None)
    rec, = recs
    assert rec["engine.rebuild_ms"] > 0 and rec["campaign.host_ms"] > 0
    assert rec["sweep"] == 0 and made[0].starts == 1
    names = {s[0] for s in rec["spans"]}
    assert {"campaign.run", "campaign.prepare", "campaign.chunk",
            "engine.setup", "engine.eager_block", "engine.finalize",
            "campaign.to_host", "campaign.reassemble"} <= names
    assert all(t0 <= s[1] <= s[2] for s in rec["spans"])
    assert 0 <= rec["run_self_share"] < 1
    assert sum(rec["idle_by_span"].values()) == pytest.approx(
        rec["window_s"] - rec["busy_s"])
    assert set(rec["self_ms"]) == names
