"""The traced slice of a `--trace 1` run, and its reduction.

The profiler records the device's operations alone (CUPTI; no host
activity, so the host's aten calls cost nothing extra) over a bounded
slice: the window's first sweep. A graph replay runs about 400 kernels a
super-step, so a whole window would be millions of records. The
harness's own spans (`Slice.span`) are host timestamps on the clock the
profiler gives the device's records (`time.time_ns`). The reduction
reads the raw records (no per-event Python objects beyond one pass)
into:

  window_s        the slice's length (its host span)
  busy_s          the union of the device's operation intervals inside it
  kernel_busy_s   the same over kernels alone (no copies, no memsets)
  n_kernels       kernel launches that ran inside it
  by_name         kernel name -> [calls, seconds]
  gaps            the idle intervals, each named by the innermost span
                  that holds its midpoint
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

# device time that may lie outside the slice's host span before the
# two clocks are taken to disagree
CLOCK_SLACK_NS = 5_000_000


class Slice:
    """Start and stop the profiler around the traced slice, and keep the
    harness's spans inside it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.spans: List[tuple] = []
        self._t0 = None

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.time_ns()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def stop(self):
        """(the profiler's raw results, the spans with the slice's own)"""
        self._torch.cuda.synchronize()
        self.spans.append(("slice", self._t0, time.time_ns()))
        self._prof.stop()
        return self._prof.profiler.kineto_results, self.spans


def span(slice_: Slice | None, name: str):
    """A named host span of the slice (nothing outside it)."""
    return contextlib.nullcontext() if slice_ is None else slice_.span(name)


def _merge(iv: List[tuple]) -> List[tuple]:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _length(merged, lo: int, hi: int) -> int:
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged)


def reduce(results, spans: List[tuple]) -> Dict:
    """The slice's summary from the profiler's raw results and the
    host spans."""
    ops, kernels = [], []
    by_name: Dict[str, list] = {}
    for e in results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        ops.append((t0, t1))
        name = e.name()
        if name.lower().startswith(("memcpy", "memset")):
            continue
        kernels.append((t0, t1))
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (t1 - t0) * 1e-9
    _, lo, hi = [s for s in spans if s[0] == "slice"][0]
    if ops:
        first = min(a for a, _ in ops)
        last = max(b for _, b in ops)
        if first < lo - CLOCK_SLACK_NS or last > hi + CLOCK_SLACK_NS:
            raise RuntimeError(
                f"the device's records lie outside the slice's host span "
                f"({(first - lo) * 1e-6:.3f} ms after its start, "
                f"{(last - hi) * 1e-6:.3f} ms after its end): the "
                "profiler's clock is not the host's")
    merged = _merge([(max(a, lo), min(b, hi)) for a, b in ops
                     if b > lo and a < hi])
    kmerged = _merge([(max(a, lo), min(b, hi)) for a, b in kernels
                      if b > lo and a < hi])
    gaps, cur = [], lo
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    named = []
    inner = [s for s in spans if s[0] != "slice"]
    for a, b in gaps:
        mid = (a + b) // 2
        holders = [s for s in inner if s[1] <= mid <= s[2]]
        who = min(holders, key=lambda s: s[2] - s[1])[0] if holders \
            else "slice"
        named.append((who, (b - a) * 1e-9))
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": _length(merged, lo, hi) * 1e-9,
        "kernel_busy_s": _length(kmerged, lo, hi) * 1e-9,
        "n_kernels": sum(1 for a, b in kernels if b > lo and a < hi),
        "by_name": by_name,
        "gaps": named,
    }


def breakdown(summary: Dict, n: int = 10) -> Dict:
    """The contract's `breakdown`: the kernels that took most device time
    and the longest idle gaps, by what the harness was doing."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][1])[:n]
    gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:n]
    return {"device_ops": [[k[:120], v[1]] for k, v in ops],
            "idle_gaps": [[w, s] for w, s in gaps]}
