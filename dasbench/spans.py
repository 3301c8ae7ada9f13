"""The program's own spans on a cell of the benchmark.

    python3 -m dasbench.spans --workload NAME --seed N [--sweeps K]
                              [--out PATH]

The port's campaign returns its host phases as spans (`stats["spans"]`,
`repro_torch.core.campaign.Span`), on the clock the profiler's device
records are put on. This sets a cell up as the harness does (inputs,
program, chunk size, a warm-up sweep a mode), then sweeps the inputs of
sweeps 0 .. K-1 untraced, then the same inputs again traced
(`trace.Slice`, with a `run_campaign` span around the call as the
harness has): once a profiler has run in a process, its sweeps are
slower, so every untraced pass comes first. Each input prints one JSON
line:

  self_ms            each span name's self time (its spans' time that no
                     child span covers), untraced and traced: where the
                     profiler's cost lands
  idle_by_span       the traced sweep's idle seconds, every gap named by
                     the innermost span that holds its midpoint
  engine.rebuild_ms  self time of engine.setup + engine.eager_block +
                     engine.capture, untraced
  campaign.host_ms   self time of campaign.prepare + campaign.to_host +
                     campaign.reassemble, untraced

and the three checks of the spans' cover: the share of the idle inside
`run_campaign` left to `run_campaign` or `campaign.run`, the span that
names the longest gap, and `campaign.run`'s self share untraced.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

REBUILD = ("engine.setup", "engine.eager_block", "engine.capture")
HOST = ("campaign.prepare", "campaign.to_host", "campaign.reassemble")
# gaps under these are not told apart by the program's spans
UNNAMED = ("run_campaign", "campaign.run")


def _covered(lo: int, hi: int, parts: List[tuple]) -> int:
    """Length of `[lo, hi]` that the union of `parts` covers."""
    n, cur = 0, lo
    for a, b in sorted(parts):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            n += b - a
            cur = b
    return n


def self_ns(spans) -> Dict[str, int]:
    """Span name -> summed self time in ns. A child names its parent and,
    inside a chunk, the same `chunk`; spans without a parent field (the
    harness's) are left out."""
    prog = [s for s in spans if len(s) >= 5]
    out: Dict[str, int] = {}
    for p in prog:
        kids = [(c[1], c[2]) for c in prog if c[3] == p[0]
                and (p[4] is None or c[4] == p[4])]
        own = p[2] - p[1] - _covered(p[1], p[2], kids)
        out[p[0]] = out.get(p[0], 0) + own
    return out


def self_ms(spans, names) -> float:
    """Summed self time of the spans of `names`, in ms."""
    own = self_ns(spans)
    return sum(own.get(n, 0) for n in names) * 1e-6


def idle_by_span(summary: Dict) -> Dict[str, float]:
    """Idle seconds of a traced slice by the span that names each gap,
    summed over every gap (`trace.reduce`'s `gaps`)."""
    out: Dict[str, float] = {}
    for who, s in summary["gaps"]:
        out[who] = out.get(who, 0.0) + s
    return out


def cover(summary: Dict, untraced) -> Dict:
    """How far the program's spans name the traced sweep's idle time."""
    idle = idle_by_span(summary)
    inside = sum(v for k, v in idle.items() if k != "slice")
    longest = max(summary["gaps"], key=lambda g: g[1], default=("", 0.0))
    run = [s for s in untraced if s[0] == "campaign.run"][0]
    return {
        "unnamed_idle_share": (sum(idle.get(k, 0.0) for k in UNNAMED)
                               / inside if inside else 0.0),
        "longest_gap": [longest[0], longest[1]],
        "run_self_share": self_ns(untraced)["campaign.run"]
        / (run[2] - run[1]),
    }


def measure(spec: dict, seed: int, sweeps: int, device: str,
            slice_factory=None, log=print) -> List[dict]:
    """Set a cell up and read the spans of the inputs of sweeps 0 ..
    `sweeps` - 1, untraced and traced (see the module's text); one record
    an input."""
    import torch

    from dasbench import inputs, trace
    from dasbench.program import Program

    slice_factory = slice_factory or trace.Slice
    tr = inputs.Traffic(spec["config"], spec["traffic"])
    prog = Program(spec["config"], device)
    batch = prog.chunk()
    for i in range(tr.cycle):
        sw = tr.sweep(seed, inputs.WARMUP - tr.cycle + 1 + i)
        prog.sweep(sw.mode, sw.wl, sw.plan, batch, sw.policy)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    sws = [tr.sweep(seed, k) for k in range(sweeps)]
    untraced = []
    for sw in sws:
        t0 = time.perf_counter()
        _, stats = prog.sweep(sw.mode, sw.wl, sw.plan, batch, sw.policy)
        untraced.append((time.perf_counter() - t0, stats["spans"]))
    out = []
    for k, (sw, (wall, plain)) in enumerate(zip(sws, untraced)):
        sl = slice_factory()
        sl.start()
        t0 = time.perf_counter()
        with sl.span("run_campaign"):
            _, traced_stats = prog.sweep(sw.mode, sw.wl, sw.plan, batch,
                                         sw.policy)
        traced_wall = time.perf_counter() - t0
        results, spans = sl.stop()
        traced = self_ns(traced_stats["spans"])
        summary = trace.reduce(results,
                               list(spans) + list(traced_stats["spans"]))
        rec = {
            "sweep": k, "mode": sw.mode, "wall_s": wall,
            "traced_wall_s": traced_wall,
            "engine.rebuild_ms": self_ms(plain, REBUILD),
            "campaign.host_ms": self_ms(plain, HOST),
            "self_ms": {n: [v * 1e-6, traced.get(n, 0) * 1e-6]
                        for n, v in self_ns(plain).items()},
            "idle_by_span": idle_by_span(summary),
            "busy_s": summary["busy_s"], "window_s": summary["window_s"],
            **cover(summary, plain),
            "spans": [list(s) for s in plain],
        }
        log(json.dumps({k: v for k, v in rec.items() if k != "spans"}))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    from dasbench import harness
    spec = harness.resolve_cell(harness.ROOT, args.workload)
    harness._isolate_env()
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("dasbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    recs = measure(spec, args.seed, args.sweeps, "cuda")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"workload": args.workload, "seed": args.seed,
             "device": torch.cuda.get_device_name(0), "pairs": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
