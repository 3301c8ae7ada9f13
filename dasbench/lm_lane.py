"""The language-model lane: a model served on one device in a closed
loop, held to the plain reference (`reference/lm_ref.py`).

A configuration file of kind "lm" gives the model's published keys (which
the yardstick reads), `variant`, the values of those keys the model is run
with where it departs from them (`model`: what the reference reads), the
port's `ModelConfig` under `port` (which the program reads), and
`reference`, the name of the reference module under `reference/`. A
traffic file gives the requests a batch (`batch`), the prompt lengths'
distribution (`prompt`: a lognormal's `median` and `sigma`, served at
`levels` quantile levels), the tokens a request (`new_tokens`), the
prompt tokens a prefill call takes at most (`prefill_tokens`) and the
check's sample (`check`).

Set-up draws the weights on the device from the seed (`lm_ref.
draw_weights`, bfloat16, the reference's names), hands the same tensors
to the program (`program.LMProgram`), and warms up each prompt length:
one prefill call at its shape, and a few decode steps over the whole
batch's caches. Then one client serves batch after batch: batch k draws
its prompt length from (seed, k // n) as a permutation of the n lengths,
so every cycle of n batches serves each length once, in an order of the
seed's, and its token ids uniformly over the vocabulary from (seed, k);
`lm.prefill` a group of requests at a time into their rows of the
batch's caches, one device synchronisation, then `new_tokens` - 1 greedy
`lm.decode_step`s and one synchronisation at the batch's end. The window
closes at the end of the first whole cycle that ends after `--seconds`:
every window serves each length as often as any other. Each batch keeps
on the device the logits of a seeded `check.per_batch` of its requests at
the steps `check.steps` (step 0 is the prefill's), and every request's
tokens, copied at the batch's end.

The check, once the window has closed and the program is gone: a seeded
choice of `check.batches` batches of the window, a batch of the longest
prompt length among them, and their kept requests; the reference runs a
full forward over each prompt and the tokens the program served
(teacher-forced) and gives its logits at every served position:

  token_gap        the widest gap by which a served token's reference
                   logit lies below the reference's best at its position
  token_gap_mean   the mean of those gaps
  logit_rel        ||port - ref|| / ||ref|| over the kept logits, pooled
  logit_rel_median the same at the median kept position
  logit_rel_worst  the same at the worst kept position

A cell compares the numbers its limits file names; `requests_failed`,
the requests that returned a non-finite logit, is held to 0.

With `--trace 1`, once the window has closed, its last batch is served
again, traced (`trace`), and the line carries the per-layer metrics,
read from the window's batches and the traced one.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import statistics
import time
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np
import torch

from dasbench import check, trace
from dasbench.inputs import WARMUP, rng

# streams of a batch's generator: the cycle's lengths (drawn once a
# cycle), the prompts, the requests whose logits are kept; the sample's
# batches (drawn once a run)
LENGTHS, PROMPTS, KEEP, PICK = 0, 1, 2, 3
WARMUP_STEPS = 2              # decode steps of a warm-up batch


@dataclasses.dataclass
class Readings:
    """What the LM lane's metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    batches: List[dict]       # every batch served in the window
    traced: List[dict]        # the traced batch, or none
    trace: Dict | None        # `trace.reduce` of the slice


def model(config: dict) -> dict:
    """The keys the model is run with: the published keys, with the
    configuration's `variant` over them."""
    return {**config, **config.get("variant", {})}


class Traffic:
    """A traffic file's batches, drawn from the seed."""

    KEYS = {"why", "source", "assumed", "batch", "prompt", "new_tokens",
            "prefill_tokens", "check"}
    PROMPT = {"median", "sigma", "levels"}
    CHECK = {"batches", "per_batch", "steps"}

    def __init__(self, config: dict, traffic: dict):
        if (set(traffic) != self.KEYS or set(traffic["check"]) != self.CHECK
                or set(traffic["prompt"]) != self.PROMPT):
            raise ValueError(f"LM traffic keys {sorted(traffic)}; expected "
                             f"{sorted(self.KEYS)}, prompt "
                             f"{sorted(self.PROMPT)}, check "
                             f"{sorted(self.CHECK)}")
        self.vocab = int(config["vocab_size"])
        self.batch = int(traffic["batch"])
        p = traffic["prompt"]
        n = int(p["levels"])
        self.lens = [round(p["median"] * math.exp(
            p["sigma"] * NormalDist().inv_cdf((i + 0.5) / n)))
            for i in range(n)]
        self.new_tokens = int(traffic["new_tokens"])
        self.prefill_tokens = int(traffic["prefill_tokens"])
        chk = traffic["check"]
        self.steps = [int(s) for s in chk["steps"]]
        self.n_batches = int(chk["batches"])
        self.per_batch = int(chk["per_batch"])
        if (sorted(set(self.steps)) != self.steps or self.steps[0] < 0
                or self.steps[-1] >= self.new_tokens
                or not 0 < self.per_batch <= self.batch
                or min(self.lens) < 1 or len(set(self.lens)) != n):
            raise ValueError(f"LM traffic {traffic}")

    @property
    def cycle(self) -> int:
        return len(self.lens)

    def prompt_len(self, seed: int, k: int) -> int:
        order = rng(seed, k // self.cycle, LENGTHS).permutation(self.lens)
        return int(order[k % self.cycle])

    def prefill_rows(self, length: int) -> int:
        """The requests a prefill call takes at this prompt length: the
        largest share of the batch, a whole divisor of it, whose prompt
        tokens fit `prefill_tokens` (one request where none fits)."""
        return max([r for r in range(1, self.batch + 1)
                    if self.batch % r == 0
                    and r * length <= self.prefill_tokens] or [1])

    def prompts(self, seed: int, k: int, length: int | None = None
                ) -> np.ndarray:
        """Batch k's token ids [batch, length] (its own length by
        default)."""
        n = self.prompt_len(seed, k) if length is None else length
        return rng(seed, k, PROMPTS).integers(0, self.vocab,
                                              (self.batch, n))

    def kept_rows(self, seed: int, k: int) -> List[int]:
        return sorted(rng(seed, k, KEEP).choice(
            self.batch, size=self.per_batch, replace=False).tolist())


def serve(prog, tokens: torch.Tensor, new_tokens: int, rows: Sequence[int],
          steps: Sequence[int], sync, on=None, produce: int | None = None,
          prefill_rows: int | None = None, calls: int | None = None
          ) -> dict:
    """One batch: prefill, `prefill_rows` requests a call (all by
    default), into caches sized for `new_tokens` tokens a request, then
    greedy decode steps until each request has `produce` tokens (default
    `new_tokens`; fewer in a warm-up, which also makes only `calls`
    prefill calls). Returns the host copies of every request's tokens
    [B, produce], whether each returned a non-finite logit [B], and the
    kept requests' logits at `steps` [len(rows), len(steps), V] float32,
    with the phases' host seconds."""
    B, P = tokens.shape
    dev = tokens.device
    produce = new_tokens if produce is None else produce
    slot = {s: j for j, s in enumerate(steps)}
    rows_t = torch.tensor(list(rows), device=dev)
    t0 = time.perf_counter()
    with trace.span(on, "prefill"):
        logits, caches = prog.prefill(tokens, P + new_tokens - 1,
                                      prefill_rows, calls)
        sync()
    t1 = time.perf_counter()
    with trace.span(on, "decode"):
        served = torch.empty((B, produce), dtype=torch.long, device=dev)
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        kept = torch.empty((len(rows), len(steps), logits.shape[-1]),
                           dtype=torch.float32, device=dev)
        for i in range(produce):
            if i:
                logits, caches = prog.decode_step(served[:, i - 1],
                                                  P + i - 1, caches)
            bad |= ~torch.isfinite(logits).all(-1)
            served[:, i] = logits.argmax(-1)
            if i in slot:
                kept[:, slot[i]] = logits[rows_t].float()
        sync()
    t2 = time.perf_counter()
    with trace.span(on, "copy_out"):
        out = {"served": served.cpu().numpy(), "bad": bad.cpu().numpy(),
               "kept": kept.cpu()}
    t3 = time.perf_counter()
    del caches, logits
    out.update(prefill_s=t1 - t0, decode_s=t2 - t1, wall_s=t3 - t0)
    return out


def numbers(served: np.ndarray, kept: torch.Tensor, ref: torch.Tensor,
            steps: Sequence[int]) -> Dict[str, list]:
    """One request's served tokens [N] and kept logits [len(steps), V]
    against the reference's logits at every served position [N, V]:
    each served token's gap below the reference's best, and each kept
    position's squared distance and squared norm (pooled by
    `readings`)."""
    ref = ref.double().cpu()
    idx = torch.as_tensor(served, dtype=torch.long)[:, None]
    gap = ref.max(-1).values - ref.gather(-1, idx)[:, 0]
    at = ref[list(steps)]
    d2 = ((kept.double() - at) ** 2).sum(-1)
    r2 = (at ** 2).sum(-1)
    return {"gap": gap.tolist(), "d2": d2.tolist(), "r2": r2.tolist()}


def readings(per: List[dict]) -> Dict[str, float]:
    """The numbers a check can compare, over the sample: the widest and
    the mean token gap, and the kept logits' relative distance pooled,
    at the median position and at the worst."""
    gap = np.array([x for p in per for x in p["gap"]])
    d2 = np.array([x for p in per for x in p["d2"]])
    r2 = np.array([x for p in per for x in p["r2"]])
    rel = np.sqrt(d2 / r2)
    return {"token_gap": float(gap.max()),
            "token_gap_mean": float(gap.mean()),
            "logit_rel": float(np.sqrt(d2.sum() / r2.sum())),
            "logit_rel_median": float(np.median(rel)),
            "logit_rel_worst": float(rel.max())}


def pick(seed: int, lens: List[int], n: int) -> List[int]:
    """`n` of the window's batches, by their prompt lengths `lens`:
    first one of the longest prompts, then others, drawn from the seed."""
    g = rng(seed, WARMUP, PICK)
    longest = [k for k, p in enumerate(lens) if p == max(lens)]
    first = int(g.choice(longest))
    rest = [k for k in range(len(lens)) if k != first]
    more = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return sorted([first] + [rest[i] for i in more])


def reference_module(config: dict):
    return importlib.import_module(
        f"dasbench.reference.{config['reference']}")


def run(spec: dict, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, log=print, controls: Sequence[str] = ()) -> dict:
    """One run of an LM cell: set-up, window, check. Returns the result
    line's object. `controls` (names of the reference's `VARIANTS`) are
    computed in the program's place on the same sample after the check,
    their numbers under "controls": the control's own runs, never a
    benchmark run's."""
    from dasbench.program import LMProgram

    config, traffic = spec["config"], spec["traffic"]
    ref, runs = reference_module(config), model(config)
    tr = Traffic(config, traffic)
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [time.perf_counter()]
    with torch.inference_mode():
        weights = ref.draw_weights(runs, seed, device, torch.bfloat16)
        prog = LMProgram(config, weights, device)
        sync()
        marks.append(time.perf_counter())
        # warm-up: each prompt length's prefill call and a few decode
        # steps over the whole batch's caches
        for n in tr.lens:
            toks = torch.from_numpy(tr.prompts(seed, WARMUP, n)).to(device)
            serve(prog, toks, tr.new_tokens, [0], [0], sync,
                  produce=WARMUP_STEPS + 1, prefill_rows=tr.prefill_rows(n),
                  calls=1)
        marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    log("# set-up s: imports {:.3f}, weights and program {:.3f}, warm-up "
        "{:.3f}".format(marks[0] - t_start,
                        *[b - a for a, b in zip(marks, marks[1:])]))

    batches: List[dict] = []
    outs: Dict[int, dict] = {}
    attempted = failed = 0

    def one(k: int, on=None) -> dict:
        ts = time.perf_counter()
        with trace.span(on, "draw"):
            toks = torch.from_numpy(tr.prompts(seed, k)).to(device)
        rows = tr.kept_rows(seed, k)
        out = serve(prog, toks, tr.new_tokens, rows, tr.steps, sync, on,
                    prefill_rows=tr.prefill_rows(toks.shape[1]))
        out.update(rows=rows, wall_s=time.perf_counter() - ts)
        batches.append({
            "index": k, "batch": toks.shape[0], "prompt_len": toks.shape[1],
            "new_tokens": tr.new_tokens, "prefill_s": out["prefill_s"],
            "decode_s": out["decode_s"], "wall_s": out["wall_s"],
            "traced": on is not None})
        return out

    with torch.inference_mode():
        t0 = time.perf_counter()
        k = 0
        while True:
            out = one(k)
            attempted += len(out["bad"])
            failed += int(out["bad"].sum())
            outs[k] = {key: out[key] for key in ("served", "kept", "rows")}
            k += 1
            if k % tr.cycle == 0 and time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        results = None
        if traced:
            # the window's last batch again, traced: a process that has
            # run the profiler serves its later batches slower
            slice_ = trace.Slice()
            slice_.start()
            one(k - 1, slice_)
            results = slice_.stop()
            batches[-1]["untraced_wall_s"] = batches[-2]["wall_s"]
    del prog
    summary = None
    if results is not None:
        tq = time.perf_counter()
        summary = trace.reduce(*results)
        log(f"# trace: {summary['n_kernels']} kernels in the slice, "
            f"reduced in {time.perf_counter() - tq:.2f}s")
    del results

    walls = [b["wall_s"] for b in batches]
    log(f"# batches: {len(batches)} in {window_s:.4f}s; wall s median "
        f"{statistics.median(walls):.4f}; " + ", ".join(
            f"P{b['prompt_len']} {b['prefill_s']:.3f}+{b['decode_s']:.3f}"
            for b in batches))
    r = Readings(spec["cell"], config, traffic, setup_s, window_s, batches,
                 [b for b in batches if b["traced"]], summary)
    from dasbench import harness
    result = harness.result_line(spec, r, traced, attempted, failed,
                                 device, "traced_batches")
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the program's state is gone
    tq = time.perf_counter()
    ks = pick(seed, [tr.prompt_len(seed, k) for k in sorted(outs)],
              tr.n_batches)
    seqs, keep, sample = [], [], []
    for k in ks:
        o = outs[k]
        prompts = tr.prompts(seed, k)
        for j, row in enumerate(o["rows"]):
            s = np.concatenate([prompts[row], o["served"][row, :-1]])
            seqs.append(torch.from_numpy(s).to(device))
            keep.append(torch.arange(prompts.shape[1] - 1, len(s),
                                     device=device))
            sample.append((o["served"][row], o["kept"][j]))
    refs = ref.forward(runs, weights, seqs, keep)
    per = [numbers(s, kp, rf, tr.steps) for (s, kp), rf in
           zip(sample, refs)]
    ok, rows = check.judge(readings(per), spec["limits"])
    shown = {"requests_failed": {"value": failed, "limit": 0}}
    shown.update({k: {"value": v, "limit": lim} for k, v, lim in rows})
    result["correct"] = bool(ok and failed == 0 and per)
    log(f"# check: {len(per)} requests of batches {ks} against the "
        f"reference in {time.perf_counter() - tq:.2f}s; readings "
        + json.dumps(readings(per)))
    if controls:
        result["controls"] = {}
        for v in controls:
            got = ref.forward(runs, weights, seqs, keep, variant=v)
            cper = [numbers(g.argmax(-1).cpu().numpy(),
                            g[list(tr.steps)].cpu(), rf, tr.steps)
                    for g, rf in zip(got, refs)]
            cok, crows = check.judge(readings(cper), spec["limits"])
            result["controls"][v] = {
                "correct": bool(cok),
                "check": {k: {"value": x, "limit": lim}
                          for k, x, lim in crows},
                "readings": readings(cper)}
        result["readings"] = readings(per)
    result["check"] = shown
    return result
