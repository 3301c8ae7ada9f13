"""Continuous-batching serving engine with pluggable (DAS) dispatch.

The engine maintains R replicas, each with a wait queue and a running
decode batch (continuous batching: new requests are admitted into the batch
between decode iterations, paying their prefill on admission). The executor
clock comes from the roofline cost model (costmodel.py), as under the
reference's `execute="sim"`, the only executor either package has (the
port keeps no such knob): the engine runs no model and launches no
kernel. The model steps themselves are the LM path's (`models/lm.py`,
`bench/lm_serve.py`), measured there.

The port of `repro/serve/engine.py`, on numpy as the reference is: the
same requests give the same latencies, energy and dispatch counts.

The dispatcher (serve.dispatch) decides request -> replica. Dispatch is a
serial resource with policy-dependent latency, exactly like the paper's
scheduler core: the fast LUT path is O(1); the slow ETF path walks every
replica's queue with the cost model. At high request rates the ETF
dispatcher itself becomes the bottleneck — the DAS preselection classifier
arbitrates per request.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List

import numpy as np

from repro_torch.serve import costmodel as cm


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt_len: int
    gen_len: int
    # filled by the engine
    replica: int = -1
    dispatched_s: float = -1.0
    first_token_s: float = -1.0
    done_s: float = -1.0
    tokens_out: int = 0


@dataclasses.dataclass
class EngineConfig:
    n_replicas: int = 4
    max_batch: int = 16


class Replica:
    def __init__(self, idx: int, spec: cm.ReplicaSpec, mc: cm.ModelCost,
                 max_batch: int):
        self.idx = idx
        self.spec = spec
        self.mc = mc
        self.max_batch = max_batch
        self.queue: List[Request] = []
        self.running: List[Request] = []
        self.free_at = 0.0
        self.busy_s = 0.0
        self.energy_j = 0.0

    # -- ETF estimate: when would `req` finish here? -------------------------
    def estimate_finish(self, req: Request, now: float) -> float:
        t = max(self.free_at, now)
        # queued work ahead of us (prefill + its remaining decode, batched)
        for r in self.queue:
            t += cm.prefill_seconds(self.mc, self.spec, r.prompt_len)
        backlog = sum(max(r.gen_len - r.tokens_out, 0)
                      for r in self.running + self.queue)
        nb = max(len(self.running) + len(self.queue), 1)
        steps = backlog / nb
        t += steps * cm.decode_step_seconds(
            self.mc, self.spec, nb, self.mean_ctx())
        t += cm.prefill_seconds(self.mc, self.spec, req.prompt_len)
        t += req.gen_len * cm.decode_step_seconds(
            self.mc, self.spec, min(nb + 1, self.max_batch), self.mean_ctx())
        return t

    def mean_ctx(self) -> float:
        rs = self.running
        if not rs:
            return 1.0
        return float(np.mean([r.prompt_len + r.tokens_out for r in rs]))

    def load(self) -> float:
        return (sum(max(r.gen_len - r.tokens_out, 0)
                    for r in self.running + self.queue))

    # -- one continuous-batching iteration -----------------------------------
    def step(self, now: float) -> float:
        """Advance one iteration starting at `now`; returns its duration."""
        dt = 0.0
        # admit from queue
        while self.queue and len(self.running) < self.max_batch:
            r = self.queue.pop(0)
            pf = cm.prefill_seconds(self.mc, self.spec, r.prompt_len)
            dt += pf
            r.first_token_s = now + dt
            r.tokens_out = 1
            self.running.append(r)
        if self.running:
            step_t = cm.decode_step_seconds(
                self.mc, self.spec, len(self.running), self.mean_ctx())
            dt += step_t
            done = []
            for r in self.running:
                r.tokens_out += 1
                if r.tokens_out >= r.gen_len:
                    r.done_s = now + dt
                    done.append(r)
            self.running = [r for r in self.running if r not in done]
        self.busy_s += dt
        self.energy_j += cm.step_energy_j(self.spec, dt, busy=True)
        return dt


@dataclasses.dataclass
class ServeResult:
    requests: List[Request]
    mean_latency_s: float
    p99_latency_s: float
    mean_ttft_s: float
    throughput_rps: float
    energy_j: float
    edp: float
    dispatch_fast: int
    dispatch_slow: int
    dispatch_busy_s: float
    makespan_s: float


def run_engine(requests: List[Request], dispatcher, cfg: EngineConfig,
               spec: cm.ReplicaSpec, mc: cm.ModelCost) -> ServeResult:
    """Event-driven serving simulation with a serial dispatcher."""
    reps = [Replica(i, spec, mc, cfg.max_batch)
            for i in range(cfg.n_replicas)]
    # event heap: (time, seq, kind, payload)
    ev: List = []
    seqno = 0
    for r in sorted(requests, key=lambda r: r.arrival_s):
        heapq.heappush(ev, (r.arrival_s, seqno, "arrive", r))
        seqno += 1
    disp_free = 0.0
    disp_busy = 0.0
    n_fast = n_slow = 0
    rep_next: Dict[int, float] = {}

    def schedule_rep(i: int, t: float):
        nonlocal seqno
        if rep_next.get(i, -1.0) < t:
            rep_next[i] = t
            heapq.heappush(ev, (t, seqno, "step", i))
            seqno += 1

    now = 0.0
    while ev:
        now, _, kind, payload = heapq.heappop(ev)
        if kind == "arrive":
            req: Request = payload
            t0 = max(now, disp_free)
            choice, lat = dispatcher.dispatch(req, reps, now)
            disp_free = t0 + lat
            disp_busy += lat
            if dispatcher.last_was_slow:
                n_slow += 1
            else:
                n_fast += 1
            req.replica = choice
            req.dispatched_s = disp_free
            heapq.heappush(ev, (disp_free, seqno, "enqueue", req))
            seqno += 1
        elif kind == "enqueue":
            req = payload
            reps[req.replica].queue.append(req)
            schedule_rep(req.replica, max(now, reps[req.replica].free_at))
        else:  # replica step
            i = payload
            rep = reps[i]
            if rep.queue or rep.running:
                start = max(now, rep.free_at)
                dt = rep.step(start)
                rep.free_at = start + dt
                if rep.queue or rep.running:
                    schedule_rep(i, rep.free_at)

    done = [r for r in requests if r.done_s >= 0]
    lat = np.array([r.done_s - r.arrival_s for r in done]) if done else \
        np.array([np.inf])
    ttft = np.array([r.first_token_s - r.arrival_s for r in done]) if done \
        else np.array([np.inf])
    makespan = max((r.done_s for r in done), default=0.0)
    energy = sum(r.energy_j for r in reps)
    # idle energy for the makespan
    for rep in reps:
        energy += cm.step_energy_j(spec, max(makespan - rep.busy_s, 0.0),
                                   busy=False)
    mean_lat = float(lat.mean())
    return ServeResult(
        requests=requests,
        mean_latency_s=mean_lat,
        p99_latency_s=float(np.percentile(lat, 99)),
        mean_ttft_s=float(ttft.mean()),
        throughput_rps=len(done) / makespan if makespan else 0.0,
        energy_j=float(energy),
        edp=float(energy) * mean_lat,
        dispatch_fast=n_fast,
        dispatch_slow=n_slow,
        dispatch_busy_s=disp_busy,
        makespan_s=makespan,
    )


def poisson_requests(rate_rps: float, n: int, seed: int = 0,
                     prompt_mean: int = 512, gen_mean: int = 64
                     ) -> List[Request]:
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    gaps[0] = 0.0
    t = np.cumsum(gaps)
    out = []
    for i in range(n):
        out.append(Request(
            rid=i, arrival_s=float(t[i]),
            prompt_len=int(np.clip(rng.lognormal(np.log(prompt_mean), 0.6),
                                   16, 8192)),
            gen_len=int(np.clip(rng.lognormal(np.log(gen_mean), 0.5),
                                4, 1024)),
        ))
    return out
