"""Request dispatchers: LUT (fast), ETF (slow), DAS (preselected), and the
static-threshold heuristic — the paper's scheduler set transplanted to
serving. The DAS classifier is the same depth-2 decision tree machinery
(core.classifier), trained by the same two-execution oracle protocol
(`train_das_dispatcher`) on features (request arrival rate, earliest
replica availability). The port of `repro/serve/dispatch.py`, on numpy.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import classifier as clf

# dispatch-path latencies (host-side, seconds): LUT is an O(1) table probe;
# ETF walks every replica queue with the cost model (scales with queued
# requests); the DAS classifier itself is prefetched/off-path (paper III-B).
LUT_LATENCY = 2e-6
ETF_BASE = 2e-5
ETF_PER_ITEM = 4e-6


class _RateTracker:
    """8-entry arrival shift register (paper's data-rate counter)."""

    def __init__(self):
        self.ring = [0.0] * 8
        self.n = 0

    def observe(self, t: float):
        self.ring[self.n % 8] = t
        self.n += 1

    def rate(self) -> float:
        if self.n < 2:
            return 0.0
        c = min(self.n, 8)
        ts = sorted(self.ring[:c])
        span = ts[-1] - ts[0]
        return (c - 1) / span if span > 0 else 0.0


def _features(req, replicas, now, rate) -> np.ndarray:
    avail = min(max(r.free_at - now, 0.0) for r in replicas)
    qlen = sum(len(r.queue) + len(r.running) for r in replicas)
    return np.array([rate, avail, qlen, req.prompt_len, req.gen_len],
                    np.float32)


FEAT_NAMES = ("arrival_rate", "earliest_replica_avail", "total_queued",
              "prompt_len", "gen_len")
PAPER_FEATURES = (0, 1)   # rate + earliest availability, as in the paper


class LUTDispatcher:
    """O(1): static bucket table (by prompt-size class) -> replica,
    round-robin within bucket. The serving analog of 'most energy-efficient
    PE per task type': smallest adequate replica, no queue inspection."""

    name = "LUT"

    def __init__(self, n_replicas: int):
        self.n = n_replicas
        self.rr = [0] * 4
        self.last_was_slow = False

    def _bucket(self, req) -> int:
        return int(min(np.log2(max(req.prompt_len, 16)) - 4, 3))

    def dispatch(self, req, replicas, now):
        b = self._bucket(req)
        self.rr[b] = (self.rr[b] + 1) % self.n
        self.last_was_slow = False
        return (b + self.rr[b]) % self.n, LUT_LATENCY


class ETFDispatcher:
    """Slow/sophisticated: earliest-estimated-finish-time over replicas."""

    name = "ETF"

    def __init__(self):
        self.last_was_slow = True

    def dispatch(self, req, replicas, now):
        self.last_was_slow = True
        est = [r.estimate_finish(req, now) for r in replicas]
        n_items = sum(len(r.queue) + len(r.running) for r in replicas)
        lat = ETF_BASE + ETF_PER_ITEM * n_items
        return int(np.argmin(est)), lat


class DASDispatcher:
    """Depth-2 DT preselects LUT vs ETF per request (zero added latency:
    features are refreshed off the dispatch path, paper III-B)."""

    name = "DAS"

    def __init__(self, tree: clf.DecisionTree, n_replicas: int,
                 feature_ids=PAPER_FEATURES):
        self.tree = tree
        self.fast = LUTDispatcher(n_replicas)
        self.slow = ETFDispatcher()
        self.rt = _RateTracker()
        self.feature_ids = list(feature_ids)
        self.last_was_slow = False

    def dispatch(self, req, replicas, now):
        self.rt.observe(req.arrival_s)
        f = _features(req, replicas, now, self.rt.rate())
        use_slow = bool(self.tree.predict(
            f[self.feature_ids][None])[0])
        self.last_was_slow = use_slow
        if use_slow:
            return self.slow.dispatch(req, replicas, now)
        return self.fast.dispatch(req, replicas, now)


class ThresholdDispatcher:
    """Paper's heuristic baseline: rate below threshold -> LUT, else ETF."""

    name = "threshold"

    def __init__(self, rate_threshold: float, n_replicas: int):
        self.thr = rate_threshold
        self.fast = LUTDispatcher(n_replicas)
        self.slow = ETFDispatcher()
        self.rt = _RateTracker()
        self.last_was_slow = False

    def dispatch(self, req, replicas, now):
        self.rt.observe(req.arrival_s)
        use_slow = self.rt.rate() >= self.thr
        self.last_was_slow = use_slow
        if use_slow:
            return self.slow.dispatch(req, replicas, now)
        return self.fast.dispatch(req, replicas, now)


class OracleDispatcher:
    """First-execution instrumentation: computes both, follows LUT, logs
    agreement + features (paper Fig. 1)."""

    name = "oracle"

    def __init__(self, n_replicas: int):
        self.fast = LUTDispatcher(n_replicas)
        self.slow = ETFDispatcher()
        self.rt = _RateTracker()
        self.features: List[np.ndarray] = []
        self.agree: List[bool] = []
        self.last_was_slow = False

    def dispatch(self, req, replicas, now):
        self.rt.observe(req.arrival_s)
        self.features.append(_features(req, replicas, now, self.rt.rate()))
        cf, _ = self.fast.dispatch(req, replicas, now)
        cs, _ = self.slow.dispatch(req, replicas, now)
        self.agree.append(cf == cs)
        self.last_was_slow = False
        return cf, LUT_LATENCY


def train_das_dispatcher(scenarios, cfg, spec, mc,
                         feature_ids=PAPER_FEATURES,
                         metric: str = "mean_latency_s") -> DASDispatcher:
    """Two-execution oracle over (rate, seed) scenarios -> depth-2 DT."""
    from repro_torch.serve import engine as eng
    X: List[np.ndarray] = []
    y: List[np.ndarray] = []
    for rate, n, seed in scenarios:
        reqs1 = eng.poisson_requests(rate, n, seed)
        orc = OracleDispatcher(cfg.n_replicas)
        r1 = eng.run_engine(reqs1, orc, cfg, spec, mc)
        reqs2 = eng.poisson_requests(rate, n, seed)
        r2 = eng.run_engine(reqs2, ETFDispatcher(), cfg, spec, mc)
        pending = 1 if getattr(r2, metric) < getattr(r1, metric) else 0
        lab = np.where(np.array(orc.agree), 0, pending)
        X.append(np.stack(orc.features))
        y.append(lab)
    Xa = np.concatenate(X)
    ya = np.concatenate(y).astype(np.int32)
    cols = list(feature_ids)
    tree = clf.DecisionTree.fit(Xa[:, cols], ya, depth=2, feature_ids=cols)
    d = DASDispatcher(tree, cfg.n_replicas, feature_ids=cols)
    d.train_accuracy = tree.accuracy(Xa[:, cols], ya)
    d.label_slow_frac = float(ya.mean())
    return d
