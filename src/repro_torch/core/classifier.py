"""Classifier zoo for the DAS preselection step.

Implemented from scratch (no sklearn available offline):
  * Decision trees (exhaustive threshold search, Gini impurity) for depths
    1..16 — the paper adopts depth 2 on 2 features.
  * Logistic regression trained with full-batch gradient descent through
    torch autograd — the paper's LR baseline (Table II).
  * Mutual-information-style univariate feature scoring for the feature
    space exploration (Section IV-B).

Storage accounting follows the paper's methodology: a DT node stores a
feature id + threshold (or a leaf label); LR stores one weight per feature
plus a bias.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.core.simulator import DTree


# ---------------------------------------------------------------------------
# Decision tree (CART, Gini)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: "_Node | None" = None
    right: "_Node | None" = None
    label: int = 0
    is_leaf: bool = False


def _gini_split(x: np.ndarray, y: np.ndarray, w: np.ndarray,
                n_thresholds: int = 64):
    """Best (threshold, gini) for one feature column with sample weights.
    Candidate thresholds are quantiles — exhaustive over up to n_thresholds
    candidate cuts."""
    qs = np.unique(np.quantile(x, np.linspace(0.02, 0.98, n_thresholds)))
    if qs.size == 0:
        return None
    best = None
    wtot = w.sum()
    for thr in qs:
        right = x >= thr
        wr = w[right].sum()
        wl = wtot - wr
        if wl <= 0 or wr <= 0:
            continue
        pl = (w[~right] * y[~right]).sum() / wl
        pr = (w[right] * y[right]).sum() / wr
        g = (wl / wtot) * 2 * pl * (1 - pl) + (wr / wtot) * 2 * pr * (1 - pr)
        if best is None or g < best[1]:
            best = (float(thr), float(g))
    return best


def _wlabel(y: np.ndarray, w: np.ndarray) -> int:
    if y.size == 0:
        return 0
    p = (w * y).sum() / w.sum()
    return int(p >= 0.5)


def _build(x: np.ndarray, y: np.ndarray, w: np.ndarray, depth: int,
           min_samples: int = 8) -> _Node:
    node = _Node()
    if depth == 0 or y.size < min_samples or y.min() == y.max():
        node.is_leaf = True
        node.label = _wlabel(y, w)
        return node
    best = None  # (gini, feat, thr)
    for f in range(x.shape[1]):
        r = _gini_split(x[:, f], y, w)
        if r is not None and (best is None or r[1] < best[0]):
            best = (r[1], f, r[0])
    if best is None:
        node.is_leaf = True
        node.label = _wlabel(y, w)
        return node
    _, f, thr = best
    right = x[:, f] >= thr
    if right.all() or (~right).all():
        node.is_leaf = True
        node.label = _wlabel(y, w)
        return node
    node.feature, node.threshold = f, thr
    node.left = _build(x[~right], y[~right], w[~right], depth - 1,
                       min_samples)
    node.right = _build(x[right], y[right], w[right], depth - 1, min_samples)
    return node


@dataclasses.dataclass
class DecisionTree:
    root: _Node
    depth: int
    feature_ids: List[int]   # column ids used at fit time (global feature ids)

    @staticmethod
    def fit(x: np.ndarray, y: np.ndarray, depth: int,
            feature_ids: Sequence[int] | None = None,
            class_weight: str | None = "balanced") -> "DecisionTree":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.int32)
        if feature_ids is None:
            feature_ids = list(range(x.shape[1]))
        if class_weight == "balanced" and 0 < y.sum() < y.size:
            w1 = y.size / (2.0 * y.sum())
            w0 = y.size / (2.0 * (y.size - y.sum()))
            w = np.where(y == 1, w1, w0).astype(np.float64)
        else:
            w = np.ones(y.size, np.float64)
        return DecisionTree(
            root=_build(x, y, w, depth), depth=depth,
            feature_ids=list(feature_ids),
        )

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        out = np.zeros(x.shape[0], np.int32)

        def walk(node: _Node, idx: np.ndarray):
            if node.is_leaf:
                out[idx] = node.label
                return
            right = x[idx, node.feature] >= node.threshold
            walk(node.left, idx[~right])
            walk(node.right, idx[right])

        walk(self.root, np.arange(x.shape[0]))
        return out

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(x) == np.asarray(y)).mean())

    def n_nodes(self) -> int:
        def cnt(n: _Node) -> int:
            return 1 if n.is_leaf else 1 + cnt(n.left) + cnt(n.right)
        return cnt(self.root)

    def storage_kb(self) -> float:
        """Paper-style storage: internal nodes keep (feat id u8, thr f32),
        leaves keep a 1-byte label."""
        def walk(n: _Node):
            return (1,) if n.is_leaf else (5 + walk(n.left)[0]
                                           + walk(n.right)[0],)
        return walk(self.root)[0] / 1024.0

    def to_depth2_arrays(self) -> DTree:
        """Lower a depth<=2 tree to the simulator's fixed DTree tensors
        (on the CPU; `run_batch` moves them to its own device).

        Missing children become pass-through nodes replicating the parent's
        leaf label.
        """
        feat = np.zeros(3, np.int32)
        thr = np.zeros(3, np.float32)
        leaf = np.zeros(4, np.int32)
        r = self.root
        if r.is_leaf:
            feat[:] = 0
            thr[:] = np.inf  # everything goes left
            leaf[:] = r.label
            return _dtree(feat, thr, leaf)
        feat[0] = self.feature_ids[r.feature]
        thr[0] = r.threshold
        for side, child in ((0, r.left), (1, r.right)):
            node_i = 1 + side
            if child.is_leaf:
                feat[node_i] = 0
                thr[node_i] = np.inf
                leaf[2 * side] = child.label
                leaf[2 * side + 1] = child.label
            else:
                feat[node_i] = self.feature_ids[child.feature]
                thr[node_i] = child.threshold
                leaf[2 * side] = child.left.label
                leaf[2 * side + 1] = child.right.label
        return _dtree(feat, thr, leaf)


def _dtree(feat, thr, leaf) -> DTree:
    return DTree(*[torch.as_tensor(x) for x in (feat, thr, leaf)])


# ---------------------------------------------------------------------------
# Logistic regression (torch autograd, full-batch GD with standardization)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LogisticRegression:
    w: np.ndarray
    b: float
    mu: np.ndarray
    sigma: np.ndarray

    @staticmethod
    def fit(x: np.ndarray, y: np.ndarray, steps: int = 400,
            lr: float = 0.3, l2: float = 1e-4,
            device="cuda") -> "LogisticRegression":
        """Deterministic full-batch gradient descent from zero weights
        (the reference's steps, learning rate and L2), float32."""
        dev = resolve(device)
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        mu = x.mean(0)
        sigma = x.std(0) + 1e-6
        xs = torch.as_tensor((x - mu) / sigma, device=dev)
        yt = torch.as_tensor(y, device=dev)
        w = torch.zeros(x.shape[1], device=dev, requires_grad=True)
        b = torch.zeros((), device=dev, requires_grad=True)
        for _ in range(steps):
            logits = xs @ w + b
            nll = torch.mean(torch.clamp_min(logits, 0) - logits * yt
                             + torch.log1p(torch.exp(-logits.abs())))
            loss = nll + l2 * torch.sum(w * w)
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                w -= lr * gw
                b -= lr * gb
        return LogisticRegression(w.detach().cpu().numpy(),
                                  float(b.detach().cpu()), mu, sigma)

    def predict(self, x: np.ndarray) -> np.ndarray:
        xs = (np.asarray(x, np.float32) - self.mu) / self.sigma
        return (xs @ self.w + self.b >= 0).astype(np.int32)

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(x) == np.asarray(y)).mean())

    def storage_kb(self) -> float:
        # one f32 weight per feature + bias
        return (self.w.size + 1) * 4 / 1024.0


# ---------------------------------------------------------------------------
# Feature scoring / selection
# ---------------------------------------------------------------------------
def feature_scores(x: np.ndarray, y: np.ndarray, depth: int = 2) -> np.ndarray:
    """Univariate score per feature = accuracy of a depth-`depth` stump tree
    trained on that feature alone (the paper's 'feature importance')."""
    scores = np.zeros(x.shape[1])
    for f in range(x.shape[1]):
        t = DecisionTree.fit(x[:, [f]], y, depth=depth, feature_ids=[f])
        scores[f] = t.accuracy(x[:, [f]], y)
    return scores


def greedy_select(x: np.ndarray, y: np.ndarray, k: int,
                  depth: int = 2) -> List[int]:
    """Greedy forward feature selection maximizing DT accuracy."""
    chosen: List[int] = []
    for _ in range(k):
        best = None
        for f in range(x.shape[1]):
            if f in chosen:
                continue
            cols = chosen + [f]
            t = DecisionTree.fit(x[:, cols], y, depth=depth, feature_ids=cols)
            acc = t.accuracy(x[:, cols], y)
            if best is None or acc > best[1]:
                best = (f, acc)
        chosen.append(best[0])
    return chosen
