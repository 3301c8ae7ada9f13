"""Data pipeline: synthetic + file-backed token streams with background
prefetch and deterministic resume. A copy of the JAX package's
`data/pipeline.py`, which is numpy only: the port imports nothing of it.

`SyntheticLM` generates a learnable distribution (noisy affine next-token
process) so integration tests can assert the loss actually decreases.
`TokenFileDataset` memory-maps pre-tokenized uint16/int32 shards.
`Prefetcher` overlaps host batch assembly with device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """next = (a*prev + c) % V with probability (1-noise), else uniform."""

    def __init__(self, vocab: int, batch: int, seq_len: int,
                 n_codebooks: int = 1, noise: float = 0.1,
                 a: int = 31, c: int = 7, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq_len
        self.K = n_codebooks
        self.noise, self.a, self.c = noise, a, c
        self.seed = seed
        self.step = 0

    def set_step(self, step: int):
        self.step = step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 100003 + self.step)
                                    % (2 ** 31 - 1))
        self.step += 1
        shape = ((self.batch, self.K, self.seq + 1) if self.K > 1
                 else (self.batch, self.seq + 1))
        toks = np.empty(shape, np.int32)
        first = rng.randint(0, self.vocab, shape[:-1])
        toks[..., 0] = first
        for t in range(1, self.seq + 1):
            nxt = (self.a * toks[..., t - 1] + self.c) % self.vocab
            flip = rng.rand(*shape[:-1]) < self.noise
            rand = rng.randint(0, self.vocab, shape[:-1])
            toks[..., t] = np.where(flip, rand, nxt)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


class TokenFileDataset:
    """Memory-mapped token shards: files of raw int32 tokens. Batches are
    sequential windows with deterministic shuffled shard order; `set_step`
    makes resume exact."""

    def __init__(self, paths, batch: int, seq_len: int, seed: int = 0):
        self.mms = [np.memmap(p, dtype=np.int32, mode="r") for p in paths]
        self.sizes = [len(m) for m in self.mms]
        self.batch, self.seq = batch, seq_len
        self.seed = seed
        self.step = 0
        self.total_windows = sum(s // (seq_len + 1) for s in self.sizes)

    def set_step(self, step: int):
        self.step = step

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(self.total_windows)
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        for i in range(self.batch):
            w = order[(self.step * self.batch + i) % self.total_windows]
            # locate window w across shards
            for m, size in zip(self.mms, self.sizes):
                nw = size // (self.seq + 1)
                if w < nw:
                    s0 = w * (self.seq + 1)
                    toks[i] = m[s0:s0 + self.seq + 1]
                    break
                w -= nw
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch with bounded queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        except BaseException as e:
            self.q.put(e)
        self.q.put(StopIteration())

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, StopIteration):
            raise item
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
