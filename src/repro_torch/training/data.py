# Port of repro/training/data.py: the same numpy pipeline, a copy (nothing to rewrite).
"""Synthetic-but-learnable token pipeline (no external datasets offline).

Produces deterministic, seeded batches with Zipf-distributed unigrams plus a
copy/induction structure (so a real LM can actually reduce loss on it), with
background prefetch — a realistic stand-in for a production input pipeline.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    """Order-2 Markov-ish stream: next token = f(prev) with noise."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab)
        ranks = np.arange(1, vocab + 1)
        p = 1.0 / ranks ** 1.1
        self.unigram = p / p.sum()
        self.rng = np.random.default_rng(seed + 1)

    def sample(self, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = self.rng.choice(self.vocab, size=batch, p=self.unigram)
        noise = self.rng.random((batch, seq))
        fresh = self.rng.choice(self.vocab, size=(batch, seq),
                                p=self.unigram)
        for t in range(seq):
            det = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, det, fresh[:, t])
        return toks


class DataLoader:
    """Background-thread prefetching loader yielding {tokens, labels}."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 prefetch: int = 2, extra_fn=None):
        self.gen = SyntheticLM(vocab, seed)
        self.batch, self.seq = batch, seq
        self.extra_fn = extra_fn
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self):
        toks = self.gen.sample(self.batch, self.seq)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.extra_fn is not None:
            out.update(self.extra_fn(self.batch, self.seq))
        return out

    def _worker(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make(), timeout=0.2)
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
