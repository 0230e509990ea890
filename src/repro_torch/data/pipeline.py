"""Training-data pipeline: synthetic token streams + background prefetch.

The ingest path of LiveVectorLake is the paper's data pipeline; THIS
module feeds the LM/recsys/GNN training loops. Prefetching runs on a
daemon thread with a bounded queue (host-side double buffering — the
standard TPU input-pipeline pattern)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def synthetic_lm_batches(vocab: int, batch: int, seq: int,
                         seed: int = 0) -> Iterator[dict]:
    """Zipf-ish synthetic token stream (deterministic)."""
    rng = np.random.default_rng(seed)
    while True:
        ranks = rng.zipf(1.3, size=(batch, seq))
        tokens = (ranks % (vocab - 4) + 4).astype(np.int32)
        yield {"tokens": tokens, "labels": tokens}


def synthetic_recsys_batches(n_fields: int, vocab_per_field: int,
                             batch: int, seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    offsets = np.arange(n_fields) * vocab_per_field
    while True:
        local = rng.integers(0, vocab_per_field, (batch, n_fields))
        yield {"ids": (local + offsets).astype(np.int32),
               "labels": rng.integers(0, 2, batch).astype(np.float32)}


class Prefetcher:
    """Bounded-queue background prefetch: next batch is host-ready while
    the device executes the current step."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
