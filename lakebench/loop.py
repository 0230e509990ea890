"""The closed loop: ``outstanding`` clients, each of which sends its next
query the moment its last one is answered, through the store's query
batcher (``submit``, then ``drain``, which runs batch after batch until
the queue is empty).

The batcher runs each batch through its ``run_batch`` callable. The loop
wraps that callable: when a batch's answers come back it stamps each
request's completion and submits one new request a finished one, so the
next batch is taken from a queue that holds ``outstanding`` requests
again. A hedged batch runs twice; its requests complete when the second
run returns, so their stamp is overwritten then, and only the first
return submits replacements. Once the window has closed no replacement
is sent, and ``drain`` returns when the last queued request is answered.

Like a client, the loop drops each answer once it has it, except for a
sample of ``sample`` requests kept for the correctness check, drawn
from ``rng`` over the send order (reservoir sampling), so the harness
holds no more objects at the end of the window than at its start.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Optional


@dataclasses.dataclass
class Sent:
    text: str
    at: Optional[int]
    req: object                      # the batcher's Request
    i: int                           # send index
    replaced: bool = False
    sampled: bool = False


class ClosedLoop:
    def __init__(self, batcher, traffic, outstanding: int, on_batch=None,
                 sample: int = 0, rng: Optional[random.Random] = None):
        self.batcher = batcher
        self.traffic = traffic
        self.outstanding = int(outstanding)
        self.on_batch = on_batch
        self.inner = batcher.run_batch
        batcher.run_batch = self._run
        self.sample = int(sample)
        self.rng = rng or random.Random(0)
        self.reservoir: list[Sent] = []
        self.live: dict[str, Sent] = {}
        self.last: list[str] = []        # texts of the batch that just ran
        # per request, by send index: submit and answer instants, success
        self.t_sent: list[float] = []
        self.t_done: list[float] = []
        self.ok: list[bool] = []
        # per batch: [first start, last end, requests served, first payload]
        self.batches: list[list] = []
        self.end = 0.0

    def _send(self) -> None:
        text, at = self.traffic.next()
        req = self.batcher.submit(text if at is None else (text, at, None))
        s = Sent(text, at, req, len(self.t_sent))
        self.t_sent.append(req.enqueued_at)
        self.t_done.append(math.nan)
        self.ok.append(False)
        self.live[text] = s
        if s.i < self.sample:
            s.sampled = True
            self.reservoir.append(s)
        elif self.sample:
            j = self.rng.randrange(s.i + 1)
            if j < self.sample:
                self.reservoir[j].sampled = False
                self.reservoir[j] = s
                s.sampled = True

    def _settle(self) -> None:
        """The batch before this one has completed: forget its requests
        (the sample holds its own references)."""
        for text in self.last:
            self.live.pop(text, None)
        self.last = []

    def _finish(self, payloads, t_begin: float, ok: bool) -> None:
        t = time.perf_counter()
        last = self.batches[-1] if self.batches else None
        if last is not None and last[3] is payloads[0]:
            last[1] = t                      # a hedge: the batch ends now
        else:
            self.batches.append([t_begin, t, len(payloads) if ok else 0,
                                 payloads[0]])
        fresh = 0
        for p in payloads:
            s = self.live[p if isinstance(p, str) else p[0]]
            self.t_done[s.i] = t
            self.ok[s.i] = ok
            if not s.replaced:
                s.replaced = True
                fresh += 1
                self.last.append(s.text)
        if t < self.end:
            for _ in range(fresh):
                self._send()

    def _run(self, payloads):
        self._settle()
        t_begin = time.perf_counter()
        try:
            out = self.inner(payloads)
        except Exception:
            self._finish(payloads, t_begin, ok=False)
            raise
        self._finish(payloads, t_begin, ok=True)
        if self.on_batch is not None:
            self.on_batch()
        return out

    def work_in_window(self, start: float, end: float) -> float:
        """Requests served in [start, end]: each batch counts its size
        times the share of its run (a hedged batch: both runs) that lies
        in the window, so the batch in flight at the close counts for the
        part of it the window saw."""
        done = 0.0
        for b0, b1, n, _ in self.batches:
            lo, hi = max(b0, start), min(b1, end)
            if hi > lo:
                done += n * (hi - lo) / (b1 - b0)
        return done

    def latencies_ms(self) -> list[float]:
        """Submit to answer of every request that was answered."""
        return [(d - s) * 1e3 for s, d, ok in
                zip(self.t_sent, self.t_done, self.ok) if ok]

    def failed(self) -> int:
        return sum(1 for ok in self.ok if not ok)

    def run(self, seconds: float) -> tuple[float, float]:
        """Fill the loop and drain until the window of ``seconds`` has
        closed and every request sent in it is answered. Returns the
        window's (start, end) on the host clock."""
        start = time.perf_counter()
        self.end = start + seconds
        for _ in range(self.outstanding):
            self._send()
        self.batcher.drain()
        self._settle()
        return start, self.end
