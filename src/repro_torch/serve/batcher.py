"""Request batching with admission control, deadlines, and straggler
mitigation (DESIGN.md §13).

Continuous-batching-lite: requests queue; the dispatcher assembles fixed-
size batches (pad to max_batch) grouped into length buckets so positional
state stays uniform per batch. Straggler mitigation = hedged backup
requests: if a batch's execution exceeds `hedge_factor x` the EWMA
latency, the work is re-issued (in-process simulation of the multi-replica
hedge; the hook is where a real deployment would target a second replica).

Admission control: with ``max_queue`` set, a submit past the high
watermark is REJECTED WITH AN ERROR (``AdmissionRejected`` on the
returned request) instead of growing the queue without bound — load is
shed explicitly at the front door, never by silently dropping queued
work. Multi-tenant fairness (DESIGN.md §14) adds two PER-TENANT gates
evaluated under the same admission lock: ``tenant_quota`` caps how many
of one tenant's requests may occupy the queue at once (a noisy tenant
fills its own slice, never the whole queue), and ``tenant_rate`` is a
per-tenant token bucket (requests/s, burst ``tenant_burst``) shedding
sustained overload before it queues at all. Both rejections carry the
tenant in the error and in ``tenant=``-labeled rejection counters. Per-request deadlines (``default_deadline_s`` / per-submit
``deadline_s``) are absolute instants measured from submission:
requests that expire while queued complete with ``DeadlineExceeded``
before wasting execution, and a dispatched batch runs under a
``deadline_scope`` at the tightest member deadline so the layers below
(planner scatter) can stop early.

Failure isolation: a batch whose execution raises (e.g. a shard failing
mid-gather in the fabric planner) completes ONLY its own requests with
``error`` set — the rest of the queue, including other intent buckets,
stays drainable and later submits still work. All completion paths go
through one idempotent ``_complete`` so no path can double-complete or
double-count a request.

Observability (DESIGN.md §12): the batcher is the TRACE ROOT of the
serving stack — each dispatched batch opens one ``obs.trace("batch")``
so every layer underneath (planner scatter, per-shard engine pass,
index scans, kernel dispatches) lands in one span tree, finished traces
feed the latency histograms and the slow-query log. All counters live
in the process-wide metrics registry under a per-instance ``batcher``
label; the old hand-rolled ``stats`` dict survives as a read-only
compatibility property over those series. Queue depth and time-in-queue
are recorded as histograms (``enqueued_at`` was already on the wire).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ..obs import FLIGHT_RECORDER, REGISTRY, SLO_ENGINE, trace
from .deadline import DeadlineExceeded, deadline_scope


class AdmissionRejected(RuntimeError):
    """Submit refused: the admission queue is at its high watermark.
    The caller sees the rejection immediately (request completes with
    this error) and can back off — nothing was enqueued."""


@dataclasses.dataclass
class Request:
    req_id: int
    payload: Any
    bucket: Any = 0            # any equality-comparable bucket key
    tenant: str = ""           # submitting tenant ("" = default)
    enqueued_at: float = 0.0
    deadline_at: Optional[float] = None  # absolute perf_counter instant
    result: Any = None
    done: bool = False
    hedged: bool = False
    error: Optional[Exception] = None   # set iff the request failed
    info: dict = dataclasses.field(default_factory=dict)


class Batcher:
    _ids = itertools.count()

    def __init__(self, run_batch: Callable[[list[Any]], list[Any]],
                 max_batch: int = 8, max_wait_s: float = 0.0,
                 bucket_fn: Optional[Callable[[Any], Any]] = None,
                 hedge_factor: float = 3.0,
                 label: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 annotate: Optional[Callable[[], Optional[dict]]] = None,
                 tenant_quota: Optional[int] = None,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[int] = None):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.bucket_fn = bucket_fn or (lambda p: 0)
        self.hedge_factor = hedge_factor
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.annotate = annotate
        self.tenant_quota = tenant_quota
        self.tenant_rate = tenant_rate
        self.tenant_burst = (tenant_burst if tenant_burst is not None
                             else (max(1, int(tenant_rate))
                                   if tenant_rate is not None else None))
        self._tenant_queued: dict[str, int] = {}
        # tenant -> [tokens, last_refill_instant]
        self._tenant_tokens: dict[str, list[float]] = {}
        self._queue: deque[Request] = deque()
        # admission check + append must be atomic: submits may come from
        # a different thread than the drain loop (DESIGN.md §13)
        self._qlock = threading.Lock()
        self._next_id = 0
        self._lat_ewma: Optional[float] = None
        # registry-backed stats (one labeled series set per instance)
        self.label = label or f"b{next(Batcher._ids)}"
        lbl = {"batcher": self.label}
        self._c_batches = REGISTRY.counter("batcher_batches", **lbl)
        self._c_requests = REGISTRY.counter("batcher_requests", **lbl)
        self._c_hedges = REGISTRY.counter("batcher_hedges", **lbl)
        self._c_failed = REGISTRY.counter("batcher_failed_batches", **lbl)
        self._c_rejected = REGISTRY.counter("batcher_rejected", **lbl)
        self._c_deadline = REGISTRY.counter("batcher_deadline_expired",
                                            **lbl)
        self._h_batch_ms = REGISTRY.histogram("batcher_batch_ms", **lbl)
        self._h_queue_depth = REGISTRY.histogram("batcher_queue_depth",
                                                 **lbl)
        self._h_queue_wait_ms = REGISTRY.histogram(
            "batcher_time_in_queue_ms", **lbl)

    @property
    def stats(self) -> dict:
        """Compatibility shim over the metrics registry: the same keys
        the old hand-rolled dict exposed, computed from the live
        counters (read-only snapshot)."""
        batches = int(self._c_batches.value)
        requests = int(self._c_requests.value)
        return {"batches": batches, "requests": requests,
                "hedges": int(self._c_hedges.value),
                "failed_batches": int(self._c_failed.value),
                "rejected": int(self._c_rejected.value),
                "deadline_expired": int(self._c_deadline.value),
                "mean_batch_size": (requests / batches) if batches else 0.0}

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _tenant_admit_locked(self, tenant: str, now: float
                             ) -> Optional[str]:
        """Per-tenant admission gates (caller holds ``_qlock``). Returns
        a rejection reason, or None and CHARGES the tenant (queue slot
        + one rate token)."""
        if (self.tenant_quota is not None
                and self._tenant_queued.get(tenant, 0)
                >= self.tenant_quota):
            return (f"tenant {tenant or 'default'!r} at queue quota "
                    f"({self.tenant_quota})")
        if self.tenant_rate is not None:
            bucket = self._tenant_tokens.get(tenant)
            if bucket is None:
                bucket = [float(self.tenant_burst), now]
                self._tenant_tokens[tenant] = bucket
            tokens = min(float(self.tenant_burst),
                         bucket[0] + (now - bucket[1]) * self.tenant_rate)
            bucket[1] = now
            if tokens < 1.0:
                bucket[0] = tokens
                return (f"tenant {tenant or 'default'!r} over rate "
                        f"limit ({self.tenant_rate}/s)")
            bucket[0] = tokens - 1.0
        if self.tenant_quota is not None:
            self._tenant_queued[tenant] = \
                self._tenant_queued.get(tenant, 0) + 1
        return None

    def submit(self, payload: Any,
               deadline_s: Optional[float] = None,
               tenant: str = "") -> Request:
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(self._next_id, payload,
                      bucket=self.bucket_fn(payload),
                      tenant=tenant,
                      enqueued_at=now,
                      deadline_at=(now + deadline_s)
                      if deadline_s is not None else None)
        self._next_id += 1
        reason: Optional[str] = None
        with self._qlock:
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                reason = (f"queue at high watermark ({self.max_queue}) "
                          f"— request {req.req_id} shed")
            else:
                reason = self._tenant_admit_locked(tenant, now)
                if reason is None:
                    self._queue.append(req)
        if reason is not None:
            self._complete([req], error=AdmissionRejected(reason))
            self._c_rejected.inc()
            REGISTRY.counter("batcher_tenant_rejected",
                             batcher=self.label,
                             tenant=tenant or "default").inc()
            # a shed request never gets a trace, so the SLO engine and
            # flight recorder hear about it HERE (DESIGN.md §15) — an
            # admission rejection is always a bad event and always an
            # interesting record
            if SLO_ENGINE.active:
                SLO_ENGINE.observe(tenant or "default", str(req.bucket),
                                   None, ok=False)
            if FLIGHT_RECORDER.enabled:
                FLIGHT_RECORDER.observe_event(
                    "admission_rejected", batcher=self.label,
                    tenant=tenant or "default",
                    intent=str(req.bucket), detail=reason)
        return req

    def _take_batch(self) -> list[Request]:
        with self._qlock:
            if not self._queue:
                return []
            self._h_queue_depth.observe(len(self._queue))
            bucket = self._queue[0].bucket
            batch = []
            rest = deque()
            while self._queue and len(batch) < self.max_batch:
                r = self._queue.popleft()
                (batch if r.bucket == bucket else rest).append(r)
            self._queue.extendleft(reversed(rest))
            if self.tenant_quota is not None:
                for r in batch:    # release each tenant's queue slot
                    left = self._tenant_queued.get(r.tenant, 0) - 1
                    if left > 0:
                        self._tenant_queued[r.tenant] = left
                    else:
                        self._tenant_queued.pop(r.tenant, None)
            return batch

    def _complete(self, reqs: list[Request], results=None,
                  error: Optional[Exception] = None) -> int:
        """THE single completion path — idempotent: an already-done
        request is skipped, so no sequence of batch-failure / hedge /
        deadline paths can double-complete or double-count one.
        Returns how many requests this call actually completed."""
        n = 0
        for i, r in enumerate(reqs):
            if r.done:
                continue
            r.error = error
            r.result = results[i] if results is not None else None
            r.done = True
            n += 1
        return n

    def _execute(self, batch: list[Request]) -> None:
        t_start = time.perf_counter()
        live = []
        max_wait_ms = 0.0
        for r in batch:
            wait_ms = (t_start - r.enqueued_at) * 1e3
            self._h_queue_wait_ms.observe(wait_ms)
            if r.deadline_at is not None and t_start >= r.deadline_at:
                # expired while queued: explicit error — load shedding
                # never silently drops a request
                n = self._complete([r], error=DeadlineExceeded(
                    f"request {r.req_id}: deadline expired in queue"))
                self._c_deadline.inc(n)
                if n and SLO_ENGINE.active:
                    SLO_ENGINE.observe(r.tenant or "default",
                                       str(r.bucket), None, ok=False)
            else:
                live.append(r)
                if wait_ms > max_wait_ms:
                    max_wait_ms = wait_ms
        if not live:
            return
        dls = [r.deadline_at for r in live if r.deadline_at is not None]
        tenants = sorted({r.tenant for r in live})
        with trace("batch", intent=str(live[0].bucket),
                   tenant=(tenants[0] or "default"
                           if len(tenants) == 1 else "mixed")) as root:
            root.add("batch_size", len(live))
            # time the batch's slowest member spent queued — the cost
            # attributor's queue-bound signal (obs/cost.py)
            root.add("queue_wait_ms", round(max_wait_ms, 3))
            # the batch executes once for everyone, so it runs under the
            # TIGHTEST member deadline (absolute — queueing time already
            # counted against it)
            with deadline_scope(at=min(dls) if dls else None):
                self._run(live)
        self._h_batch_ms.observe((time.perf_counter() - t_start) * 1e3)

    def _run(self, batch: list[Request]) -> None:
        t0 = time.perf_counter()
        try:
            results = self.run_batch([r.payload for r in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(batch)} requests")
        except Exception as e:   # noqa: BLE001 — batch fault isolation
            # Failure domain = this batch only (e.g. a shard raising
            # mid-gather): its requests complete with error set; other
            # buckets still queued are untouched and keep draining.
            n = self._complete(batch, error=e)
            if isinstance(e, DeadlineExceeded):
                self._c_deadline.inc(n)
            self._c_requests.inc(n)
            self._c_batches.inc()
            self._c_failed.inc()
            return
        elapsed = time.perf_counter() - t0
        service = elapsed
        # hedged backup request on straggling execution
        if (self._lat_ewma is not None
                and elapsed > self.hedge_factor * self._lat_ewma):
            self._c_hedges.inc()
            t1 = time.perf_counter()
            try:
                retry = self.run_batch([r.payload for r in batch])
            except Exception:    # noqa: BLE001 — hedge is best-effort
                retry = None     # keep the straggler's (good) results
            hedge_elapsed = time.perf_counter() - t1
            if retry is not None and len(retry) == len(batch) \
                    and hedge_elapsed < elapsed:
                results = retry
                # learn the WINNER's service time: feeding the
                # straggler's latency back into the EWMA would inflate
                # the hedge threshold and suppress future hedges
                service = hedge_elapsed
            for r in batch:
                r.hedged = True
        self._lat_ewma = (service if self._lat_ewma is None
                          else 0.8 * self._lat_ewma + 0.2 * service)
        if self.annotate is not None:
            extra = self.annotate()
            if extra:
                for r in batch:
                    r.info.update(extra)
        self._c_requests.inc(self._complete(batch, results=results))
        self._c_batches.inc()

    def drain(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            self._execute(batch)


def intent_batcher(query_batch, k: int = 5, max_batch: int = 32,
                   max_wait_s: float = 0.0,
                   max_queue: Optional[int] = None,
                   default_deadline_s: Optional[float] = None,
                   annotate: Optional[Callable[[], Optional[dict]]] = None,
                   tenant_quota: Optional[int] = None,
                   tenant_rate: Optional[float] = None,
                   tenant_burst: Optional[int] = None) -> Batcher:
    """A Batcher over any retrieval callable with the engine signature
    ``query_batch(texts, k=..., at=..., window=..., visibility=...)`` —
    the one factory behind both ``LiveVectorLake.query_batcher`` and
    ``ShardFabric.query_batcher``.

    Payloads are query strings or ``(text, at, window)`` /
    ``(text, at, window, visibility)`` tuples; requests bucket by their
    RESOLVED temporal intent (frozen dataclass) AND visibility scope,
    so one dispatched batch maps to exactly one engine group — same
    intent, same tenant scope — whether the intent came from explicit
    args or the query text. Per-tenant admission (``tenant_quota`` /
    ``tenant_rate``) applies at ``submit(..., tenant=)``."""
    from ..core.temporal import classify_query
    from ..core.tenancy import visibility_key

    def norm(payload):
        if isinstance(payload, str):
            return payload, None, None, None
        if len(payload) == 3:
            return (*payload, None)
        return payload

    def bucket(payload):
        text, p_at, p_window, p_vis = norm(payload)
        return (classify_query(text, at=p_at, window=p_window),
                visibility_key(p_vis))

    def run(payloads: list) -> list:
        texts = [norm(p)[0] for p in payloads]
        # whole batch shares this intent AND visibility scope
        it, _ = bucket(payloads[0])
        vis = norm(payloads[0])[3]
        return query_batch(texts, k=k, at=it.at, window=it.window,
                           visibility=vis)

    return Batcher(run_batch=run, max_batch=max_batch,
                   max_wait_s=max_wait_s, bucket_fn=bucket,
                   max_queue=max_queue,
                   default_deadline_s=default_deadline_s,
                   annotate=annotate, tenant_quota=tenant_quota,
                   tenant_rate=tenant_rate, tenant_burst=tenant_burst)
