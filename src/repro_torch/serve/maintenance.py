"""Background maintenance workers (DESIGN.md §13).

Always-on serving means the heavyweight bookkeeping — memtable seal,
size-tiered segment compaction, cold-tier checkpointing and archive
compaction, rebalance steps — must run OFF the query path. This module
provides:

``MaintenanceWorker``
    One daemon thread draining a bounded, key-coalescing work queue.
    Jobs retry transient faults with exponential backoff; a full queue
    rejects new submissions (counted, never silently dropped — and safe
    to drop at this layer, because every maintenance wish is
    level-triggered: the condition that produced it re-fires the hook
    on the next write). ``drain()``/``stop()`` give tests and shutdown
    a clean barrier.

``StoreMaintenance``
    Wires one ``LiveVectorLake`` onto a worker: flips the segmented
    index into deferred-compaction mode (writes only queue wishes;
    seal/merge happen here), takes over cold-tier checkpoint cadence,
    and schedules archive compaction. The handoff preserves every
    crash-recovery invariant because the jobs run the exact same
    WAL-bracketed publish paths the inline versions ran — a crash
    mid-compaction in a worker thread recovers identically to a crash
    mid-compaction on the ingest thread (chaos-drill-tested).

Lock ordering discipline: worker jobs take storage locks (index/WAL)
but NEVER hold the worker's queue lock while running — submissions from
the serving thread can't deadlock against a running job.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..obs import REGISTRY, trace


class MaintenanceWorker:
    def __init__(self, name: str = "maintenance", max_queue: int = 64,
                 max_retries: int = 3, backoff_s: float = 0.002,
                 backoff_factor: float = 2.0):
        self.name = name
        self.max_queue = int(max_queue)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self._cond = threading.Condition()
        self._queue: deque[tuple[str, Callable[[], object]]] = deque()
        self._pending: set[str] = set()       # keys queued, for coalescing
        self._active = 0
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[tuple[str, Exception]] = None
        lbl = {"worker": name}
        self._c_jobs = REGISTRY.counter("maintenance_jobs", **lbl)
        self._c_retries = REGISTRY.counter("maintenance_retries", **lbl)
        self._c_failures = REGISTRY.counter("maintenance_failures", **lbl)
        self._c_rejected = REGISTRY.counter("maintenance_rejected", **lbl)
        self._h_job_ms = REGISTRY.histogram("maintenance_job_ms", **lbl)
        self._g_depth = REGISTRY.gauge("maintenance_queue_depth", **lbl)

    # ------------------------------------------------------------------
    def start(self) -> "MaintenanceWorker":
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._loop, name=self.name, daemon=True)
                self._thread.start()
        return self

    def submit(self, key: str, fn: Callable[[], object]) -> bool:
        """Queue one job. Same-key jobs coalesce (a queued wish already
        covers the condition); a full queue rejects — returns False and
        counts it, the caller's next wish retriggers."""
        with self._cond:
            if self._stopping:
                self._c_rejected.inc()
                return False
            if key in self._pending:
                return True                   # coalesced
            if len(self._queue) >= self.max_queue:
                self._c_rejected.inc()
                return False
            self._queue.append((key, fn))
            self._pending.add(key)
            self._g_depth.set(len(self._queue))
            self._cond.notify()
        self.start()
        return True

    def idle(self) -> bool:
        """True when nothing is queued or mid-run — the cheap check
        opportunistic (lowest-priority) jobs use before submitting."""
        with self._cond:
            return not self._queue and self._active == 0

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty AND no job is mid-run (or the
        timeout passes — returns False)."""
        limit = (time.perf_counter() + timeout
                 if timeout is not None else None)
        with self._cond:
            while self._queue or self._active:
                left = (None if limit is None
                        else limit - time.perf_counter())
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left)
            return True

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Stop the worker thread; with ``drain`` (default) queued work
        finishes first. Idempotent."""
        ok = self.drain(timeout) if drain else True
        with self._cond:
            self._stopping = True
            if not drain:
                self._queue.clear()
                self._pending.clear()
                self._g_depth.set(0)
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)
        return ok

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if not self._queue:
                    self._cond.notify_all()
                    return                    # stopping, queue drained
                key, fn = self._queue.popleft()
                self._pending.discard(key)
                self._active += 1
                self._g_depth.set(len(self._queue))
            try:
                # queue lock RELEASED: the job takes storage locks
                self._run_job(key, fn)
            finally:
                with self._cond:
                    self._active -= 1
                    self._cond.notify_all()

    def _run_job(self, key: str, fn: Callable[[], object]) -> None:
        t0 = time.perf_counter()
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._c_retries.inc()
                time.sleep(self.backoff_s
                           * self.backoff_factor ** (attempt - 1))
            try:
                # each attempt is its own root trace (worker threads
                # carry no contextvar from serving): a failed compaction
                # leaves an error span tree in the flight recorder, and
                # the "maintenance" intent gets its own slowlog budget
                # so long jobs don't drown real serving outliers
                with trace(f"maint:{key}", intent="maintenance"):
                    fn()
                self._c_jobs.inc()
                self._h_job_ms.observe((time.perf_counter() - t0) * 1e3)
                return
            except Exception as e:  # noqa: BLE001 — retry transient
                last = e
        # retries exhausted: the job is dropped (level-triggered wishes
        # re-fire; durable state is crash-safe by construction) but the
        # failure is LOUD — counted and kept for inspection
        self._c_failures.inc()
        self.last_error = (key, last)


class StoreMaintenance:
    """Background maintenance for one ``LiveVectorLake``: seal,
    compaction, cold checkpoint, and archive compaction move onto a
    ``MaintenanceWorker`` while the serving thread only ever queues
    wishes. ``start()`` flips the index into deferred mode; ``stop()``
    restores inline behavior (and drains)."""

    def __init__(self, store, worker: Optional[MaintenanceWorker] = None,
                 checkpoint_every: int = 8, archive_min_run: int = 2,
                 scrub_batch: int = 16, scrub_interval_s: float = 0.25,
                 scrub_pace_s: float = 0.002,
                 **worker_kw):
        self.store = store
        self.index = store.hot.index
        self.worker = worker or MaintenanceWorker(**worker_kw)
        self._own_worker = worker is None
        self.checkpoint_every = int(checkpoint_every)
        self.archive_min_run = int(archive_min_run)
        # background scrub cadence (DESIGN.md §16): every tick, at most
        # one ``scrub_batch``-artifact verify batch per
        # ``scrub_interval_s`` (0 disables). Rate-limited by TIME, not
        # write count, so an idle store still gets scrubbed as long as
        # anything ticks the hook.
        self.scrub_batch = int(scrub_batch)
        self.scrub_interval_s = float(scrub_interval_s)
        self.scrub_pace_s = float(scrub_pace_s)
        self._last_scrub = 0.0
        self._saved_ckpt_interval: Optional[int] = None
        self._last_ckpt_ver = 0
        self._started = False

    # ------------------------------------------------------------------
    def start(self) -> "StoreMaintenance":
        if self._started:
            return self
        self._started = True
        self.index.deferred_compaction = True
        self.index.maintenance_hook = self._on_wish
        # the worker drives checkpoint cadence; inline auto-checkpoint
        # off so commits never stall the ingest thread
        self._saved_ckpt_interval = self.store.cold.checkpoint_interval
        self.store.cold.checkpoint_interval = 0
        self._last_ckpt_ver = self.store.cold.latest_version()
        self.worker.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        if not self._started:
            return
        self._started = False
        self.index.maintenance_hook = None
        self.index.deferred_compaction = False
        if self._saved_ckpt_interval is not None:
            self.store.cold.checkpoint_interval = self._saved_ckpt_interval
        if self._own_worker:
            self.worker.stop(drain=drain, timeout=timeout)
        elif drain:
            self.worker.drain(timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.worker.drain(timeout)

    # ------------------------------------------------------------------
    def tick(self) -> None:
        """Cheap cadence check the ingest loop may call after commits:
        queues a cold checkpoint once ``checkpoint_every`` versions have
        accumulated since the last one, plus an archive sweep."""
        if not self._started:
            return
        if (self.checkpoint_every > 0
                and (self.store.cold.latest_version()
                     - self._last_ckpt_ver) >= self.checkpoint_every):
            self.worker.submit(f"ckpt:{id(self.store)}",
                               self._checkpoint)
            self.worker.submit(f"arch:{id(self.store)}", self._archive)
        if (self.scrub_interval_s > 0
                and time.monotonic() - self._last_scrub
                >= self.scrub_interval_s
                and self.worker.idle()):
            # opportunistic: scrubbing is the lowest-priority job — a
            # storm's seal/compact/checkpoint backlog always wins, and
            # the persisted cursor means a starved scrub just resumes
            # when the worker quiets down
            self._last_scrub = time.monotonic()
            self.worker.submit(f"scrub:{id(self.store)}", self._scrub)

    def _on_wish(self, wish: str) -> None:
        if wish == "seal":
            self.worker.submit(f"seal:{id(self.store)}", self._seal)
        elif wish == "compact":
            self.worker.submit(f"compact:{id(self.store)}", self._compact)
        self.tick()

    # -- jobs (worker thread; same WAL-bracketed paths as inline) ------
    def _seal(self) -> None:
        self.index.seal_if_above()

    def _compact(self) -> None:
        while self.index.compact_once():
            pass

    def _checkpoint(self) -> None:
        self.store.cold.write_checkpoint()
        self._last_ckpt_ver = self.store.cold.latest_version()

    def _archive(self) -> None:
        self.store.compact_cold(min_run=self.archive_min_run)

    def _scrub(self) -> None:
        self.store.scrubber.scrub_once(budget=self.scrub_batch,
                                       pace_s=self.scrub_pace_s)

    def scrub_now(self, full: bool = True) -> dict:
        """Run a scrub synchronously on the calling thread (tests,
        drills): a full pass by default, one batch otherwise."""
        if full:
            return self.store.scrubber.scrub_full()
        return self.store.scrubber.scrub_once(budget=self.scrub_batch)


class FabricMaintenance:
    """One shared worker maintaining every shard lake of a
    ``ShardFabric`` — plus a hook to run topology changes (rebalance
    steps) on the background thread so serving never blocks on a
    migration's copy loop."""

    def __init__(self, fabric, worker: Optional[MaintenanceWorker] = None,
                 checkpoint_every: int = 8, **worker_kw):
        self.fabric = fabric
        self.worker = worker or MaintenanceWorker(**worker_kw)
        self.checkpoint_every = checkpoint_every
        self._per_shard: dict[str, StoreMaintenance] = {}
        self._started = False

    def start(self) -> "FabricMaintenance":
        self._started = True
        self.worker.start()
        for s in self.fabric.ring.shards:
            self.attach(s)
        return self

    def attach(self, shard_id: str) -> StoreMaintenance:
        sm = self._per_shard.get(shard_id)
        if sm is None:
            sm = StoreMaintenance(self.fabric.lake(shard_id).store,
                                  worker=self.worker,
                                  checkpoint_every=self.checkpoint_every)
            self._per_shard[shard_id] = sm
            if self._started:
                sm.start()
        return sm

    def tick(self) -> None:
        for sm in self._per_shard.values():
            sm.tick()

    def scrub_now(self, full: bool = True) -> dict:
        """Synchronous scrub of every attached shard (drills/tests)."""
        return {sid: sm.scrub_now(full=full)
                for sid, sm in self._per_shard.items()}

    def submit_rebalance(self, key: str, fn) -> bool:
        """Run a topology change (e.g. ``Rebalancer(fabric).split``) on
        the worker thread. The manifest-epoch protocol already makes
        every step crash-safe; running it here just keeps the copy loop
        off the serving thread."""
        return self.worker.submit(key, fn)

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.worker.drain(timeout)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        for sm in self._per_shard.values():
            sm.stop(drain=False)
        self.worker.stop(drain=drain, timeout=timeout)
