"""Flight recorder: tail-sampled retention of finished traces
(DESIGN.md §15).

The slowlog answers "show me over-budget traces"; the recorder answers
the harder post-incident question — "show me the exact span trees from
around the failure, including the REPRESENTATIVE ok traffic" — the way
an aircraft black box does: a bounded ring that is always recording,
cheap enough to leave on, and dumped automatically the moment something
goes wrong.

Retention is TAIL-BASED, decided after the trace completes when its
outcome is known:

  always kept (``interesting``): error traces, deadline-exceeded,
    degraded gathers (a shard missing from the reply), admission
    rejections (synthesized events — no trace ever existed), and
    anything over its intent's latency budget (slowlog.budget_for)
  probabilistically kept (``sampled``): everything else, at
    ``sample_rate`` with a seeded RNG (drills replay deterministically)

The two classes live in separate rings under one capacity; eviction
ALWAYS takes the oldest sampled-ok record before touching any
interesting record — the invariant tests assert: an error trace is
never evicted while a sampled-ok trace remains.

Retained traces are stored SERIALIZED (plain dicts via
``Trace.to_dict()``) and cost-annotated (obs/cost.py) at retention
time, so holding a record never pins live index state and a dumped
trace self-explains as bandwidth/dispatch/queue-bound.

Autodump: ``enable()`` registers a listener on the fault registry
(testing/faults.py); every injected fault triggers an immediate
``dump()`` (the black-box artifact exists even if the process dies
next) plus a follow-up dump after the next completed trace, which by
then contains the erroring span tree itself.

Fast path: ``enabled`` is a plain attribute the trace layer tests
before calling in — recorder off costs one attribute load per finished
trace and NOTHING on the per-span path.
"""
from __future__ import annotations

import json
import os
import random
import threading
from collections import deque
from typing import Optional

from .cost import annotate_costs
from .slowlog import SLOW_QUERIES

INTERESTING_KINDS = ("error", "deadline", "degraded",
                     "admission_rejected", "over_budget")


def classify_trace(tr) -> Optional[str]:
    """Why a finished trace is interesting, or None for plain-ok."""
    status = getattr(tr.root, "status", "ok")
    if status != "ok":
        if "DeadlineExceeded" in status:
            return "deadline"
        return "error"
    if (getattr(tr, "attrs", None) or {}).get("degraded"):
        return "degraded"
    if tr.wall_ms > SLOW_QUERIES.budget_for(tr.intent):
        return "over_budget"
    return None


class FlightRecorder:
    """Bounded tail-sampling ring of completed serialized traces."""

    def __init__(self, capacity: int = 64, sample_rate: float = 0.05,
                 seed: int = 0):
        self.enabled = False          # fast-path guard (trace exit)
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self.dump_dir: Optional[str] = None
        self._rng = random.Random(seed)
        self._keep: deque = deque()     # interesting — evicted LAST
        self._sampled: deque = deque()  # plain-ok sample — evicted first
        self._lock = threading.Lock()
        self._seq = 0
        self._dump_due: Optional[str] = None
        self.dropped = 0              # sampled-out (never retained)
        self.evicted = {"sampled": 0, "interesting": 0}
        self.dumps: list[str] = []    # paths written by dump()
        self.dump_reasons: list[str] = []   # every dump(), file or not
        self.last_dump: list = []     # header + records of last dump()
        self._listening = False

    # -- lifecycle ------------------------------------------------------
    def enable(self, capacity: Optional[int] = None,
               sample_rate: Optional[float] = None,
               dump_dir: Optional[str] = None, seed: int = 0) -> None:
        """Turn the recorder on and hook the fault registry so every
        injected failure leaves a JSONL artifact (when ``dump_dir`` is
        set; without one, dumps stay in-memory on ``last_dump``)."""
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            if sample_rate is not None:
                self.sample_rate = float(sample_rate)
            if dump_dir is not None:
                self.dump_dir = dump_dir
            self._rng = random.Random(seed)
            self.enabled = True
        if not self._listening:
            from ..testing.faults import FAULTS
            FAULTS.add_listener(self._on_fault)
            self._listening = True

    def disable(self) -> None:
        self.enabled = False
        if self._listening:
            from ..testing.faults import FAULTS
            FAULTS.remove_listener(self._on_fault)
            self._listening = False

    def reset(self) -> None:
        with self._lock:
            self._keep.clear()
            self._sampled.clear()
            self._seq = 0
            self._dump_due = None
            self.dropped = 0
            self.evicted = {"sampled": 0, "interesting": 0}
            self.dumps = []
            self.dump_reasons = []
            self.last_dump = []

    # -- feeding --------------------------------------------------------
    def observe_trace(self, tr) -> None:
        """Called by the trace layer for every finished root trace
        (guarded by ``enabled``)."""
        if not self.enabled:
            return
        reason = classify_trace(tr)
        due = None
        with self._lock:
            if reason is None and self._rng.random() >= self.sample_rate:
                self.dropped += 1
                due = self._dump_due      # still honor a pending dump
                self._dump_due = None
            else:
                self._seq += 1
                rec = annotate_costs(tr.to_dict())
                rec["seq"] = self._seq
                rec["kind"] = "trace"
                rec["reason"] = reason or "sampled"
                (self._keep if reason else self._sampled).append(rec)
                self._evict_locked()
                due = self._dump_due
                self._dump_due = None
        if due:
            self.dump(reason=due)

    def observe_event(self, event: str, **attrs) -> None:
        """Synthesized interesting record for failures that never get a
        trace (admission rejections happen before dispatch)."""
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "kind": "event", "name": event,
                   "reason": event, "attrs": attrs}
            self._keep.append(rec)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._keep) + len(self._sampled) > self.capacity:
            # the retention invariant: sampled-ok records always go
            # before ANY interesting record
            if self._sampled:
                self._sampled.popleft()
                self.evicted["sampled"] += 1
            else:
                self._keep.popleft()
                self.evicted["interesting"] += 1

    # -- reading --------------------------------------------------------
    def records(self) -> list[dict]:
        """Everything currently retained, in completion order."""
        with self._lock:
            out = list(self._keep) + list(self._sampled)
        return sorted(out, key=lambda r: r["seq"])

    def summary(self) -> dict:
        with self._lock:
            by_reason: dict[str, int] = {}
            for r in list(self._keep) + list(self._sampled):
                by_reason[r["reason"]] = by_reason.get(r["reason"], 0) + 1
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "sample_rate": self.sample_rate,
                    "retained": len(self._keep) + len(self._sampled),
                    "interesting": len(self._keep),
                    "sampled": len(self._sampled),
                    "by_reason": by_reason, "observed": self._seq,
                    "dropped": self.dropped,
                    "evicted": dict(self.evicted),
                    "dumps": list(self.dumps),
                    "dump_reasons": list(self.dump_reasons)}

    # -- dumping --------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> list[dict]:
        """Snapshot the retained records; write them as JSONL when a
        path (or ``dump_dir``) is configured. Returns the records and
        keeps them on ``last_dump`` either way."""
        recs = self.records()
        header = {"kind": "dump", "reason": reason, "retained": len(recs)}
        self.last_dump = [header] + recs
        self.dump_reasons.append(reason)
        if path is None and self.dump_dir is not None:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"flight-{len(self.dumps):04d}.jsonl")
        if path is not None:
            with open(path, "w") as f:
                for rec in self.last_dump:
                    f.write(json.dumps(rec) + "\n")
            self.dumps.append(path)
        return recs

    def _on_fault(self, point: str) -> None:
        """Fault-registry listener: immediate black-box dump, plus a
        follow-up after the next completed trace (which will contain
        the erroring span tree)."""
        if not self.enabled:
            return
        self.dump(reason=f"fault:{point}")
        with self._lock:
            self._dump_due = f"fault:{point}:post"


FLIGHT_RECORDER = FlightRecorder()
