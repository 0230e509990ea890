"""Slow-query log (DESIGN.md §12): traces that blow the SLO budget are
retained — FULL span trees, not just a latency number — in a bounded
ring buffer, so "why was that query slow" is answerable after the fact
without re-running anything. The overall slowest trace is tracked
separately (even when it stayed under budget), which is what the
examples print at exit.

Budgets are PER-INTENT (DESIGN.md §15): temporal queries legitimately
run ~10x current-tier queries, so one global 100ms budget made the
slowlog all temporal noise. ``intent_budgets`` maps an intent key
("current", "at", "window", "maintenance", ...) to its own budget_ms;
keys match trace intents by TOKEN (obs/slo.py ``intent_matches`` — the
batcher's intents are rendered bucket tuples) and the global
``budget_ms`` stays the fallback. Background maintenance jobs default
to a deliberately high budget so compactions don't evict real serving
outliers from the ring.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

# compaction/checkpoint jobs are MINUTES-scale by design; without their
# own budget every one of them would land in the slow-query ring
_DEFAULT_INTENT_BUDGETS = {"maintenance": 10_000.0}


class SlowQueryLog:
    """Thread-safe: concurrent serving threads finish traces
    simultaneously, so observe/configure/summary hold a lock
    (DESIGN.md §13)."""

    def __init__(self, budget_ms: float = 100.0, capacity: int = 32,
                 intent_budgets: Optional[dict] = None):
        self.budget_ms = float(budget_ms)
        self.intent_budgets = dict(_DEFAULT_INTENT_BUDGETS
                                   if intent_budgets is None
                                   else intent_budgets)
        self._ring: deque = deque(maxlen=int(capacity))
        self.slowest = None          # slowest finished Trace ever seen
        self.observed = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def configure(self, budget_ms: Optional[float] = None,
                  capacity: Optional[int] = None,
                  intent_budgets: Optional[dict] = None) -> None:
        """Adjust the SLO budget and/or ring size (keeps the newest
        retained traces when shrinking). ``intent_budgets`` MERGES into
        the per-intent table (a key mapped to None removes it)."""
        with self._lock:
            if budget_ms is not None:
                self.budget_ms = float(budget_ms)
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=int(capacity))
            if intent_budgets is not None:
                for k, v in intent_budgets.items():
                    if v is None:
                        self.intent_budgets.pop(k, None)
                    else:
                        self.intent_budgets[k] = float(v)

    def budget_for(self, intent: Optional[str]) -> float:
        """The budget that applies to one trace's intent: the first
        token-matching per-intent entry (sorted keys, so the lookup is
        deterministic when several match), else the global default."""
        from .slo import intent_matches
        with self._lock:
            for key in sorted(self.intent_budgets):
                if intent_matches(key, intent):
                    return self.intent_budgets[key]
            return self.budget_ms

    def observe(self, tr) -> None:
        """Called by the trace layer for EVERY finished trace."""
        budget = self.budget_for(tr.intent)
        with self._lock:
            self.observed += 1
            if self.slowest is None or tr.wall_ms > self.slowest.wall_ms:
                self.slowest = tr
            if tr.wall_ms > budget:
                self._ring.append(tr)

    def traces(self) -> list:
        """Retained over-budget traces, oldest first."""
        with self._lock:
            return list(self._ring)

    def summary(self) -> dict:
        with self._lock:
            return {
                "budget_ms": self.budget_ms,
                "intent_budgets": dict(self.intent_budgets),
                "capacity": self._ring.maxlen,
                "observed": self.observed,
                "over_budget_retained": len(self._ring),
                "slowest_ms": (round(self.slowest.wall_ms, 3)
                               if self.slowest else None),
                "recent": [{"name": t.name, "intent": t.intent,
                            "wall_ms": round(t.wall_ms, 3)}
                           for t in list(self._ring)[-5:]],
            }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.slowest = None
            self.observed = 0
            self.intent_budgets = dict(_DEFAULT_INTENT_BUDGETS)


SLOW_QUERIES = SlowQueryLog()
