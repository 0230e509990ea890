"""Tenant-aware SLO engine (DESIGN.md §15).

An SLO is a declared objective for one (tenant, intent) traffic slice:
"99.9% of tenant acme's current-tier requests succeed within 25ms".
The engine turns the raw signals of the metrics layer (latency histograms, error
counts) into the judgment a production operator actually needs — *is
tenant X inside its SLO right now* — via multi-window rolling **burn
rates**:

    error_budget = 1 - target
    bad(W)       = errors(W) + requests_over_latency_threshold(W)
    burn(W)      = (bad(W) / total(W)) / error_budget

burn == 1.0 means the slice is consuming its error budget exactly as
fast as the objective allows; burn == 10 means the budget for the whole
compliance period is being eaten 10x too fast. Windowed totals come
from DELTA'D histogram snapshots (``Histogram.snapshot_at`` /
``delta`` — metrics.py): the engine keeps a short ring of immutable
bucket snapshots per tracked slice and never stores a sample.

Two windows (default 60s and 300s) back the standard multi-window
alert rule: the LONG window proves the burn is significant, the SHORT
window proves it is still happening (so alerts clear quickly after
recovery). The per-SLO state machine is::

    ok ──(burn_short >= warn_burn  or burn_long >= warn_burn)── warning
    warning ──(burn_short >= page_burn AND burn_long >= page_burn)── burning
    (any state decays back when the rates drop)

Every evaluation publishes ``slo_burn_rate{tenant,intent,window}``
gauges into the process registry and counts state transitions, so the
scrape endpoint (obs/export.py) and ``ShardFabric.health()`` both
surface the same numbers.

Feeding: finished traces self-report (trace.py calls
``SLO_ENGINE.observe_trace`` on exit when any SLO is declared — the
zero-declared fast path is one attribute test), and layers that shed
load before a trace exists (batcher admission, queued-deadline expiry)
call ``observe(..., ok=False)`` directly. ``clock`` is injectable so
tests drive synthetic traffic through real window arithmetic.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Optional

from .metrics import REGISTRY, HistSnapshot

_TOKEN = re.compile(r"[a-z0-9_]+", re.I)


def intent_matches(key: Optional[str], intent: Optional[str]) -> bool:
    """Whether an SLO/budget key ("current", "historical", "at", ...)
    covers a trace's intent string. Batcher intents are rendered bucket
    tuples like ``(TemporalIntent(mode='current', ...), None)``, so the
    match is by TOKEN — ``"at"`` must not match ``"comparative"`` the
    way a substring test would. ``key=None`` or ``"*"`` matches
    everything."""
    if key is None or key == "*":
        return True
    if intent is None:
        return False
    if key == intent:
        return True
    return key.lower() in (t.lower() for t in _TOKEN.findall(intent))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declared objective. ``latency_ms`` is the per-request latency
    threshold; ``target`` is the combined availability+latency
    objective (fraction of requests that must both succeed and land
    under the threshold). ``degraded_bad`` additionally counts
    degraded-marked responses (a gather that lost >= 1 shard,
    DESIGN.md §13) against the budget — off by default because a
    complete degraded response is correct data at reduced redundancy."""

    tenant: str
    intent: str = "*"
    latency_ms: float = 100.0
    target: float = 0.999
    windows_s: tuple[float, float] = (60.0, 300.0)
    warn_burn: float = 1.0
    page_burn: float = 4.0
    degraded_bad: bool = False

    @property
    def error_budget(self) -> float:
        return max(1.0 - float(self.target), 1e-9)

    def key(self) -> tuple[str, str]:
        return (self.tenant, self.intent)


class _Tracked:
    """Mutable per-SLO state: the snapshot ring + alert state."""

    __slots__ = ("spec", "ring", "state", "transitions", "last_burn",
                 "errors", "degraded", "last_snap_t")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        # (t, HistSnapshot, errors_cum) — enough history for the long
        # window at the engine resolution
        self.ring: list[tuple[float, HistSnapshot, float]] = []
        self.state = "ok"
        self.transitions = 0
        self.last_burn: dict[str, float] = {}
        self.errors = 0.0          # cumulative bad events NOT in the
        self.degraded = 0.0        # latency histogram (errors/rejects)
        self.last_snap_t: Optional[float] = None


class SLOEngine:
    """Process-wide burn-rate accountant. One instance (``SLO_ENGINE``)
    serves the whole fabric; tests build private ones with a fake
    clock."""

    def __init__(self, clock=time.monotonic, resolution_s: float = 1.0):
        self._clock = clock
        self.resolution_s = float(resolution_s)
        self._tracked: dict[tuple[str, str], _Tracked] = {}
        self._lock = threading.RLock()
        self.active = False        # fast-path guard read by trace exit

    # -- declaration ----------------------------------------------------
    def declare(self, tenant: str, intent: str = "*",
                latency_ms: float = 100.0, target: float = 0.999,
                windows_s: tuple[float, float] = (60.0, 300.0),
                warn_burn: float = 1.0, page_burn: float = 4.0,
                degraded_bad: bool = False) -> SLOSpec:
        """Declare (or replace) the objective for one (tenant, intent)
        slice. Re-declaring resets that slice's ring and state."""
        spec = SLOSpec(tenant=tenant, intent=intent,
                       latency_ms=float(latency_ms), target=float(target),
                       windows_s=(float(windows_s[0]), float(windows_s[1])),
                       warn_burn=float(warn_burn),
                       page_burn=float(page_burn),
                       degraded_bad=bool(degraded_bad))
        with self._lock:
            self._tracked[spec.key()] = _Tracked(spec)
            self.active = True
        return spec

    def specs(self) -> list[SLOSpec]:
        with self._lock:
            return [t.spec for t in self._tracked.values()]

    def reset(self) -> None:
        with self._lock:
            self._tracked.clear()
            self.active = False

    # -- feeding --------------------------------------------------------
    def _hist(self, spec: SLOSpec):
        return REGISTRY.histogram("slo_latency_ms", tenant=spec.tenant,
                                  intent=spec.intent)

    def _match(self, tenant: str, intent: Optional[str]) -> list[_Tracked]:
        return [t for t in self._tracked.values()
                if t.spec.tenant == tenant
                and intent_matches(t.spec.intent, intent)]

    def observe(self, tenant: str, intent: Optional[str],
                latency_ms: Optional[float], ok: bool = True,
                degraded: bool = False) -> None:
        """One request outcome for a tenant's slice. ``latency_ms=None``
        (errors shed before execution) counts as a bad event without a
        latency observation."""
        now = self._clock()
        with self._lock:
            for t in self._match(tenant, intent):
                if ok and latency_ms is not None:
                    self._hist(t.spec).observe(latency_ms)
                else:
                    t.errors += 1.0
                if degraded:
                    t.degraded += 1.0
                    if t.spec.degraded_bad and ok:
                        # count it bad exactly once: as an error-side
                        # event on top of its histogram observation
                        t.errors += 1.0
                self._maybe_snapshot(t, now)

    def observe_trace(self, tr) -> None:
        """Feed one finished trace (called from the trace layer's exit
        when ``active``): tenant comes from the trace attrs, outcome
        from the root status + degraded marker."""
        attrs = getattr(tr, "attrs", None) or {}
        tenant = attrs.get("tenant")
        if not tenant:
            return
        ok = getattr(tr.root, "status", "ok") == "ok"
        self.observe(tenant, tr.intent, tr.wall_ms if ok else None,
                     ok=ok, degraded=bool(attrs.get("degraded")))

    def _maybe_snapshot(self, t: _Tracked, now: float) -> None:
        """Roll the snapshot ring at the engine resolution (caller holds
        the lock). The ring is bounded by the long window + slack."""
        if (t.last_snap_t is not None
                and now - t.last_snap_t < self.resolution_s):
            return
        t.last_snap_t = now
        t.ring.append((now, self._hist(t.spec).snapshot_at(), t.errors))
        horizon = now - max(t.spec.windows_s) - 2 * self.resolution_s
        while len(t.ring) > 2 and t.ring[1][0] <= horizon:
            t.ring.pop(0)

    # -- evaluation -----------------------------------------------------
    def _window_burn(self, t: _Tracked, window_s: float,
                     now: float) -> float:
        """Burn rate over the trailing window: bad fraction of the
        delta'd traffic over the error budget. No traffic => burn 0."""
        cutoff = now - window_s
        base: Optional[tuple[float, HistSnapshot, float]] = None
        for entry in reversed(t.ring):
            if entry[0] <= cutoff:
                base = entry
                break
        # no snapshot old enough: the whole recorded history is inside
        # the window (cold start) — burn against everything seen
        prev_snap = base[1] if base is not None else None
        prev_err = base[2] if base is not None else 0.0
        d = self._hist(t.spec).delta(prev_snap)
        errs = max(0.0, t.errors - prev_err)
        total = d.count + errs
        if total <= 0:
            return 0.0
        bad = errs + (d.count - d.count_le(t.spec.latency_ms))
        return (bad / total) / t.spec.error_budget

    def burn_rates(self, tenant: str, intent: str = "*") -> dict:
        """Current burn per window for one declared slice (evaluates
        and publishes gauges as a side effect)."""
        with self._lock:
            t = self._tracked.get((tenant, intent))
            if t is None:
                raise KeyError(f"no SLO declared for ({tenant!r}, "
                               f"{intent!r})")
            return self._evaluate(t)

    def _evaluate(self, t: _Tracked) -> dict:
        now = self._clock()
        self._maybe_snapshot(t, now)
        spec = t.spec
        burns = {}
        for w in spec.windows_s:
            label = f"{int(w)}s"
            b = self._window_burn(t, w, now)
            burns[label] = b
            REGISTRY.gauge("slo_burn_rate", tenant=spec.tenant,
                           intent=spec.intent, window=label).set(b)
        short, long_ = (burns[f"{int(w)}s"] for w in spec.windows_s)
        if short >= spec.page_burn and long_ >= spec.page_burn:
            state = "burning"
        elif short >= spec.warn_burn or long_ >= spec.warn_burn:
            state = "warning"
        else:
            state = "ok"
        if state != t.state:
            t.transitions += 1
            REGISTRY.counter("slo_state_changes", tenant=spec.tenant,
                             intent=spec.intent).inc()
        t.state = state
        t.last_burn = burns
        hist = self._hist(spec)
        return {
            "tenant": spec.tenant, "intent": spec.intent,
            "latency_ms": spec.latency_ms, "target": spec.target,
            "state": state, "burn": burns,
            "windows_s": list(spec.windows_s),
            "requests": hist.count + int(t.errors),
            "errors": int(t.errors), "degraded": int(t.degraded),
            "transitions": t.transitions,
        }

    def summary(self) -> dict:
        """Evaluate every declared SLO — the ``health()`` payload and
        the ``/slo`` scrape body."""
        with self._lock:
            slos = [self._evaluate(t) for t in self._tracked.values()]
        worst = "ok"
        for s in slos:
            if s["state"] == "burning":
                worst = "burning"
                break
            if s["state"] == "warning":
                worst = "warning"
        return {"declared": len(slos), "worst_state": worst,
                "slos": slos}


SLO_ENGINE = SLOEngine()
