"""Hierarchical query tracing (DESIGN.md §12).

One serving request = one ``Trace``: a tree of ``Span`` records carried
through the stack by a contextvar — the batcher opens the trace, and
every layer underneath (planner scatter, per-shard engine pass, index
scan, kernel dispatch) attaches nested spans WITHOUT any plumbing
through call signatures. A span records wall time plus a small dict of
numeric counters (rows_scanned, bytes_streamed, segments_pruned,
candidates, rescore_pool, ...).

The no-op fast path is the design center: when no trace is active (or
tracing is globally disabled), ``span()``/``add()`` return a shared
singleton / return immediately — no allocation, no clock read.

Span taxonomy (stable names — DESIGN.md §12 documents the contract):

  batch                     batcher dispatch (trace root)
    plan                    scatter-gather planner pass
      shard:<id>            one shard's engine pass
        store:query_batch   store-level batched query
          embed             query embedding
          intent:<mode>     one temporal-intent group
            fused_scan      memtable + small-segment fused dispatch
            solo_scan / ivf_scan:<seg>   per-segment scans
            fused_temporal  resident full-history temporal dispatch
            kernel:<name>   one device/host kernel dispatch
      merge                 cross-shard candidate merge

Counters are pure numbers; ``Span.total(name)`` folds a counter over a
subtree (e.g. a shard span's total rows_scanned).
"""
from __future__ import annotations

import dataclasses
import time
from contextvars import ContextVar
from typing import Optional

_ACTIVE: ContextVar[Optional["Trace"]] = ContextVar("obs_trace",
                                                    default=None)
_ENABLED = True


def set_enabled(on: bool) -> None:
    """Global kill switch: when off, ``trace()`` itself becomes a no-op
    (spans are already no-ops whenever no trace is active)."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


@dataclasses.dataclass
class Span:
    name: str
    wall_ms: float = 0.0
    status: str = "ok"                     # "error:<ExcType>" on raise
    counters: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    def add(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def total(self, name: str) -> float:
        """Fold one counter over this span's subtree."""
        return (self.counters.get(name, 0)
                + sum(c.total(name) for c in self.children))

    def find(self, name: str) -> list["Span"]:
        """Every span in the subtree whose name matches exactly."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def find_prefix(self, prefix: str) -> list["Span"]:
        out = [self] if self.name.startswith(prefix) else []
        for c in self.children:
            out.extend(c.find_prefix(prefix))
        return out

    def to_dict(self) -> dict:
        d = {"name": self.name, "wall_ms": round(self.wall_ms, 3)}
        if self.status != "ok":
            d["status"] = self.status
        if self.counters:
            d["counters"] = dict(self.counters)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def render(self, indent: int = 0) -> str:
        parts = [f"{'  ' * indent}{self.name} ({self.wall_ms:.2f}ms)"]
        if self.status != "ok":
            parts.append(f"!{self.status}")
        parts += [f"{k}={v}" for k, v in self.counters.items()]
        lines = [" ".join(parts)]
        lines += [c.render(indent + 1) for c in self.children]
        return "\n".join(lines)


class Trace:
    """One request's span tree. The stack tracks the open span path; it
    is only touched by the context managers below, which pop in
    ``__exit__`` so an exception anywhere unwinds it correctly."""

    __slots__ = ("name", "intent", "attrs", "root", "stack", "wall_ms")

    def __init__(self, name: str, intent: Optional[str] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.intent = intent
        self.attrs = attrs or {}       # e.g. tenant= (DESIGN.md §14)
        self.root = Span(name)
        self.stack = [self.root]
        self.wall_ms = 0.0

    def to_dict(self) -> dict:
        d = {"name": self.name, "intent": self.intent,
             "wall_ms": round(self.wall_ms, 3),
             "spans": self.root.to_dict()}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def render(self) -> str:
        head = f"trace {self.name}"
        if self.intent:
            head += f" [{self.intent}]"
        for k, v in self.attrs.items():
            head += f" {k}={v}"
        return head + "\n" + self.root.render(indent=1)


class _NoopSpan:
    """Shared do-nothing span: returned whenever no trace is active so
    the instrumented hot paths allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, name, value):
        return None

    def total(self, name):
        return 0


NOOP_SPAN = _NoopSpan()


class _SpanCtx:
    __slots__ = ("tr", "name", "span", "t0")

    def __init__(self, tr: Trace, name: str):
        self.tr = tr
        self.name = name

    def __enter__(self) -> Span:
        sp = Span(self.name)
        self.tr.stack[-1].children.append(sp)
        self.tr.stack.append(sp)
        self.span = sp
        self.t0 = time.perf_counter()
        return sp

    def __exit__(self, etype, exc, tb):
        sp = self.span
        sp.wall_ms = (time.perf_counter() - self.t0) * 1e3
        if etype is not None:
            sp.status = f"error:{etype.__name__}"
        self.tr.stack.pop()
        return False


class _TraceCtx:
    __slots__ = ("name", "intent", "attrs", "tr", "token", "t0")

    def __init__(self, name: str, intent: Optional[str],
                 attrs: Optional[dict] = None):
        self.name = name
        self.intent = intent
        self.attrs = attrs

    def __enter__(self) -> Span:
        self.tr = Trace(self.name, self.intent, attrs=self.attrs)
        self.token = _ACTIVE.set(self.tr)
        self.t0 = time.perf_counter()
        return self.tr.root

    def __exit__(self, etype, exc, tb):
        tr = self.tr
        tr.wall_ms = tr.root.wall_ms = \
            (time.perf_counter() - self.t0) * 1e3
        if etype is not None:
            tr.root.status = f"error:{etype.__name__}"
        _ACTIVE.reset(self.token)
        # registry + slow-query log get every finished trace; the SLO
        # engine and flight recorder (DESIGN.md §15) only when switched
        # on — their guards are plain attribute loads so a store with no
        # declared SLO pays nothing beyond them
        from .metrics import REGISTRY
        from .recorder import FLIGHT_RECORDER
        from .slo import SLO_ENGINE
        from .slowlog import SLOW_QUERIES
        REGISTRY.histogram("trace_ms", trace=tr.name).observe(tr.wall_ms)
        SLOW_QUERIES.observe(tr)
        if SLO_ENGINE.active:
            SLO_ENGINE.observe_trace(tr)
        if FLIGHT_RECORDER.enabled:
            FLIGHT_RECORDER.observe_trace(tr)
        return False


class _SubtraceCtx:
    """A detached trace for a worker thread: sets the thread's
    contextvar so every ``span()``/``add()`` underneath attaches here,
    but does NOT feed the registry/slow-query log — the dispatching
    thread grafts the finished subtree into its own trace."""

    __slots__ = ("name", "tr", "token", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        self.tr = Trace(self.name)
        self.token = _ACTIVE.set(self.tr)
        self.t0 = time.perf_counter()
        return self.tr.root

    def __exit__(self, etype, exc, tb):
        tr = self.tr
        tr.wall_ms = tr.root.wall_ms = \
            (time.perf_counter() - self.t0) * 1e3
        if etype is not None:
            tr.root.status = f"error:{etype.__name__}"
        _ACTIVE.reset(self.token)
        return False


def subtrace(name: str):
    """Open a detached span tree in a worker thread (context manager
    yielding the root span). Contextvars do not propagate into
    ``ThreadPoolExecutor`` workers, so a parallel scatter opens one
    subtrace per shard and grafts the finished roots into the parent
    trace's span. Disabled => shared no-op."""
    if not _ENABLED:
        return NOOP_SPAN
    return _SubtraceCtx(name)


def current_trace() -> Optional[Trace]:
    return _ACTIVE.get()


def trace(name: str, intent: Optional[str] = None, **attrs):
    """Open a root trace (context manager yielding the root span). A
    nested ``trace()`` call while one is already active degrades to a
    plain span, so layers can defensively open traces without
    fragmenting the tree. Extra keyword args become trace ATTRIBUTES
    (e.g. ``tenant=``) carried on the finished trace's dict/render —
    dropped when degrading to a span. Disabled => shared no-op."""
    if not _ENABLED:
        return NOOP_SPAN
    tr = _ACTIVE.get()
    if tr is not None:
        return _SpanCtx(tr, name)
    return _TraceCtx(name, intent, attrs=attrs or None)


def span(name: str):
    """A nested span under the active trace; the shared no-op when no
    trace is active (zero allocation, no clock read)."""
    tr = _ACTIVE.get()
    if tr is None or not _ENABLED:
        return NOOP_SPAN
    return _SpanCtx(tr, name)


def add(name: str, value) -> None:
    """Add to the CURRENT span's counter; no-op without a trace."""
    tr = _ACTIVE.get()
    if tr is None:
        return
    sp = tr.stack[-1]
    sp.counters[name] = sp.counters.get(name, 0) + value


def scan_row_reads(rows: int, nq: int, per_query: bool,
                   source: str = "scan", row_bytes: int = 0) -> int:
    """THE scan-accounting convention, centralized (asserted by the
    scan-accounting tests): a FUSED/exact block reads each row once
    per BATCH (that is what the fused dispatch buys), so it contributes
    its row count once; per-query sources (IVF member gathers)
    contribute their per-query average times nq. Every scan source must
    report through this helper so new sources cannot silently diverge.

    Returns the row-read increment (callers fold it into their own
    accounting); also lands on the current span's ``rows_scanned`` and
    the process-wide ``scan_row_reads{source=...}`` counter.

    Per-tenant resource metering (DESIGN.md §15): when the active trace
    carries a ``tenant`` attribute, the same reads (and, with
    ``row_bytes`` — the per-row footprint the scan actually streamed —
    the bytes) are additionally billed to
    ``scan_row_reads{tenant=...}`` / ``scan_bytes_streamed{tenant=...}``
    so a tenant's scan footprint is answerable without trace archaeology."""
    reads = int(rows) * int(nq) if per_query else int(rows)
    add("rows_scanned", reads)
    from .metrics import REGISTRY
    REGISTRY.counter("scan_row_reads", source=source).inc(reads)
    tr = _ACTIVE.get()
    if tr is not None:
        tenant = tr.attrs.get("tenant")
        if tenant:
            REGISTRY.counter("scan_row_reads", tenant=tenant).inc(reads)
            if row_bytes:
                REGISTRY.counter("scan_bytes_streamed",
                                 tenant=tenant).inc(reads * int(row_bytes))
    return reads
