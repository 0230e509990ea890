"""Hierarchical query tracing (DESIGN.md §12).

One serving request = one ``Trace``: a tree of ``Span`` records carried
through the stack by a contextvar — the batcher opens the trace, and
every layer underneath (planner scatter, per-shard engine pass, index
scan, kernel dispatch) attaches nested spans WITHOUT any plumbing
through call signatures. A span records its start and end on
``time.perf_counter_ns()`` (``wall_ms`` is their difference) plus a small
dict of numeric counters (rows_scanned, bytes_streamed, segments_pruned,
candidates, rescore_pool, ...). Each root (a trace or a subtrace) also
keeps ``clock_offset_ns``, one paired reading of ``time.time_ns() -
time.perf_counter_ns()`` taken when it opens: adding it to a span's
``start_ns``/``end_ns`` puts the span on the Unix clock, the clock of
``torch.profiler``'s events.

The no-op fast path is the design center: when no trace is active (or
tracing is globally disabled), ``span()``/``add()`` return a shared
singleton / return immediately — no allocation, no clock read.

Span taxonomy (stable names — DESIGN.md §12 documents the contract):

  batch                     batcher dispatch (trace root)
    submit                  a request's admission and bucketing
    plan                    scatter-gather planner pass
      shard:<id>            one shard's engine pass
        store:query_batch   store-level batched query
          classify          intent parsing and grouping
          embed             query embedding
          intent:<mode>     one temporal-intent group
            fused_scan      memtable + small-segment fused dispatch
            solo_scan / ivf_scan:<seg>   per-segment scans
              ivf_gemm      the host int8 GEMM of an IVF member scan
              rescore       exact fp32 rescore of a quantized pool
            fused_temporal  resident full-history temporal dispatch
            kernel:<name>   one device kernel dispatch (device_ms)
            results         SearchResult materialisation
      merge                 cross-shard candidate merge
    gc                      a garbage collection inside the trace

``kernel_span`` opens a ``kernel:<name>`` span in a kernel's wrapper,
and ``with sp.launch():`` marks each library call in it that launches
kernels. On a CUDA device each such block records a start and an end
``torch.cuda.Event`` on the current stream, and nothing synchronizes;
the root trace sums the span's pairs into its ``device_ms`` counter when
it closes, after the batch's answers are on the host. On an idle stream
a pair also holds the host's time to enqueue the launch (the library
call's own host code, and the profiler's callbacks where one runs), so
``device_ms`` bounds the span's kernel time from above.

Counters are pure numbers; ``Span.total(name)`` folds a counter over a
subtree (e.g. a shard span's total rows_scanned).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from contextvars import ContextVar
from typing import Any, Optional

_ACTIVE: ContextVar[Optional["Trace"]] = ContextVar("obs_trace",
                                                    default=None)
_ENABLED = True
_GC_HOOKED = False
_GC_OPEN: list = []          # the open gc span's (trace, span)
_EVENTS = False              # a kernel span has recorded CUDA events


def set_enabled(on: bool) -> None:
    """Global kill switch: when off, ``trace()`` itself becomes a no-op
    (spans are already no-ops whenever no trace is active) and the gc
    callback is taken off ``gc.callbacks``; the next trace opened while
    on puts it back."""
    global _ENABLED
    _ENABLED = bool(on)
    if not _ENABLED:
        _unhook_gc()


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a ``gc`` span around each collection that
    runs while a trace is active in the collecting thread."""
    if phase == "start":
        tr = _ACTIVE.get()
        if tr is None or not _ENABLED:
            return
        sp = Span("gc", counters={"generation": info["generation"]})
        tr.stack[-1].children.append(sp)
        tr.stack.append(sp)
        _GC_OPEN.append((tr, sp))
        sp.start_ns = time.perf_counter_ns()
    elif _GC_OPEN:
        tr, sp = _GC_OPEN.pop()
        sp.end_ns = time.perf_counter_ns()
        sp.wall_ms = (sp.end_ns - sp.start_ns) / 1e6
        sp.counters["collected"] = info["collected"]
        if tr.stack[-1] is sp:
            tr.stack.pop()
        elif sp in tr.stack:
            tr.stack.remove(sp)


def _hook_gc() -> None:
    global _GC_HOOKED
    if not _GC_HOOKED:
        gc.callbacks.append(_on_gc)
        _GC_HOOKED = True


def _unhook_gc() -> None:
    global _GC_HOOKED
    if _GC_HOOKED:
        gc.callbacks.remove(_on_gc)
        _GC_HOOKED = False


def enabled() -> bool:
    return _ENABLED


@dataclasses.dataclass
class Span:
    name: str
    wall_ms: float = 0.0
    status: str = "ok"                     # "error:<ExcType>" on raise
    counters: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)
    start_ns: int = 0                      # time.perf_counter_ns()
    end_ns: int = 0
    # roots only: time.time_ns() - time.perf_counter_ns() at opening
    clock_offset_ns: Optional[int] = None
    # kernel spans on CUDA until the root resolves them: their launches
    events: Any = dataclasses.field(default=None, repr=False,
                                    compare=False)

    def add(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def launch(self):
        """A block of a kernel span that launches kernels: timed by a pair
        of CUDA events on a traced CUDA kernel span, else nothing."""
        return NOOP_SPAN if self.events is None else self.events

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

    def to_dict(self, offset_ns: Optional[int] = None) -> dict:
        """The subtree as plain data. With a clock offset (a root passes
        its own down) each span carries its Unix-ns start and end."""
        if offset_ns is None:
            offset_ns = self.clock_offset_ns
        d = {"name": self.name, "wall_ms": round(self.wall_ms, 3)}
        if offset_ns is not None and self.end_ns:
            d["start_unix_ns"] = self.start_ns + offset_ns
            d["end_unix_ns"] = self.end_ns + offset_ns
        if self.status != "ok":
            d["status"] = self.status
        if self.counters:
            d["counters"] = dict(self.counters)
        if self.children:
            d["children"] = [c.to_dict(offset_ns) for c in self.children]
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

    def launch(self):
        return self


NOOP_SPAN = _NoopSpan()


class _SpanCtx:
    __slots__ = ("tr", "name", "span")

    def __init__(self, tr: Trace, name: str):
        self.tr = tr
        self.name = name

    def __enter__(self) -> Span:
        sp = Span(self.name)
        self.tr.stack[-1].children.append(sp)
        self.tr.stack.append(sp)
        self.span = sp
        sp.start_ns = time.perf_counter_ns()
        return sp

    def __exit__(self, etype, exc, tb):
        sp = self.span
        sp.end_ns = time.perf_counter_ns()
        sp.wall_ms = (sp.end_ns - sp.start_ns) / 1e6
        if etype is not None:
            sp.status = f"error:{etype.__name__}"
        self.tr.stack.pop()
        return False


class _Launches:
    """The launches of a kernel span on a CUDA device: as a context
    manager, one launch, between a start and an end timing event on the
    stream; ``pairs`` keeps every launch's two events."""

    __slots__ = ("stream", "pairs", "start")

    def __init__(self, stream):
        self.stream = stream
        self.pairs: list = []

    def __enter__(self):
        import torch

        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, etype, exc, tb):
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        self.pairs.append((self.start, end))
        return False


class _KernelSpanCtx(_SpanCtx):
    """A kernel span on a CUDA device: its launches (``Span.launch``)
    are timed on the current stream; no synchronization."""

    __slots__ = ("device",)

    def __init__(self, tr: Trace, name: str, device):
        super().__init__(tr, name)
        self.device = device

    def __enter__(self) -> Span:
        global _EVENTS
        import torch

        sp = super().__enter__()
        sp.events = _Launches(torch.cuda.current_stream(self.device))
        _EVENTS = True
        return sp


def _resolve_events(root: Span) -> None:
    """Sum every kernel span's launch pairs under ``root`` into its
    ``device_ms``, waiting for the end events the device has not yet
    reached (none, once the batch's answers are on the host)."""
    stack = [root]
    while stack:
        sp = stack.pop()
        if sp.events is not None:
            pairs = sp.events.pairs
            sp.events = None
            try:
                if pairs:
                    pairs[-1][1].synchronize()
                    sp.counters["device_ms"] = sum(
                        ev0.elapsed_time(ev1) for ev0, ev1 in pairs)
            except RuntimeError:            # a failed launch: no reading
                pass
        stack.extend(sp.children)


def _open_root(tr: Trace) -> None:
    """The root's start and its one paired clock reading."""
    unix = time.time_ns()
    t = time.perf_counter_ns()
    tr.root.start_ns = t
    tr.root.clock_offset_ns = unix - t


def _close_root(tr: Trace, etype) -> None:
    root = tr.root
    root.end_ns = time.perf_counter_ns()
    tr.wall_ms = root.wall_ms = (root.end_ns - root.start_ns) / 1e6
    if etype is not None:
        root.status = f"error:{etype.__name__}"


class _TraceCtx:
    __slots__ = ("name", "intent", "attrs", "tr", "token")

    def __init__(self, name: str, intent: Optional[str],
                 attrs: Optional[dict] = None):
        self.name = name
        self.intent = intent
        self.attrs = attrs

    def __enter__(self) -> Span:
        self.tr = Trace(self.name, self.intent, attrs=self.attrs)
        self.token = _ACTIVE.set(self.tr)
        _open_root(self.tr)
        return self.tr.root

    def __exit__(self, etype, exc, tb):
        tr = self.tr
        _close_root(tr, etype)
        _ACTIVE.reset(self.token)
        if _EVENTS:
            _resolve_events(tr.root)
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

    __slots__ = ("name", "tr", "token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        self.tr = Trace(self.name)
        self.token = _ACTIVE.set(self.tr)
        _open_root(self.tr)
        return self.tr.root

    def __exit__(self, etype, exc, tb):
        # kernel events stay pending: the trace this root is grafted into
        # resolves them when it closes
        _close_root(self.tr, etype)
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
    if not _GC_HOOKED:
        _hook_gc()
    return _TraceCtx(name, intent, attrs=attrs or None)


def span(name: str):
    """A nested span under the active trace; the shared no-op when no
    trace is active (zero allocation, no clock read)."""
    tr = _ACTIVE.get()
    if tr is None or not _ENABLED:
        return NOOP_SPAN
    return _SpanCtx(tr, name)


def kernel_span(name: str, device):
    """The span of a kernel's dispatch (``kernel:<name>``). Traced on a
    CUDA ``device``: the span's host time is that of enqueueing, and each
    ``with sp.launch():`` block in it is timed by a pair of events on the
    current stream, summed into its ``device_ms`` when the root trace
    closes; nothing waits for the device. On the CPU it is
    ``span(name)``; untraced, the shared no-op."""
    tr = _ACTIVE.get()
    if tr is None or not _ENABLED:
        return NOOP_SPAN
    if getattr(device, "type", None) == "cuda":
        return _KernelSpanCtx(tr, name, device)
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
