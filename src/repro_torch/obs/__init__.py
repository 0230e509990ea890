"""Fabric-wide observability (DESIGN.md §12, §15): hierarchical query
tracing (trace.py), the process-wide metrics registry (metrics.py), the
slow-query log (slowlog.py), the tenant-aware SLO engine (slo.py), the
tail-sampling flight recorder (recorder.py), kernel cost attribution
(cost.py), and the export surfaces (export.py).

Usage from any layer — no plumbing through call signatures:

    from ..obs import span, add, scan_row_reads
    with span("fused_scan"):
        ...
        scan_row_reads(rows, nq, per_query=False, source="fused")

When no trace is active every call above is a shared-singleton no-op
(no allocation, no clock read).
"""
from .cost import PEAK_HBM_GBS, annotate_costs
from .export import (ObsHttpServer, parse_prometheus_text,
                     prometheus_text, trace_from_otlp, trace_to_otlp)
from .metrics import (Counter, Gauge, HistSnapshot, Histogram,
                      MetricsRegistry, REGISTRY, geometric_bounds,
                      parse_series_key)
from .recorder import FLIGHT_RECORDER, FlightRecorder, classify_trace
from .slo import SLO_ENGINE, SLOEngine, SLOSpec, intent_matches
from .slowlog import SLOW_QUERIES, SlowQueryLog
from .trace import (NOOP_SPAN, Span, Trace, add, current_trace, enabled,
                    scan_row_reads, set_enabled, span, subtrace, trace)

__all__ = [
    "Counter", "Gauge", "HistSnapshot", "Histogram", "MetricsRegistry",
    "REGISTRY", "geometric_bounds", "parse_series_key",
    "SLOW_QUERIES", "SlowQueryLog",
    "SLO_ENGINE", "SLOEngine", "SLOSpec", "intent_matches",
    "FLIGHT_RECORDER", "FlightRecorder", "classify_trace",
    "PEAK_HBM_GBS", "annotate_costs",
    "ObsHttpServer", "parse_prometheus_text", "prometheus_text",
    "trace_from_otlp", "trace_to_otlp",
    "NOOP_SPAN", "Span", "Trace", "add", "current_trace", "enabled",
    "scan_row_reads", "set_enabled", "span", "subtrace", "trace",
]
