"""Export surfaces for the observability stack (DESIGN.md §15).

Three interchange formats, all stdlib-only:

**Prometheus text exposition** (``prometheus_text``): the whole metrics
registry in the standard ``# TYPE`` + sample-line format — counters and
gauges verbatim, histograms as cumulative ``_bucket{le=}`` series plus
``_sum``/``_count``. ``parse_prometheus_text`` inverts it losslessly
(values round-trip through ``repr``), which is what the round-trip
tests and the golden-file CI check lean on.

**OTLP-shaped JSON spans** (``trace_to_otlp`` / ``trace_from_otlp``):
a serialized trace tree as an OpenTelemetry ``resourceSpans`` document.
A span that carries its Unix-ns start and end (``start_unix_ns`` /
``end_unix_ns``, which ``Trace.to_dict()`` writes from the root's clock
offset) exports at those times; a serialized span without them gets
synthetic times, packed deterministically — a span starts where its
previous sibling ended (the root at t=0). Span/trace ids are md5 digests
of the tree path, so the same trace always exports byte-identically.
Counters become int/double attributes; the parent-id links carry the
tree, and ``trace_from_otlp`` rebuilds the exact nested dict.

**Pull endpoint** (``ObsHttpServer``): a ThreadingHTTPServer serving
``/metrics`` (Prometheus text), ``/slo`` (SLO engine summary JSON),
``/traces`` (flight-recorder summary + retained records), and
``/health`` (optional callback) on an ephemeral port — enough for
``benchmarks/load_slo.py`` to scrape itself mid-storm the way a real
Prometheus would.

``python -m repro_torch.obs.export --write-golden/--check-golden <dir>``
renders a fixed fixture registry + trace to both formats for the CI
golden-file check (bench-smoke has no pytest; the same goldens back
tests/test_export.py).
"""
from __future__ import annotations

import hashlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .cost import annotate_costs
from .metrics import REGISTRY, MetricsRegistry, _series_key, \
    parse_series_key

# ---------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------

_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _esc(v: str) -> str:
    return "".join(_LABEL_ESC.get(ch, ch) for ch in str(v))


def _fmt_labels(labels: dict, extra: Optional[list] = None) -> str:
    pairs = [(k, labels[k]) for k in sorted(labels)] + (extra or [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in pairs) + "}"


def _fmt_val(v: float) -> str:
    # repr round-trips floats exactly; integers render bare
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The whole registry in Prometheus text exposition format."""
    registry = REGISTRY if registry is None else registry
    counters, gauges, hists = registry.export_state()
    lines: list[str] = []
    typed: set[str] = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, c in counters:
        name, labels = parse_series_key(key)
        _type(name, "counter")
        lines.append(f"{name}{_fmt_labels(labels)} {_fmt_val(c.value)}")
    for key, g in gauges:
        name, labels = parse_series_key(key)
        _type(name, "gauge")
        lines.append(f"{name}{_fmt_labels(labels)} {_fmt_val(g.value)}")
    for key, h in hists:
        name, labels = parse_series_key(key)
        _type(name, "histogram")
        snap = h.snapshot_at()
        cum = 0
        for i, bound in enumerate(snap.bounds):
            cum += snap.counts[i]
            lines.append(f"{name}_bucket"
                         f"{_fmt_labels(labels, [('le', repr(bound))])}"
                         f" {cum}")
        lines.append(f"{name}_bucket{_fmt_labels(labels, [('le', '+Inf')])}"
                     f" {snap.count}")
        lines.append(f"{name}_sum{_fmt_labels(labels)}"
                     f" {_fmt_val(snap.sum)}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {snap.count}")
    return "\n".join(lines) + "\n"


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                     r'(?:\{(.*)\})?\s+(\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unesc(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"') \
            .replace("\\\\", "\\")


def parse_prometheus_text(text: str) -> dict:
    """Invert ``prometheus_text``: returns ``{"counters": {key: v},
    "gauges": {key: v}, "histograms": {key: {"count", "sum",
    "buckets": {le: cumulative}}}}`` with the same series keys the
    registry uses."""
    types: dict[str, str] = {}
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        name, inner, val = m.group(1), m.group(2) or "", m.group(3)
        labels = {k: _unesc(v) for k, v in _LABEL.findall(inner)}
        value = float(val) if val != "+Inf" else float("inf")
        base, field = name, None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[: -len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                base, field = cand, suffix[1:]
                break
        kind = types.get(base)
        if kind == "histogram":
            le = labels.pop("le", None)
            key = _series_key(base, labels)
            h = out["histograms"].setdefault(
                key, {"count": 0, "sum": 0.0, "buckets": {}})
            if field == "bucket":
                h["buckets"][le] = value
            elif field == "sum":
                h["sum"] = value
            elif field == "count":
                h["count"] = int(value)
        elif kind == "gauge":
            out["gauges"][_series_key(name, labels)] = value
        else:
            out["counters"][_series_key(name, labels)] = value
    return out


# ---------------------------------------------------------------------
# OTLP-shaped JSON span export
# ---------------------------------------------------------------------

def _otlp_value(v):
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}       # OTLP JSON encodes i64 as str
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _from_otlp_value(d):
    if "intValue" in d:
        return int(d["intValue"])
    if "doubleValue" in d:
        return float(d["doubleValue"])
    if "boolValue" in d:
        return bool(d["boolValue"])
    return d.get("stringValue")


def _span_id(trace_id: str, path: tuple) -> str:
    return hashlib.md5(f"{trace_id}/{'/'.join(map(str, path))}"
                       .encode()).hexdigest()[:16]


def trace_to_otlp(trace_dict: dict,
                  service: str = "livevectorlake") -> dict:
    """One serialized trace (``Trace.to_dict()`` shape) as an OTLP JSON
    document. Ids are md5 digests of the tree path; a span's times are
    its own Unix-ns start and end where it carries them, else packed
    synthetically (siblings laid end to end from t=0), so the export is
    deterministic — same trace, same bytes."""
    trace_id = hashlib.md5(
        json.dumps(trace_dict, sort_keys=True).encode()).hexdigest()
    spans: list[dict] = []

    def _walk(sd: dict, path: tuple, parent: Optional[str],
              start_ns: int) -> int:
        if "start_unix_ns" in sd:
            start_ns, end_ns = sd["start_unix_ns"], sd["end_unix_ns"]
        else:
            end_ns = start_ns + int(round(sd.get("wall_ms", 0.0) * 1e6))
        attrs = [{"key": k, "value": _otlp_value(v)}
                 for k, v in (sd.get("counters") or {}).items()]
        status = sd.get("status", "ok")
        otlp_span = {
            "traceId": trace_id,
            "spanId": _span_id(trace_id, path),
            "name": sd["name"],
            "kind": "SPAN_KIND_INTERNAL",
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": attrs,
            "status": ({"code": "STATUS_CODE_OK"} if status == "ok"
                       else {"code": "STATUS_CODE_ERROR",
                             "message": status}),
        }
        if parent is not None:
            otlp_span["parentSpanId"] = parent
        spans.append(otlp_span)
        child_start = start_ns
        for i, child in enumerate(sd.get("children", ())):
            child_start = _walk(child, path + (i,),
                                otlp_span["spanId"], child_start)
        return end_ns

    root = trace_dict.get("spans") or {"name": trace_dict.get("name", "?")}
    _walk(root, (0,), None, 0)
    # trace-level fields ride on the ROOT span as trace.* attributes
    root_attrs = spans[0]["attributes"]
    if "start_unix_ns" in root:         # the times are real: say so
        root_attrs.append({"key": "trace.clock",
                           "value": _otlp_value("unix")})
    if trace_dict.get("intent") is not None:
        root_attrs.append({"key": "trace.intent",
                           "value": _otlp_value(trace_dict["intent"])})
    for k, v in (trace_dict.get("attrs") or {}).items():
        root_attrs.append({"key": f"trace.{k}", "value": _otlp_value(v)})
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": service}}]},
        "scopeSpans": [{"scope": {"name": "repro.obs"}, "spans": spans}],
    }]}


def trace_from_otlp(otlp: dict) -> dict:
    """Invert ``trace_to_otlp`` back to the ``Trace.to_dict()`` shape
    (span tree, counters, statuses, trace attrs)."""
    spans: list[dict] = []
    for rs in otlp.get("resourceSpans", ()):
        for ss in rs.get("scopeSpans", ()):
            spans.extend(ss.get("spans", ()))
    by_id: dict[str, dict] = {}
    roots: list[dict] = []
    order = {s["spanId"]: i for i, s in enumerate(spans)}
    unix = any(a["key"] == "trace.clock" for s in spans
               for a in s.get("attributes", ()))
    for s in spans:
        t0, t1 = int(s["startTimeUnixNano"]), int(s["endTimeUnixNano"])
        node: dict = {"name": s["name"], "wall_ms": round((t1 - t0) / 1e6, 3)}
        if unix:
            node["start_unix_ns"], node["end_unix_ns"] = t0, t1
        status = s.get("status", {})
        if status.get("code") == "STATUS_CODE_ERROR":
            node["status"] = status.get("message", "error")
        counters = {}
        trace_attrs = {}
        intent = None
        for a in s.get("attributes", ()):
            key, val = a["key"], _from_otlp_value(a["value"])
            if key == "trace.intent":
                intent = val
            elif key == "trace.clock":
                continue
            elif key.startswith("trace."):
                trace_attrs[key[len("trace."):]] = val
            else:
                counters[key] = val
        if counters:
            node["counters"] = counters
        node["_meta"] = (trace_attrs, intent)
        by_id[s["spanId"]] = node
    for s in spans:
        node = by_id[s["spanId"]]
        parent = s.get("parentSpanId")
        if parent and parent in by_id:
            by_id[parent].setdefault("children", []).append(
                (order[s["spanId"]], node))
        else:
            roots.append(node)

    def _finish(node: dict) -> dict:
        node.pop("_meta", None)
        if "children" in node:
            node["children"] = [c for _, c in sorted(
                node["children"], key=lambda p: p[0])]
            for c in node["children"]:
                _finish(c)
        return node

    root = roots[0]
    trace_attrs, intent = root["_meta"]
    out = {"name": root["name"], "intent": intent,
           "wall_ms": root["wall_ms"], "spans": _finish(root)}
    if trace_attrs:
        out["attrs"] = trace_attrs
    return out


# ---------------------------------------------------------------------
# Pull endpoint
# ---------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def log_message(self, *args):      # keep benches/tests quiet
        pass

    def _send(self, body: str, ctype: str, code: int = 200) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(prometheus_text(), "text/plain; version=0.0.4")
            elif path == "/slo":
                from .slo import SLO_ENGINE
                self._send(json.dumps(SLO_ENGINE.summary(), indent=1),
                           "application/json")
            elif path == "/traces":
                from .recorder import FLIGHT_RECORDER
                body = {"summary": FLIGHT_RECORDER.summary(),
                        "records": FLIGHT_RECORDER.records()}
                self._send(json.dumps(body, indent=1), "application/json")
            elif path == "/health":
                fn = getattr(self.server, "health_fn", None)
                body = fn() if fn else {"ok": True}
                self._send(json.dumps(body, indent=1, default=str),
                           "application/json")
            else:
                self._send('{"error": "not found"}', "application/json",
                           404)
        except Exception as e:         # scrape must never kill serving
            self._send(json.dumps({"error": repr(e)}),
                       "application/json", 500)


class ObsHttpServer:
    """The stdlib pull endpoint: ``/metrics`` ``/slo`` ``/traces``
    ``/health`` on an ephemeral localhost port. ``health_fn`` (e.g.
    ``fabric.health``) backs ``/health``."""

    def __init__(self, port: int = 0, health_fn=None):
        self._requested_port = int(port)
        self.health_fn = health_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObsHttpServer":
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", self._requested_port), _Handler)
        self._httpd.health_fn = self.health_fn
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-http", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def url(self, path: str = "/metrics") -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------
# Golden fixture + CLI (CI bench-smoke runs this without pytest)
# ---------------------------------------------------------------------

def golden_fixture() -> tuple[str, str]:
    """A fixed registry + trace rendered to both formats — the golden
    files lock the exposition format AND the cost-attribution math."""
    reg = MetricsRegistry()
    reg.counter("scan_row_reads", source="fused").inc(4096)
    reg.counter("scan_row_reads", tenant="acme").inc(4096)
    reg.counter("scan_bytes_streamed", tenant="acme").inc(262144)
    reg.gauge("slo_burn_rate", tenant="acme", intent="current",
              window="60s").set(0.5)
    h = reg.histogram("trace_ms", bounds=[1.0, 10.0, 100.0],
                      trace="batch")
    for v in (0.5, 2.0, 5.0, 50.0, 500.0):
        h.observe(v)
    prom = prometheus_text(reg)

    trace_dict = {
        "name": "batch", "intent": "current", "wall_ms": 12.5,
        "attrs": {"tenant": "acme"},
        "spans": {
            "name": "batch", "wall_ms": 12.5,
            "counters": {"queue_wait_ms": 1.5, "batch_size": 8},
            "children": [{
                "name": "plan", "wall_ms": 10.0,
                "children": [{
                    "name": "shard:s00", "wall_ms": 9.0,
                    "children": [{
                        "name": "kernel:topk_search_q8", "wall_ms": 8.0,
                        "counters": {"rows": 65536,
                                     "bytes_streamed": 8388608},
                    }],
                }],
            }],
        },
    }
    annotate_costs(trace_dict)
    otlp = json.dumps(trace_to_otlp(trace_dict), indent=1,
                      sort_keys=True) + "\n"
    return prom, otlp


GOLDEN_FILES = ("export_metrics.prom", "export_trace_otlp.json")


def main(argv=None) -> int:
    import argparse
    import os
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--write-golden", metavar="DIR")
    p.add_argument("--check-golden", metavar="DIR")
    args = p.parse_args(argv)
    prom, otlp = golden_fixture()
    rendered = dict(zip(GOLDEN_FILES, (prom, otlp)))
    if args.write_golden:
        os.makedirs(args.write_golden, exist_ok=True)
        for fname, body in rendered.items():
            with open(os.path.join(args.write_golden, fname), "w") as f:
                f.write(body)
            print(f"wrote {fname}")
        return 0
    if args.check_golden:
        rc = 0
        for fname, body in rendered.items():
            path = os.path.join(args.check_golden, fname)
            try:
                with open(path) as f:
                    want = f.read()
            except FileNotFoundError:
                print(f"MISSING golden {path}")
                rc = 1
                continue
            if want != body:
                print(f"GOLDEN MISMATCH {fname} — export format drifted; "
                      f"regenerate with --write-golden if intentional")
                rc = 1
            else:
                print(f"ok {fname}")
        return rc
    print(prom)
    print(otlp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
