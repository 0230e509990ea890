"""The port's spans on a shared clock (src/repro_torch/obs/trace.py):
start and end on ``time.perf_counter_ns()`` with one Unix offset a root,
so a span lands on ``torch.profiler``'s timeline; kernel spans timed by
CUDA events and never by a stream sync; the ``gc`` span only under an
enabled trace; the host GEMM of an IVF scan named ``ivf_gemm``; the
batch's host spans (``classify``, ``results``, ``rescore``, ``submit``);
the cost verdict and the OTLP export reading the new fields. All on the
CPU; the card's half is in ``lakebench/test_hostspans.py``."""
import gc
import importlib
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.obs.cost import annotate_costs
from repro_torch.obs.export import trace_from_otlp, trace_to_otlp

obs_trace = importlib.import_module("repro_torch.obs.trace")
MS = 1_000_000


@pytest.fixture(autouse=True)
def _enabled():
    obs.set_enabled(True)
    yield
    obs.set_enabled(True)


def _all(span):
    yield span
    for c in span.children:
        yield from _all(c)


def test_spans_nest_on_the_clock_and_the_root_offset_gives_unix_ns():
    u0 = time.time_ns()
    with obs.trace("batch") as root:
        with obs.span("outer"):
            time.sleep(0.002)
            with obs.span("inner"):
                time.sleep(0.001)
    u1 = time.time_ns()
    outer = root.children[0]
    inner = outer.children[0]
    assert root.start_ns <= outer.start_ns <= inner.start_ns
    assert inner.start_ns < inner.end_ns <= outer.end_ns <= root.end_ns
    for sp in (root, outer, inner):
        assert sp.wall_ms == (sp.end_ns - sp.start_ns) / 1e6
    assert inner.wall_ms >= 1.0 and outer.wall_ms >= 3.0
    # only the root carries the offset
    off = root.clock_offset_ns
    assert off is not None
    assert outer.clock_offset_ns is None and inner.clock_offset_ns is None
    assert u0 - MS <= root.start_ns + off <= root.end_ns + off <= u1 + MS
    assert obs.current_trace() is None
    tree = root.to_dict()
    inner_d = tree["children"][0]["children"][0]
    assert inner_d["start_unix_ns"] == inner.start_ns + off
    assert inner_d["end_unix_ns"] == inner.end_ns + off


def test_a_subtrace_root_takes_its_own_offset():
    with obs.subtrace("shard:s0") as sroot:
        with obs.span("scan"):
            pass
    assert sroot.clock_offset_ns is not None
    assert sroot.start_ns <= sroot.children[0].start_ns
    assert abs(sroot.clock_offset_ns
               - (time.time_ns() - time.perf_counter_ns())) < MS


def test_a_profiler_event_inside_a_span_lands_inside_it_on_unix_time():
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace("batch") as root:
            with obs.span("probe_span") as sp:
                with record_function("probe_fn"):
                    for _ in range(20):
                        x = torch.tanh(x @ x.T / 256)
    off = root.clock_offset_ns
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "probe_fn"]
    assert len(evs) == 1
    ev = evs[0]
    lo, hi = sp.start_ns + off, sp.end_ns + off
    assert lo - MS <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() \
        <= hi + MS


class _Event:
    """A stand-in for torch.cuda.Event that counts what is asked of it."""
    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.cuda_event = id(self)

    def record(self, stream=None):
        self.t = time.perf_counter_ns()
        _Event.log.append("record")

    def synchronize(self):
        _Event.log.append("event_sync")

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


class _Stream:
    def synchronize(self):
        raise AssertionError("a kernel span synced the stream")


def test_kernel_span_on_cuda_records_events_and_resolves_at_root_close(
        monkeypatch):
    """With the card's API stubbed: a start and an end event around each
    launch of the span (``sp.launch()``), none for the span's other host
    work, no stream or device sync, and ``device_ms``, the launches'
    sum, only once the root closes."""
    _Event.log = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        _Stream())

    def no_sync(*a, **k):
        raise AssertionError("a kernel span synced the device")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    dev = torch.device("cuda:0")
    with obs.trace("batch") as root:
        with obs.span("fused_temporal"):
            with obs.kernel_span("kernel:temporal_window_topk", dev) as sp:
                sp.add("rows", 10)
                assert _Event.log == []
                for _ in range(2):              # two query chunks
                    with sp.launch():
                        time.sleep(0.001)
                    time.sleep(0.005)           # a merge: not timed
            assert _Event.log == ["record"] * 4
            assert "device_ms" not in sp.counters and sp.events is not None
    assert sp.events is None
    assert 2.0 <= sp.counters["device_ms"] < 10.0
    assert _Event.log == ["record"] * 4 + ["event_sync"]
    assert root.total("device_ms") == sp.counters["device_ms"]


def test_kernel_span_on_the_cpu_records_no_event_and_never_syncs(
        monkeypatch):
    from repro_torch.kernels.temporal_mask_score.ops import (
        temporal_window_topk)
    from repro_torch.kernels.topk_search.ops import topk_search

    def boom(*a, **k):
        raise AssertionError("the CPU path touched the card's API")
    for name in ("Event", "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 16, generator=g)
    c = torch.randn(64, 16, generator=g)
    vf = torch.zeros(64, dtype=torch.int64)
    vt = torch.full((64,), 10, dtype=torch.int64)
    with obs.trace("batch") as root:
        topk_search(q, c, torch.ones(64, dtype=torch.bool), 5)
        temporal_window_topk(q, c, vf, vt, np.full(4, 3), np.full(4, 4), 5)
    kern = root.find_prefix("kernel:")
    assert [sp.name for sp in kern] == ["kernel:topk_search",
                                        "kernel:temporal_window_topk"]
    for sp in kern:
        assert sp.events is None and "device_ms" not in sp.counters
        assert sp.counters["rows"] == 64 and sp.end_ns > sp.start_ns
    # untraced: the shared no-op, whatever the device
    assert obs.kernel_span("kernel:x", torch.device("cuda:0")) \
        is obs.NOOP_SPAN


def test_untraced_spans_allocate_nothing():
    dev = torch.device("cpu")

    def probe(n):
        for _ in range(n):
            with obs.span("results") as sp:
                sp.add("rows", 1)
            with obs.kernel_span("kernel:topk_search", dev) as sp:
                sp.add("rows", 1)
                with sp.launch():
                    pass
            obs.add("rows", 1)

    probe(100)                               # warm any lazy state
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    probe(10_000)
    grown = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown < 512, f"no-op path allocated {grown} bytes"


def test_the_gc_span_appears_only_under_an_enabled_trace():
    obs.set_enabled(False)
    assert obs_trace._on_gc not in gc.callbacks
    with obs.trace("batch") as off:
        gc.collect()
    assert off is obs.NOOP_SPAN
    obs.set_enabled(True)
    gc.collect()                             # no trace: nothing to hold it
    with obs.trace("batch") as root:
        assert obs_trace._on_gc in gc.callbacks
        with obs.span("results"):
            gc.collect()
    spans = root.find("gc")
    assert len(spans) == 1 and spans[0] in root.children[0].children
    sp = spans[0]
    assert sp.counters["generation"] == 2 and "collected" in sp.counters
    assert sp.end_ns >= sp.start_ns and sp.wall_ms >= 0
    assert obs.current_trace() is None
    obs.set_enabled(False)
    assert obs_trace._on_gc not in gc.callbacks


def test_ivf_gemm_replaces_asym_scores_host():
    from repro_torch.kernels.qscan import asym_scores_host

    rng = np.random.default_rng(0)
    qs = rng.standard_normal((3, 16)).astype(np.float32)
    c8 = rng.integers(-127, 128, (50, 16)).astype(np.int8)
    with obs.trace("batch") as root:
        asym_scores_host(qs, c8)
    names = {sp.name for sp in _all(root)}
    assert "ivf_gemm" in names
    assert not any(n.startswith("kernel:") for n in names)


def _lake(tmp_path, quantized):
    from repro_torch.core.store import LiveVectorLake
    from repro_torch.data.corpus import generate_corpus

    corpus = generate_corpus(n_docs=12, n_versions=2)
    lake = LiveVectorLake(str(tmp_path / "lake"), dim=32, device="cpu",
                          quantized=quantized)
    for v, ts in enumerate(corpus.timestamps):
        for doc in corpus.doc_ids():
            lake.ingest(doc, corpus.versions[v][doc], ts=ts)
    return lake, corpus


@pytest.mark.parametrize("quantized", [False, True])
def test_a_batch_names_its_host_work(tmp_path, quantized):
    lake, corpus = _lake(tmp_path, quantized)
    texts = ["security policy review", "network capacity incident"]
    with obs.trace("batch") as cur:
        lake.query_batch(texts, k=3)
    with obs.trace("batch") as asof:
        lake.query_batch(texts, k=3, at=corpus.timestamps[0])
    for root in (cur, asof):
        q = root.find("store:query_batch")[0]
        assert [c.name for c in q.children[:2]] == ["classify", "embed"]
        assert root.find("results")
    # point-in-time: the engine's SearchResults and the leakage check
    assert len(asof.find("results")) == 2
    assert bool(cur.find("rescore")) == quantized


def test_a_closed_loop_submit_lands_in_the_batch_that_answered():
    from repro_torch.serve.batcher import intent_batcher

    b = None

    def query_batch(texts, k, at, window, visibility):
        if len(texts) == 2:
            b.submit("the next question")
        return [[] for _ in texts]

    b = intent_batcher(query_batch, k=3, max_batch=2)
    b.submit("first question")               # no trace: no span
    b.submit("second question")
    roots = []
    orig = b.run_batch

    def keep(payloads):
        roots.append(obs.current_trace().root)
        return orig(payloads)
    b.run_batch = keep
    b.drain()
    assert len(roots) == 2
    assert [len(r.find("submit")) for r in roots] == [1, 0]


def test_cost_reads_device_ms_where_a_kernel_span_has_it():
    def kern(wall, dev=None):
        c = {"bytes_streamed": 3_350_000}
        if dev is not None:
            c["device_ms"] = dev
        return {"name": "kernel:topk_search", "wall_ms": wall, "counters": c}

    d = {"name": "batch", "wall_ms": 10.0,
         "spans": {"name": "batch", "wall_ms": 10.0,
                   "children": [kern(0.05, 1.0), kern(2.0)]}}
    annotate_costs(d)
    timed, host = d["spans"]["children"]
    # 3.35 MB in 1 ms of device time is 3.35 GB/s: 0.1% of the roofline
    assert timed["counters"]["achieved_gbs"] == pytest.approx(3.35)
    assert host["counters"]["achieved_gbs"] == pytest.approx(1.675)
    assert d["cost"]["kernel_ms"] == pytest.approx(3.0)


def test_otlp_writes_real_times_and_reads_them_back():
    with obs.trace("batch", intent="current") as root:
        with obs.span("classify"):
            pass
        with obs.span("embed"):
            time.sleep(0.001)
    d = {"name": "batch", "intent": "current",
         "wall_ms": round(root.wall_ms, 3),
         "spans": root.to_dict()}
    otlp = trace_to_otlp(d)
    spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    off = root.clock_offset_ns
    by_name = {s["name"]: s for s in spans}
    emb = root.children[1]
    assert int(by_name["embed"]["startTimeUnixNano"]) == emb.start_ns + off
    assert int(by_name["embed"]["endTimeUnixNano"]) == emb.end_ns + off
    assert trace_from_otlp(otlp) == d
    # a serialized span without times keeps the synthetic layout
    bare = {"name": "batch", "intent": None, "wall_ms": 2.0,
            "spans": {"name": "batch", "wall_ms": 2.0,
                      "children": [{"name": "a", "wall_ms": 1.0},
                                   {"name": "b", "wall_ms": 0.5}]}}
    s2 = trace_to_otlp(bare)["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [(s["startTimeUnixNano"], s["endTimeUnixNano"]) for s in s2] == \
        [("0", "2000000"), ("0", "1000000"), ("1000000", "1500000")]
    assert trace_from_otlp(trace_to_otlp(bare)) == bare
