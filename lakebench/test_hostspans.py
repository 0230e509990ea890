"""Tests of ``lakebench/hostspans.py``: the idle attribution on spans and
device ops made by hand, with every share worked out by hand (CPU), and,
on the card (``cuda`` marker), the shared clock itself: in traced
windows of each cell, each in a process of its own, 4 s long and as long
as the benchmark's, the kernel spans contain their kernels' starts as
the profiler reads them (all but 1%, at 4 s), ``hostspans`` moves no
device op by a millisecond (at 4 s; at the benchmark's length the run's
line reports the move), and each span's ``device_ms`` holds its
kernel's time."""
from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

from lakebench import devtrace, hostspans, run
from lakebench.devtrace import DeviceOp

MS = 1_000_000                  # ns
BASE = 5_000 * MS               # the spans' perf_counter_ns origin
OFF = 1_700_000_000 * 10**9     # the roots' Unix offset


@dataclasses.dataclass
class S:
    """The fields of a span that the attribution and the readers read."""
    name: str
    start_ns: int
    end_ns: int
    children: list = dataclasses.field(default_factory=list)
    clock_offset_ns: int | None = None

    @property
    def wall_ms(self) -> float:
        return (self.end_ns - self.start_ns) / MS

    def find(self, name: str) -> list:
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out


def sp(name, a, b, *children):
    return S(name, BASE + a * MS, BASE + b * MS, list(children))


def op(a, b):
    """A device op from a to b ms after BASE, on the profiler's clock."""
    return DeviceOp("k", (BASE + OFF + a * MS) / 1e3,
                    (BASE + OFF + b * MS) / 1e3)


def hand_run():
    """Batch A [0, 100] ms and batch B [120, 150] ms; the card busy over
    [35, 55] and [140, 160]; the window [0, 200]; the loop stamps A's
    answers at 92 ms and B's at 148 ms."""
    a = sp("batch", 0, 100,
           sp("classify", 10, 20),
           sp("fused_temporal", 20, 60, sp("kernel:x", 30, 32)),
           sp("results", 60, 80, sp("gc", 70, 75)),
           sp("ivf_scan:00000007", 80, 90))
    b = sp("batch", 120, 150, sp("ivf_scan:00000012", 125, 145))
    for root in (a, b):
        root.clock_offset_ns = OFF
    s = BASE / 1e9
    return SimpleNamespace(
        traces=[a, b, b],            # a hedged batch hands its root twice
        device_ops=[op(35, 55), op(140, 160)], trace_window_s=0.2,
        window=(s, s + 0.15),
        loop=SimpleNamespace(batches=[[s, s + 0.092, 32, None],
                                      [s + 0.12, s + 0.148, 32, None]]))


def test_fold_takes_segment_and_shard_ids_off():
    assert hostspans.fold("ivf_scan:00000007") == "ivf_scan:*"
    assert hostspans.fold("solo_scan:12") == "solo_scan:*"
    assert hostspans.fold("shard:s00") == "shard:*"
    for name in ("intent:historical", "kernel:topk_search_q8", "batch",
                 "results"):
        assert hostspans.fold(name) == name


def test_idle_time_goes_to_the_deepest_open_span():
    att = hostspans.attribute(hand_run())
    got = {k: pytest.approx(v * 1e3, abs=1e-3)
           for k, v in att["by_label"].items()}
    # idle [0, 35]: root alone 10, classify 10, fused_temporal 10 + 3
    # around kernel:x 2; [55, 140]: fused_temporal 5, results 10 + 5
    # around gc 5, ivf 10, root alone 2, the harness 8 (after the 92 ms
    # stamp), no trace 20, B alone 5, ivf 15; [160, 200]: no trace 40
    assert {"unattributed": 77.0, "classify": 10.0,
            "fused_temporal": 18.0, "kernel:x": 2.0, "results": 15.0,
            "gc": 5.0, "ivf_scan:*": 25.0} == got
    assert att["harness_s"] * 1e3 == pytest.approx(8.0, abs=1e-3)
    assert att["unattributed_s"] * 1e3 == pytest.approx(85.0, abs=1e-3)
    assert att["idle_s"] * 1e3 == pytest.approx(160.0, abs=1e-3)
    assert sum(att["by_label"].values()) + att["harness_s"] == \
        pytest.approx(att["idle_s"], abs=1e-6)


def test_the_reader_gives_the_unattributed_share(capsys):
    from lakebench.layer_metrics import idle_unattributed_pct

    assert idle_unattributed_pct.read(hand_run()) == \
        pytest.approx(100 * 85 / 160, abs=1e-3)
    err = capsys.readouterr().err
    assert "harness's 0.008000 s" in err
    lines = [ln for ln in err.splitlines() if ln.startswith("hostspans: ")]
    assert lines[1].split()[-1] == "unattributed"     # the largest first


def test_idle_outside_every_trace_and_a_card_never_busy():
    r = hand_run()
    r.device_ops = [op(500, 501)]            # after the window
    att = hostspans.attribute(r)
    assert att["idle_s"] * 1e3 == pytest.approx(200.0, abs=1e-3)
    # no trace 70 ms ([100, 120], [150, 200]), the roots alone 20 (A's
    # [0, 10], [90, 92]; B's [120, 125], [145, 148]), the harness's 10
    assert att["unattributed_s"] * 1e3 == pytest.approx(100.0, abs=1e-3)
    assert att["harness_s"] * 1e3 == pytest.approx(10.0, abs=1e-3)


def test_a_device_clock_running_ahead_is_moved_back():
    """The card's kernel (``counts/temporal_window_topk``) seems to start
    at 27 ms, 3 ms before the span that launched it: the device ops move
    3 ms later, and the attribution is that of ops read at 30 ms."""
    kernel = "void topk_list_kernel<float, 2, WindowMask>"

    def run_with(first, second):
        r = hand_run()
        r.traces[0].children[1].children[0].name = \
            "kernel:temporal_window_topk"
        k = op(*first)
        r.device_ops = [DeviceOp(kernel, k.start_us, k.end_us), op(*second)]
        return r

    assert hostspans.attribute(run_with((35, 55), (140, 160)))["lead_ns"] \
        == 0.0
    got = hostspans.attribute(run_with((27, 47), (132, 152)))
    assert got["lead_ns"] == pytest.approx(3 * MS, abs=1e3)
    assert (got["early"], got["paired"]) == (1, 1)
    want = hostspans.attribute(run_with((30, 50), (135, 155)))
    assert want["lead_ns"] == 0.0
    assert got["by_label"].keys() == want["by_label"].keys()
    for label, sec in want["by_label"].items():
        assert got["by_label"][label] == pytest.approx(sec, abs=1e-6)


def test_the_clock_readers_give_the_early_share_and_the_lead():
    """Two paired kernels (``counts/temporal_window_topk``): the one of
    batch A read 3 ms before its span, the one of batch B 3 ms after:
    half the pairs early, by 3 ms at most. A window with no pair gives
    neither metric."""
    from lakebench.layer_metrics import clock_early_pct, clock_lead_ms

    kernel = "void topk_list_kernel<float, 2, WindowMask>"
    r = hand_run()
    r.traces[0].children[1].children[0].name = "kernel:temporal_window_topk"
    r.traces[1].children[0].children.append(
        sp("kernel:temporal_window_topk", 130, 131))
    r.device_ops = [DeviceOp(kernel, op(27, 28).start_us, op(27, 28).end_us),
                    DeviceOp(kernel, op(133, 134).start_us,
                             op(133, 134).end_us)]
    assert hostspans.clock_reading(r)[:2] == (1, 2)
    assert clock_early_pct.read(r) == pytest.approx(50.0)
    assert clock_lead_ms.read(r) == pytest.approx(3.0, abs=1e-3)
    r.device_ops[0] = DeviceOp(kernel, op(31, 32).start_us,
                               op(31, 32).end_us)
    assert (clock_early_pct.read(r), clock_lead_ms.read(r)) == (0.0, 0.0)
    bare = hand_run()
    assert clock_early_pct.read(bare) is None
    assert clock_lead_ms.read(bare) is None


def test_a_device_clock_running_ahead_by_a_changing_amount():
    """Five batches 100 ms apart, each kernel starting with its span. The
    card's clock reads each instant t as t - 5 ms + 1% of the time since
    the first kernel, up to the last one's start (ahead by 5, 4, 3, 2, 1
    ms at the kernels): each kernel moves back into its span, the ops
    between them by the interpolated shift, and the attribution is the
    one of a true clock."""
    kernel = "void topk_list_kernel<float, 2, WindowMask>"
    starts = (0, 100, 200, 300, 400)

    def batch(b):
        return sp("batch", b, b + 80,
                  sp("fused_temporal", b + 10, b + 60,
                     sp("kernel:temporal_window_topk", b + 20, b + 22)),
                  sp("results", b + 60, b + 75))

    def run_with(clock):
        roots = [batch(b) for b in starts]
        for root in roots:
            root.clock_offset_ns = OFF
        t0, t1 = BASE + OFF + 20 * MS, BASE + OFF + 420 * MS
        ops = []
        for b in starts:
            for a, e, name in ((b + 20, b + 40, kernel), (b + 62, b + 63,
                                                          "copy")):
                if b == starts[-1] and name == "copy":
                    continue
                a, e = (clock(BASE + OFF + t * MS, t0, t1) for t in (a, e))
                ops.append(DeviceOp(name, a / 1e3, e / 1e3))
        s = BASE / 1e9
        return SimpleNamespace(
            traces=roots, device_ops=ops, trace_window_s=0.5,
            window=(s, s + 0.5),
            loop=SimpleNamespace(batches=[[s + b / 1e3, s + (b + 78) / 1e3,
                                           32, None] for b in starts]))

    want = hostspans.attribute(run_with(lambda t, t0, t1: t))
    got = hostspans.attribute(run_with(
        lambda t, t0, t1: t - 5 * MS + 0.01 * (min(t, t1) - t0)))
    assert (want["lead_ns"], want["early"]) == (0.0, 0)
    # µs of Unix time in a float: a quarter µs apart
    assert got["lead_ns"] == pytest.approx(5 * MS, abs=1e3)
    assert (got["early"], got["paired"]) == (5, 5)
    for label in got["by_label"].keys() | want["by_label"].keys():
        assert got["by_label"].get(label, 0.0) == \
            pytest.approx(want["by_label"].get(label, 0.0), abs=1e-5)
    # the card busy 21 ms a batch and 20 in the last, of 500 ms
    assert want["idle_s"] == pytest.approx(0.5 - 4 * 0.021 - 0.02, abs=1e-6)


def test_one_odd_pair_moves_only_its_neighbours():
    """200 kernels, each starting 1 ms after its span but one that reads
    5 ms before it: that kernel moves back to its span's start, the
    device ops between its neighbours by the interpolated shift, and
    every other op stays where the profiler put it."""
    roots, ops = [], []
    kernel = "void topk_list_kernel<float, 2, WindowMask>"
    for i in range(200):
        b = 10 * i
        roots.append(sp("batch", b, b + 8,
                        sp("kernel:temporal_window_topk", b + 2, b + 3)))
        roots[-1].clock_offset_ns = OFF
        a = b + 3 if i != 100 else b - 3
        o = op(a, a + 1)
        ops.append(DeviceOp(kernel, o.start_us, o.end_us))
    r = SimpleNamespace(traces=roots, device_ops=ops)
    shifts = hostspans.clock_shifts(r, hostspans._roots(r))
    assert [d for _, d in shifts if d] == [pytest.approx(5 * MS, abs=1e3)]
    conv = hostspans.on_span_clock(shifts)
    ns = [o.start_us * 1e3 for o in ops]
    assert conv(ns[100]) == pytest.approx(BASE + OFF + 1002 * MS, abs=1e3)
    for i in (0, 98, 102, 199):
        assert conv(ns[i]) == ns[i]
    assert conv(ns[99] + 5 * MS) > ns[99] + 5 * MS       # between: moved


def test_submit_ms_where_no_batch_submitted():
    """A clocked program's batches with no ``submit`` span held no submit
    work (0 ms); a program without the clock has no such span (None)."""
    from lakebench.layer_metrics import submit_ms

    r = hand_run()
    r.per_batch = lambda name: run.Run.per_batch(r, name)
    assert submit_ms.read(r) == 0.0
    r.traces[0].children.append(sp("submit", 95, 96))
    assert submit_ms.read(r) == pytest.approx(1.0 / 3)
    for root in r.traces:
        root.clock_offset_ns = None
    r.traces[0].children.pop()
    assert submit_ms.read(r) is None


def test_spans_without_a_clock_give_nothing():
    r = hand_run()
    for root in r.traces:
        root.clock_offset_ns = None
    assert hostspans.attribute(r) is None
    r = hand_run()
    r.device_ops = []
    assert hostspans.attribute(r) is None


# -- the card ------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profiler's device clock")
    return torch.device("cuda:0")


def traced_window(workload, kernel, parent, tmp, seconds) -> dict:
    """A ``--trace 1`` run of the cell at its full size on the card for
    ``seconds`` (None: the benchmark's ``run_seconds``), in a process of
    its own (spawned: one traced window a process, as the benchmark runs
    them). Returns, as plain data: each ``kernel:<kernel>`` span under
    ``parent`` (start, the parent's end, ``device_ms``; Unix ns), the
    profiler's matched kernels (start, end; Unix ns), the shifts
    ``hostspans`` gives the device ops, and the last line."""
    import contextlib
    import importlib
    import io
    import os

    count = importlib.import_module(f"lakebench.counts.{kernel}")
    seen = []

    class Keep(run.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen.append(self)

    run.Run = Keep
    os.environ["TMPDIR"] = tmp
    if seconds is None:
        seconds = json.loads((run.ROOT / "BENCHMARK.json").read_text())[
            "run_seconds"]
    args = run.parse(["--workload", workload, "--seed", str(2**33 + 7),
                      "--seconds", str(seconds), "--trace", "1"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.bench(args) == 0
    r = seen[0]
    roots = hostspans._roots(r)
    spans = []
    for root in roots:
        off = root.clock_offset_ns
        for par in root.find(parent):
            spans.extend((ks.start_ns + off, par.end_ns + off,
                          ks.counters.get("device_ms"))
                         for ks in par.children if ks.name == count.SPAN)
    return {"spans": sorted(spans),
            "kernels": sorted((o.start_us * 1e3, o.end_us * 1e3)
                              for o in r.device_ops
                              if count.matches(o.name)),
            "shifts": hostspans.clock_shifts(r, roots),
            "line": json.loads(out.getvalue().strip().splitlines()[-1])}


def window_reading(workload, kernel, parent, tmp, seconds=None) -> dict:
    """``traced_window`` in a spawned process, checked for what holds at
    any length: the answers correct, one kernel a span, each span's
    ``device_ms`` (its launch's event pair) holding its kernel's time as
    the profiler reads it (event timestamps resolve to about 0.5 µs), the
    run's line reporting the attribution and the profiler's reading of
    the clock (``clock_early_pct``, ``clock_lead_ms``) as ``hostspans``
    gives them. Returns the window's pairs and its largest move."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        got = pool.apply(traced_window,
                         (workload, kernel, parent, str(tmp), seconds))
    spans, kern, line = got["spans"], got["kernels"], got["line"]
    assert line["correct"] is True, line["checks"]
    assert spans and len(spans) == len(kern), (len(spans), len(kern))
    pairs = [(s, e, k) for (s, e, _), (k, _) in zip(spans, kern)]
    lead = max((d for _, d in got["shifts"]), default=0.0)
    dev_ms = [d for _, _, d in spans]
    prof_ms = [(e - k) / 1e6 for k, e in kern]
    intent = workload.split(".")[1]
    metrics = {name: v["value"] for name, v in line["metrics"].items()}
    print(json.dumps({
        "workload": workload, "pairs": len(pairs),
        "inside": sum(1 for s, e, k in pairs if s <= k <= e),
        "early_us": max(0.0, max((s - k) / 1e3 for s, _, k in pairs)),
        "late_us": max(0.0, max((k - e) / 1e3 for _, e, k in pairs)),
        "lead_us": lead / 1e3, "device_ms": sum(d or 0 for d in dev_ms),
        "profiler_ms": sum(prof_ms),
        **{m: metrics.get(f"{m}.{intent}") for m in (
            "clock_early_pct", "clock_lead_ms", "idle_unattributed_pct")}}))
    assert all(d is not None for d in dev_ms)
    assert all(d >= p - 1e-3 for d, p in zip(dev_ms, prof_ms))
    assert {f"idle_unattributed_pct.{intent}",
            f"submit_ms.{intent}"} <= set(metrics)
    assert metrics[f"clock_lead_ms.{intent}"] == pytest.approx(lead / 1e6)
    assert metrics[f"clock_early_pct.{intent}"] == pytest.approx(
        100 * sum(1 for _, d in got["shifts"] if d > 0) / len(pairs))
    return {"pairs": pairs, "lead": lead}


CELLS = pytest.mark.parametrize("workload,kernel,parent", [
    ("pg19_v5.asof", "temporal_window_topk", "fused_temporal"),
    ("pg19_v5_q8.current", "topk_search_q8", "fused_scan")])


@pytest.mark.cuda
@CELLS
def test_kernel_spans_and_the_profiler_share_a_clock(
        workload, kernel, parent, cuda_device, tmp_path):
    """A 4 s traced window: the i-th ``kernel:<kernel>`` span and the
    i-th kernel the profiler matched to it. In at least 99% of the pairs
    the kernel starts between its span's start and the end of its parent
    span, as the profiler and the spans read them (no correction);
    ``hostspans`` moves no device op by a millisecond."""
    got = window_reading(workload, kernel, parent, tmp_path, 4.0)
    pairs = got["pairs"]
    assert sum(1 for s, e, k in pairs if s <= k <= e) >= 0.99 * len(pairs)
    assert got["lead"] < 1e6


@pytest.mark.cuda
@CELLS
def test_the_benchmarks_window_reports_the_profilers_clock(
        workload, kernel, parent, cuda_device, tmp_path):
    """A traced window of the benchmark's length, the one the metrics
    are read from, holds what ``window_reading`` checks at any length.
    Over such a window the profiler's conversion of the card's clock
    drifts, both ways and by a different amount in each run, against
    the spans' clock and against the card's own event clock, which keeps
    the host's rate (on an H100: a q8 window read kernels up to 3 ms
    before their spans, another none): so how far the profiler ran
    ahead, and how far ``hostspans`` moved the device ops back, is not
    held to a bound here but reported in the run's line
    (``clock_early_pct``, ``clock_lead_ms``)."""
    window_reading(workload, kernel, parent, tmp_path)


def test_device_ops_keep_the_profilers_clock():
    """The ops the attribution places against the spans are read in µs
    of the profiler's own timestamps (Unix time), never rebased."""
    class Ev:
        def __init__(self, name, t0, dur):
            self._n, self._t, self._d = name, t0, dur

        def name(self):
            return self._n

        def start_ns(self):
            return self._t

        def duration_ns(self):
            return self._d

        def device_type(self):
            from torch.autograd import DeviceType
            return DeviceType.CUDA

    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: [
            Ev("b", OFF + 2 * MS, MS), Ev("a", OFF + MS, MS)])))
    ops = devtrace.device_ops(prof)
    assert [(o.name, o.start_us) for o in ops] == \
        [("a", (OFF + MS) / 1e3), ("b", (OFF + 2 * MS) / 1e3)]
