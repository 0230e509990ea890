"""What the host did while the card was idle: every span of the traced
window's batches (``run.traces``) put on the profiler's clock with its
root's Unix offset, and each instant of the device's idle time (the
window less the union of the profiler's device ops) charged to the
deepest span open at that instant.

Labels are span names with segment and shard ids folded (``ivf_scan:7``
counts as ``ivf_scan:*``). An instant under a root ``batch`` alone, or
under no trace, is "unattributed". Of the root-only time, what lies
after the closed loop's finish stamp of its batch is the harness's own
client work (stamping answers, drawing the next questions), counted
apart as "harness" within the unattributed time.

The profiler's device timestamps are its own conversion of the card's
clock to Unix time, which can run ahead of the host's, by an amount that
changes within a window (a kernel then seems to start before the span
that launched it). ``clock_shifts`` moves each of the cell's paired
kernels (``counts/``) the least that puts it at or after its span's
start, and every other device op by the shifts of the paired kernels
around it, interpolated, before the attribution.

A program whose spans carry no clock (``start_ns`` and the root's
``clock_offset_ns``) gives nothing to read: ``attribute`` returns None.
"""
from __future__ import annotations

import bisect
import heapq
import importlib
import pkgutil
import re
import sys


UNATTRIBUTED = "unattributed"
HARNESS = "harness"
_FOLD = re.compile(r"^(ivf_scan|solo_scan|shard):.*$|^(.*):\d+$")


def fold(name: str) -> str:
    """A span name with its segment or shard id replaced by ``*``."""
    m = _FOLD.match(name)
    if m is None:
        return name
    return f"{m.group(1) or m.group(2)}:*"


def _roots(run) -> list:
    """The window's distinct roots (a hedged batch hands its root over
    twice), or [] where the spans carry no clock."""
    seen, out = set(), []
    for root in run.traces or ():
        if id(root) in seen:
            continue
        seen.add(id(root))
        if getattr(root, "clock_offset_ns", None) is None:
            return []
        out.append(root)
    return out


def _walk(root):
    stack = [root]
    while stack:
        sp = stack.pop()
        yield sp
        stack.extend(sp.children)


def spans_on_clock(root, base: int = 0) -> list[tuple[int, int, int, str]]:
    """(start, end, depth, label) of every span under ``root`` in Unix
    ns less ``base``, the root at depth 0."""
    off = root.clock_offset_ns - base
    out, stack = [], [(root, 0)]
    while stack:
        sp, depth = stack.pop()
        if sp.end_ns > sp.start_ns:
            out.append((sp.start_ns + off, sp.end_ns + off, depth,
                        fold(sp.name)))
        stack.extend((c, depth + 1) for c in sp.children)
    return out


def kernel_pairs(run, roots) -> list[tuple[int, float]]:
    """(span start, kernel start) in Unix ns of every ``kernel:*`` span
    that a kernel file under ``counts/`` names and of the kernel the
    profiler matched to it, the i-th span with the i-th kernel; a kernel
    whose spans and matched kernels differ in number gives none."""
    import lakebench.counts as counts

    out = []
    for info in pkgutil.iter_modules(counts.__path__):
        count = importlib.import_module(f"lakebench.counts.{info.name}")
        starts = sorted(sp.start_ns + r.clock_offset_ns for r in roots
                        for sp in _walk(r) if sp.name == count.SPAN)
        kern = sorted(o.start_us * 1e3 for o in run.device_ops
                      if count.matches(o.name))
        if starts and len(starts) == len(kern):
            out.extend(zip(starts, kern))
    return out


def clock_shifts(run, roots) -> list[tuple[float, float]]:
    """(kernel start, shift) in Unix ns for every paired kernel, by
    start: the least shift that puts the kernel at or after the start of
    the span that launched it (0 where it starts inside)."""
    return sorted((k, max(0.0, s - k)) for s, k in kernel_pairs(run, roots))


def clock_reading(run):
    """``(early, paired, lead_ns)`` of the traced window: the paired
    kernels the profiler reads before the start of the span that
    launched them, of all paired, and the largest such lead; None where
    the spans carry no clock or no kernel pairs with its span."""
    roots = _roots(run)
    shifts = clock_shifts(run, roots) if roots and run.device_ops else []
    if not shifts:
        return None
    return (sum(1 for _, d in shifts if d > 0), len(shifts),
            max(d for _, d in shifts))


def on_span_clock(shifts):
    """A device time (Unix ns, the profiler's) on the spans' clock: moved
    by the shifts of the paired kernels on either side of it, linearly
    between them (the first's before the first, the last's after the
    last)."""
    ks = [k for k, _ in shifts]

    def conv(t: float) -> float:
        if not ks:
            return t
        j = bisect.bisect_right(ks, t)
        if j == 0:
            return t + shifts[0][1]
        if j == len(ks):
            return t + shifts[-1][1]
        (k0, d0), (k1, d1) = shifts[j - 1], shifts[j]
        return t + d0 + (d1 - d0) * (t - k0) / (k1 - k0)
    return conv


def idle_intervals(ops, lo: float, hi: float, conv=lambda t: t
                   ) -> list[tuple[float, float]]:
    """The device's idle intervals within [lo, hi] (ns on the spans'
    clock): where no op runs; ``conv`` takes an op's time (Unix ns, the
    profiler's) there."""
    out, t = [], lo
    for s, e in sorted((conv(o.start_us * 1e3), conv(o.end_us * 1e3))
                       for o in ops):
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def charge(spans, idle, harness_from=None) -> dict[str, float]:
    """Seconds of ``idle`` time by the label of the deepest span open at
    each instant (the later-started one where two of one depth overlap).
    ``spans``: (start, end, depth, label) in ns, depth 0 a root.
    ``harness_from``: for each root, by its start, the instant after
    which its root-only time is the harness's."""
    harness_from = harness_from or {}
    bounds = sorted({t for s, e, _, _ in spans for t in (s, e)}
                    | {t for iv in idle for t in iv}
                    | set(harness_from.values()))
    starts = sorted(range(len(spans)), key=lambda i: spans[i][0])
    active: list = []               # heap of (-depth, -start, end, i)
    out: dict[str, float] = {}
    nxt, k = 0, 0
    for a, b in zip(bounds, bounds[1:]):
        while nxt < len(starts) and spans[starts[nxt]][0] <= a:
            i = starts[nxt]
            s, e, depth, _ = spans[i]
            heapq.heappush(active, (-depth, -s, e, i))
            nxt += 1
        while active and active[0][2] <= a:
            heapq.heappop(active)
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        if k == len(idle) or idle[k][0] >= b:
            continue
        if not active:
            label = UNATTRIBUTED
        else:
            depth, _, _, i = active[0]
            label = spans[i][3]
            if depth == 0:
                label = UNATTRIBUTED
                h = harness_from.get(spans[i][0])
                if h is not None and a >= h:
                    label = HARNESS
        out[label] = out.get(label, 0.0) + (b - a) / 1e9
    return out


def attribute(run):
    """``{"idle_s", "by_label", "unattributed_s", "harness_s", "lead_ns"
    (the largest shift), "early", "paired" (kernels shifted, of all
    paired)}`` over the traced window, or None where there is nothing to
    read."""
    roots = _roots(run)
    if not roots or not run.device_ops or run.trace_window_s <= 0:
        return None
    # Unix ns less the first root's start: exact in a float
    base = roots[0].start_ns + roots[0].clock_offset_ns
    lo = run.window[0] * 1e9 - roots[0].start_ns
    hi = lo + run.trace_window_s * 1e9
    spans = [s for r in roots for s in spans_on_clock(r, base)]
    shifts = clock_shifts(run, roots)
    conv = on_span_clock(shifts)
    idle = idle_intervals(run.device_ops, lo, hi, lambda t: conv(t) - base)
    # each root's harness share starts at the loop's last finish stamp
    # within it (the loop stamps a batch's answers before the root
    # closes); the stamps are perf_counter seconds, the spans' clock
    done = sorted(b[1] for b in getattr(run.loop, "batches", ()))
    harness_from = {}
    for r in roots:
        j = bisect.bisect_right(done, r.end_ns / 1e9) - 1
        if j >= 0 and done[j] >= r.start_ns / 1e9:
            off = r.clock_offset_ns - base
            harness_from[r.start_ns + off] = done[j] * 1e9 + off
    by_label = charge(spans, idle, harness_from)
    idle_s = sum(b - a for a, b in idle) / 1e9
    harness = by_label.pop(HARNESS, 0.0)
    return {"idle_s": idle_s, "by_label": by_label,
            "unattributed_s": by_label.get(UNATTRIBUTED, 0.0) + harness,
            "harness_s": harness,
            "lead_ns": max((d for _, d in shifts), default=0.0),
            "early": sum(1 for _, d in shifts if d > 0),
            "paired": len(shifts)}


def log_table(att: dict, top: int = 10) -> None:
    """The ``top`` labels by idle seconds, to standard error."""
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log(f"hostspans: device idle {att['idle_s']:.6f} s; unattributed "
        f"{att['unattributed_s']:.6f} s, of which the harness's "
        f"{att['harness_s']:.6f} s; {att['early']} of {att['paired']} "
        f"paired kernels read before their span, by up to "
        f"{att['lead_ns'] / 1e3:.1f} us")
    rows = sorted(att["by_label"].items(), key=lambda kv: -kv[1])[:top]
    for label, sec in rows:
        log(f"hostspans: {sec:12.6f} s  {label}")
