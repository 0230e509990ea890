"""Process-wide metrics registry (DESIGN.md §12).

Counters, gauges, and fixed-bucket latency histograms with per-label
instances — ``REGISTRY.histogram("query_latency_ms", tier="hot",
intent="current")`` get-or-creates one series per (name, labels) pair.
Histograms report p50/p99/p99.9 WITHOUT storing samples: observations
land in geometric buckets (factor 1.15 from 1e-3 to ~1e5) and quantiles
are linearly interpolated inside the crossing bucket, clamped to the
observed min/max — accuracy is bounded by the bucket width (<~7.5%
relative), validated against numpy percentiles in tests.

Everything is plain-Python and allocation-light: ``Counter.inc`` is one
float add, ``Histogram.observe`` one bisect + three adds — cheap enough
to stay ALWAYS on (the trace layer is the part that toggles).

Thread safety (DESIGN.md §13): serving threads, the batcher dispatcher,
and maintenance workers all hit the same series concurrently, so every
mutation (inc/set/observe) and every read that folds multiple fields
(quantile/summary/snapshot) holds the instrument's lock — read-modify-
write sequences like ``self.value += n`` are NOT atomic in CPython.
That includes ``Gauge`` (DESIGN.md §15): it was documented lock-free
when it only had last-write-wins ``set``, but ``inc()`` is a
read-modify-write and the batcher's threads would drop updates.

Windowed accounting (DESIGN.md §15): ``Histogram.snapshot_at()`` takes
an immutable point-in-time copy of the bucket state and
``Histogram.delta(prev)`` subtracts one, so the SLO engine computes
"what happened in the last W seconds" from two snapshots — still no
samples stored anywhere.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_right
from typing import NamedTuple, Optional


def geometric_bounds(lo: float = 1e-3, hi: float = 1e5,
                     factor: float = 1.15) -> list[float]:
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * factor)
    return bounds


_DEFAULT_BOUNDS = tuple(geometric_bounds())


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Current-value instrument. ``set`` is last-write-wins but ``inc``
    is a read-modify-write, so both hold the lock — concurrent
    ``inc()`` calls from the batcher's threads must never drop updates
    (hammer-tested)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class HistSnapshot(NamedTuple):
    """Immutable point-in-time copy of a Histogram's state. Two
    snapshots subtract (``Histogram.delta``) into the traffic that
    arrived between them — the primitive the SLO engine's rolling
    windows are built on (DESIGN.md §15)."""

    bounds: tuple
    counts: tuple
    count: int
    sum: float

    def count_le(self, threshold: float) -> float:
        """Observations <= ``threshold``, linearly interpolated inside
        the crossing bucket (same accuracy bound as ``quantile``:
        the geometric bucket width, <~7.5% relative)."""
        if self.count == 0:
            return 0.0
        i = bisect_right(self.bounds, threshold)
        total = float(sum(self.counts[:i]))
        if i < len(self.bounds):       # crossing bucket [lo, hi): the
            c = self.counts[i]         # overflow bucket never interpolates
            if c:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                total += c * (threshold - lo) / (hi - lo)
        return min(total, float(self.count))

    def fraction_over(self, threshold: float) -> float:
        """Fraction of observations strictly over ``threshold``."""
        if self.count == 0:
            return 0.0
        return max(0.0, 1.0 - self.count_le(threshold) / self.count)


class Histogram:
    """Fixed-bucket histogram: bucket i counts observations in
    (bounds[i-1], bounds[i]]; the last slot is the overflow bucket."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, bounds=None):
        self.bounds = list(bounds) if bounds is not None \
            else list(_DEFAULT_BOUNDS)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # RLock: summary() reads quantile() under the same lock
        self._lock = threading.RLock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect_right(self.bounds, v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile from bucket counts (no samples kept)."""
        with self._lock:
            if self.count == 0:
                return None
            rank = q * self.count
            cum = 0.0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if cum + c >= rank:
                    lo = self.bounds[i - 1] if i > 0 else self.min
                    hi = self.bounds[i] if i < len(self.bounds) \
                        else self.max
                    frac = (rank - cum) / c
                    v = lo + frac * (hi - lo)
                    return min(max(v, self.min), self.max)
                cum += c
            return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot_at(self) -> HistSnapshot:
        """Immutable copy of the bucket state right now (DESIGN.md §15):
        the SLO engine keeps a short ring of these and never any
        samples."""
        with self._lock:
            return HistSnapshot(tuple(self.bounds), tuple(self.counts),
                                self.count, self.sum)

    def delta(self, prev: Optional[HistSnapshot]) -> HistSnapshot:
        """The traffic observed since ``prev`` (a ``snapshot_at`` taken
        earlier on THIS histogram) as a snapshot of its own —
        quantile-free windowed accounting for burn rates. ``prev=None``
        means "since forever" (delta == current state). A prev with
        MORE observations than now (the registry was reset underneath)
        degrades to the current state instead of going negative."""
        cur = self.snapshot_at()
        if prev is None or prev.count > cur.count \
                or prev.bounds != cur.bounds:
            return cur
        return HistSnapshot(
            cur.bounds,
            tuple(c - p for c, p in zip(cur.counts, prev.counts)),
            cur.count - prev.count, cur.sum - prev.sum)

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            return {"count": self.count, "sum": round(self.sum, 6),
                    "mean": round(self.mean, 6),
                    "min": round(self.min, 6), "max": round(self.max, 6),
                    "p50": round(self.quantile(0.5), 6),
                    "p99": round(self.quantile(0.99), 6),
                    "p999": round(self.quantile(0.999), 6)}


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> tuple[str, dict]:
    """Invert ``_series_key``: ``name{k=v,...}`` -> (name, labels). The
    export layer uses this to re-attach labels to Prometheus series."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key[:-1].partition("{")
    labels = {}
    for pair in inner.split(","):
        if pair:
            k, _, v = pair.partition("=")
            labels[k] = v
    return name, labels


class MetricsRegistry:
    """Get-or-create registry of labeled series. One process-wide
    instance (``REGISTRY``) backs the whole fabric; tests may build
    private ones or ``reset()`` the default."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, **labels) -> Counter:
        key = _series_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = _series_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str, bounds=None, **labels) -> Histogram:
        key = _series_key(name, labels)
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(key, Histogram(bounds))
        return h

    def export_state(self) -> tuple[list, list, list]:
        """Stable-ordered (key, instrument) lists for the three series
        kinds — the export layer's raw feed (obs/export.py). The lists
        are copies; the instruments are live (read them under their own
        locks)."""
        with self._lock:
            return (sorted(self._counters.items()),
                    sorted(self._gauges.items()),
                    sorted(self._hists.items()))

    def snapshot(self) -> dict:
        """One queryable view of every series: counters/gauges by value,
        histograms by count/sum/min/max/p50/p99/p99.9."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        return {
            "counters": {k: v.value for k, v in counters},
            "gauges": {k: v.value for k, v in gauges},
            "histograms": {k: h.summary() for k, h in hists},
        }

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


REGISTRY = MetricsRegistry()
