"""Kernel-level cost attribution (DESIGN.md §15).

Every ``kernel:*`` span already counts the bytes it streamed
(rows x dim x elem_size — int8 scans count 1 byte/elem, fp32 4). This
module turns those raw counters into the judgment an operator needs
from a slow trace: *achieved GB/s* per kernel dispatch, the fraction of
the roofline that represents, and a one-word verdict for the whole
request — **bandwidth-bound** (the kernels dominated and ran near the
memory roofline: buy bandwidth or shrink bytes), **dispatch-bound**
(wall time went to everything around the kernels: Python dispatch,
planning, merging — batch harder), or **queue-bound** (the request
mostly waited for admission/dispatch: shed load or add capacity).

The peak is the HBM3 rate of the card the port targets, an NVIDIA
H100 SXM (3.35 TB/s, NVIDIA's data sheet, at the full 700 W power
limit). Kernel spans never synchronize: on the card a traced kernel span
carries ``device_ms``, read from a pair of CUDA events recorded as the
span opens and closes, and the achieved fraction is computed from it, a
device figure. The pair bounds the kernel time from above: it also
holds the span's other device work (a candidate merge), and where the
stream was idle as the span opened, the host's time to enqueue the
launch, so the fraction is a lower bound. A span without it (a CPU run)
falls back to its host wall time, and the point there is the RELATIVE
attribution.

Annotation happens on SERIALIZED trace dicts (the flight recorder's
retained records), never on the hot path: serving pays for the raw
counters only.
"""
from __future__ import annotations

# NVIDIA H100 SXM HBM3 bandwidth (data sheet): 3.35 TB/s.
PEAK_HBM_GBS = 3350.0


def kernel_ms(span_dict: dict) -> float:
    """A span's kernel time: its ``device_ms`` counter where the card
    timed it (an upper bound), else its host wall time."""
    dev = (span_dict.get("counters") or {}).get("device_ms")
    return dev if dev is not None else span_dict.get("wall_ms", 0.0)


def annotate_span(span_dict: dict) -> None:
    """Recursively annotate ``kernel:*`` spans that carry
    ``bytes_streamed`` with achieved_gbs + roofline_frac, in place."""
    counters = span_dict.get("counters")
    ms = kernel_ms(span_dict)
    if (span_dict.get("name", "").startswith("kernel:") and counters
            and counters.get("bytes_streamed") and ms > 0):
        gbs = counters["bytes_streamed"] / (ms / 1e3) / 1e9
        counters["achieved_gbs"] = round(gbs, 4)
        counters["roofline_frac"] = round(gbs / PEAK_HBM_GBS, 6)
    for child in span_dict.get("children", ()):
        annotate_span(child)


def _fold(span_dict: dict, pred) -> float:
    total = sum(_fold(c, pred) for c in span_dict.get("children", ()))
    if pred(span_dict):
        total += kernel_ms(span_dict)
    return total


def annotate_costs(trace_dict: dict) -> dict:
    """Annotate a serialized trace (``Trace.to_dict()`` shape) with
    per-kernel roofline numbers and a trace-level ``cost`` verdict.
    Mutates and returns ``trace_dict``."""
    root = trace_dict.get("spans")
    if not root:
        return trace_dict
    annotate_span(root)
    wall = trace_dict.get("wall_ms") or root.get("wall_ms", 0.0)
    # kernel spans never nest inside each other, so the fold is a sum of
    # disjoint intervals; queue_wait_ms is a root counter the batcher
    # sets (time between submit and dispatch)
    kernel_ms = _fold(root, lambda s: s.get("name", "").startswith("kernel:"))
    queue_ms = float((root.get("counters") or {}).get("queue_wait_ms", 0.0))
    best_frac = 0.0
    stack = [root]
    while stack:
        s = stack.pop()
        c = s.get("counters") or {}
        if c.get("roofline_frac", 0.0) > best_frac:
            best_frac = c["roofline_frac"]
        stack.extend(s.get("children", ()))
    if wall <= 0:
        bound = "unknown"
    elif queue_ms / wall >= 0.5:
        bound = "queue-bound"
    elif kernel_ms / wall >= 0.5:
        bound = "bandwidth-bound"
    else:
        bound = "dispatch-bound"
    trace_dict["cost"] = {
        "wall_ms": round(wall, 3),
        "kernel_ms": round(kernel_ms, 3),
        "queue_wait_ms": round(queue_ms, 3),
        "kernel_frac": round(kernel_ms / wall, 4) if wall > 0 else 0.0,
        "best_roofline_frac": round(best_frac, 6),
        "bound": bound,
    }
    return trace_dict
