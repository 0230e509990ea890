"""A kernel's share of its roofline: the least time the card could take
for every call of the traced window (each call the larger of its bytes
over the HBM bandwidth and its operations over the data sheet's peak for
its type), over the device time the profiler gave the kernel's launches.
The work of each call is counted from its shapes by the kernel's own
file under ``counts/``, never from the implementation."""
from __future__ import annotations

import importlib
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def calls(run, span_name: str) -> list[dict]:
    """Every call of a kernel in the traced window, with the shapes its
    count needs: rows from the kernel's span, the real queries from the
    enclosing ``intent:*`` span, the pool (k') of a quantized fused scan
    from its ``rescore_pool`` counter."""
    out = []
    for root in run.traces:
        for intent in root.find_prefix("intent:"):
            q = int(intent.counters.get("queries", 0))
            for parent in intent.find_prefix(""):
                for sp in parent.children:
                    if sp.name != span_name:
                        continue
                    pool = parent.counters.get("rescore_pool", 0)
                    out.append({"rows": int(sp.counters.get("rows", 0)),
                                "queries": q, "dim": run.dim,
                                "k": run.k,
                                "pool": int(pool // q) if q else 0})
    return out


def share(run, kernel: str):
    """Percent of the roofline, or None where the window ran no call."""
    count = importlib.import_module(f"lakebench.counts.{kernel}")
    device_s = sum(o.end_us - o.start_us for o in run.device_ops
                   if count.matches(o.name)) / 1e6
    least = 0.0
    for c in calls(run, count.SPAN):
        nbytes, ops = count.work(c)
        least += max(nbytes / PEAKS["hbm_bytes_per_s"],
                     ops / PEAKS["ops_per_s"][count.PEAK])
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
