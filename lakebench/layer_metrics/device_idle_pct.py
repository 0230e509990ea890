"""Share of the traced window in which no kernel, copy or set ran on
the card, in percent (the union of the profiler's device intervals)."""
from lakebench.devtrace import busy_intervals


def read(run):
    if not run.device_ops or run.trace_window_s <= 0:
        return None
    busy = sum(e - s for s, e, _, _ in busy_intervals(run.device_ops)) / 1e6
    return 100.0 * max(0.0, 1.0 - busy / run.trace_window_s)
