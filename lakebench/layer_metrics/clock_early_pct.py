"""Share of the traced window's paired kernels, in percent, that the
profiler reads as starting before the span that launched them
(``hostspans.clock_reading``): how far the profiler's device clock ran
ahead of the host's in this run, and so how much of the idle
attribution (``idle_unattributed_pct``) rests on ``clock_shifts``."""
from lakebench import hostspans


def read(run):
    got = hostspans.clock_reading(run)
    if got is None:
        return None
    early, paired, _ = got
    return 100.0 * early / paired
