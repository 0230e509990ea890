"""The largest lead, in ms, by which the profiler reads one of the
traced window's paired kernels as starting before the span that
launched it (``hostspans.clock_reading``; 0 where none starts early):
the largest move ``clock_shifts`` makes before the idle attribution."""
from lakebench import hostspans


def read(run):
    got = hostspans.clock_reading(run)
    return None if got is None else got[2] / 1e6
