"""Mean wall ms a batch in the hot tier's fused block over the memtable
and small segments, its int8 pool's rescore included (span
``fused_scan``)."""


def read(run):
    return run.per_batch("fused_scan")
