"""Mean wall ms a batch in the hot tier's IVF member scans, summed over
its segments (spans ``ivf_scan:<segment>``)."""


def read(run):
    return run.per_batch("ivf_scan:", exact=False)
