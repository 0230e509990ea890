"""Mean wall ms a batch of the batcher's admissions (span ``submit``: the
bucket's intent parsed, the request queued). In the closed loop each
replacement request is submitted inside the batch that answered the one
before it, so a batch holds about one submit a query. A program whose
spans carry the clock (``clock_offset_ns`` on each root) spans every
submit, so where none of its batches holds one (a window that closed
before the first batch returned: no replacement was sent) the batches
held no submit work: 0."""


def read(run):
    ms = run.per_batch("submit")
    if ms is None and run.traces and getattr(
            run.traces[0], "clock_offset_ns", None) is not None:
        return 0.0
    return ms
