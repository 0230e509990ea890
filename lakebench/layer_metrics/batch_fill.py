"""Mean requests a dispatched batch (the batcher's counters)."""


def read(run):
    b = run.counters["batcher_batches"]
    return run.counters["batcher_requests"] / b if b else None
