"""Share of batches the batcher ran twice as a hedge, in percent: work
the window pays again."""


def read(run):
    b = run.counters["batcher_batches"]
    return 100.0 * run.counters["batcher_hedges"] / b if b else None
