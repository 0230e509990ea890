"""Mean wall ms of the store facade's query embedding a batch (span
``embed``)."""


def read(run):
    return run.per_batch("embed")
