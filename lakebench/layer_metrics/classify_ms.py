"""Mean wall ms a batch of the store facade's intent parsing and grouping
(span ``classify`` in ``query_batch``)."""


def read(run):
    return run.per_batch("classify")
