"""Mean wall ms a batch of building the answers (spans ``results``,
summed): the temporal engine's ``SearchResult``s and the facade's
leakage check on the as-of path, the hot tier's ``_build_results`` on
the current path."""


def read(run):
    return run.per_batch("results")
