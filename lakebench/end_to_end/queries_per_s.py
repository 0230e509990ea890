"""Queries served in the window over its length; the batch in flight at
the close counts for the share of its run that the window saw."""


def read(run):
    return run.served_in_window() / run.seconds
