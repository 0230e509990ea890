"""Seconds from the start of the process to the first timed request:
the kernels' build or load, the history, the cold commits, the store's
open (its recover()) and the warm-up."""


def read(run):
    return run.setup_s
