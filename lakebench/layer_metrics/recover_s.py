"""Seconds of set-up in `LiveVectorLake(root)`: its `recover()` (WAL
reconcile, cold folds, the hot tier rebuilt seal by seal, the hash
store rewritten a document at a time)."""


def read(run):
    return run.phases.get("open_recover")
