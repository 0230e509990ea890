"""Seconds of set-up in the cold tier: the five `ColdTier.commit`s of the
version history (each a compressed .npz segment and a log entry)."""


def read(run):
    return run.phases.get("cold_commits")
