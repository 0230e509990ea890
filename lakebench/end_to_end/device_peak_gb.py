"""The card's peak allocated memory over set-up and window, in GB
(1e9 bytes): what the expensive tier holds."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
