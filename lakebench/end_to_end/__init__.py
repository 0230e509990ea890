"""Readers of the end-to-end metrics, one file a metric: ``read(run)``
returns the number, or None where the run has nothing to read."""
