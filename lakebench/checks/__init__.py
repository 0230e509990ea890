"""Correctness checks, one module a kind of answer, named by a cell's
``lakebench/limits/<workload>.json``. Each has ``context(hist, emb, rows,
cfg, mix)``, ``numbers(ctx, samples, control=None)`` and ``CONTROLS``,
the names of its controls (``control.py``)."""
import importlib


def load_check(name: str):
    return importlib.import_module(f"{__name__}.{name}")
