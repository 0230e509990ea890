"""Per-request deadline propagation (DESIGN.md §13).

A deadline is an ABSOLUTE ``time.perf_counter()`` instant carried
through the stack by a contextvar — exactly like the trace contextvar:
the batcher opens a ``deadline_scope`` around each dispatched batch and
every layer underneath (planner scatter, per-shard engine pass) can ask
``remaining()`` / ``check()`` without any plumbing through call
signatures. Nested scopes MIN-combine: an inner layer can only tighten
the budget, never extend it.

Absolute instants (not durations) are the load-bearing choice: a
request that sat in the admission queue for 40ms of a 50ms deadline
enters execution with 10ms left — the scatter layer sees the truth,
not a fresh budget.
"""
from __future__ import annotations

import time
from contextvars import ContextVar
from typing import Optional

_DEADLINE: ContextVar[Optional[float]] = ContextVar("serve_deadline",
                                                    default=None)


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or during) execution."""


class _DeadlineCtx:
    __slots__ = ("at", "token")

    def __init__(self, at: Optional[float]):
        self.at = at

    def __enter__(self):
        cur = _DEADLINE.get()
        eff = self.at
        if cur is not None and (eff is None or cur < eff):
            eff = cur                          # nested scopes min-combine
        self.token = _DEADLINE.set(eff)
        return eff

    def __exit__(self, *exc):
        _DEADLINE.reset(self.token)
        return False


def deadline_scope(seconds: Optional[float] = None,
                   at: Optional[float] = None):
    """Context manager installing a deadline for the enclosed work.
    ``seconds`` is relative to now; ``at`` is an absolute
    ``perf_counter()`` instant (the batcher uses ``at`` so queueing time
    counts against the budget). Passing neither inherits the current
    deadline unchanged."""
    if at is None and seconds is not None:
        at = time.perf_counter() + seconds
    return _DeadlineCtx(at)


def deadline_at() -> Optional[float]:
    """The active absolute deadline (perf_counter instant), or None."""
    return _DEADLINE.get()


def remaining() -> Optional[float]:
    """Seconds left on the active deadline (may be negative), or None
    when no deadline is set."""
    at = _DEADLINE.get()
    if at is None:
        return None
    return at - time.perf_counter()


def expired() -> bool:
    at = _DEADLINE.get()
    return at is not None and time.perf_counter() >= at


def check(what: str = "request") -> None:
    """Raise ``DeadlineExceeded`` if the active deadline has passed."""
    at = _DEADLINE.get()
    if at is not None:
        over = time.perf_counter() - at
        if over >= 0.0:
            raise DeadlineExceeded(
                f"{what}: deadline exceeded by {over * 1e3:.1f}ms")
