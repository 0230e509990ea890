"""Central fault-injection registry (DESIGN.md §13).

Before this existed every crash-recovery test threaded an ad-hoc
``fail_at``/``fail_after`` string through whichever class it wanted to
crash.  That worked for single-layer drills but cannot express "crash
the SECOND cold-tier checkpoint while a rebalance is copying docs and
queries are in flight" — chaos drills need one switchboard that any
layer consults at its hazard points.

Production code calls ``FAULTS.check("layer:op:point")`` at each
injection point.  The fast path — nothing armed anywhere — is a single
attribute load and truthiness test, no locks, no allocation, so the
checks are free in real serving.

Tests arm rules::

    FAULTS.arm("cold:checkpoint:data")             # crash 1st call
    FAULTS.arm("lsm:merge:before_manifest", nth=2) # crash 2nd call
    FAULTS.arm("shard:s01:query", times=10**9)     # shard hard-down
    FAULTS.arm("rebalance:copy:*", prob=0.5)       # coin-flip per doc
    ...
    FAULTS.reset()                                 # always in teardown

Trigger semantics: a rule starts firing at its ``nth`` matching call
(or each call with probability ``prob``; the registry RNG is seeded so
probabilistic drills replay deterministically) and keeps firing until
it has fired ``times`` times, after which it disarms itself.  ``times=1``
models a transient fault (retry succeeds); a large ``times`` models a
hard-down component.  A trailing ``*`` matches any point with that
prefix.  The exception raised is the rule's ``exc`` if set, else the
call site's ``exc`` (each layer passes its native crash type so
existing recovery handlers catch exactly what they always caught).

Corruption injection (DESIGN.md §16) is the silent-failure sibling of
``check``: ``FAULTS.corrupt(point, mode=...)`` arms a rule that does
NOT raise — instead, when production code calls
``FAULTS.mutate(point, path)`` right after persisting an artifact, the
bytes on disk are deterministically mutilated (``bitflip`` one byte
mid-file, ``truncate`` the tail, ``zero`` a range).  The write path
reports success, the in-memory state stays pristine, and the rot is
only discoverable by checksum — exactly the bit-rot/torn-write threat
the integrity subsystem exists to catch.  ``corrupt_file`` is the raw
mutilator, exported for tests that rot an artifact directly.
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Optional


class FaultError(RuntimeError):
    """Default exception raised at an armed fault point."""


CORRUPT_MODES = ("bitflip", "truncate", "zero")


def corrupt_file(path: str, mode: str = "bitflip") -> bool:
    """Deterministically mutilate the bytes of *path* on disk.

    - ``bitflip``: flip one bit of the middle byte;
    - ``truncate``: cut the file to 3/4 of its length (torn write);
    - ``zero``: zero a 64-byte range starting at len//3.

    Offsets are pure functions of the file length, so a drill replays
    byte-identically.  Returns False when the file is empty/absent
    (nothing to rot)."""
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}")
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size == 0:
        return False
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size * 3 // 4, size - 1))
        return True
    with open(path, "r+b") as f:
        if mode == "bitflip":
            off = size // 2
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x01]))
        else:                                   # zero
            off = size // 3
            n = min(64, size - off)
            f.seek(off)
            f.write(b"\x00" * n)
        f.flush()
        os.fsync(f.fileno())
    return True


@dataclass
class FaultRule:
    """One armed injection point (see module docstring for semantics)."""
    point: str
    exc: Optional[type] = None
    nth: Optional[int] = None
    prob: Optional[float] = None
    times: int = 1
    message: Optional[str] = None
    mode: Optional[str] = None      # set on corruption rules only
    calls: int = 0
    fired: int = 0
    _tripped: bool = field(default=False, repr=False)

    def should_fire(self, rng: random.Random) -> bool:
        self.calls += 1
        if self.fired >= self.times:
            return False
        if self.prob is not None:
            return rng.random() < self.prob
        if self._tripped:                 # nth reached earlier: keep firing
            return True
        if self.calls >= (self.nth or 1):
            self._tripped = True
            return True
        return False


class FaultRegistry:
    """Thread-safe switchboard of armed fault rules, keyed by point name."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rules: dict[str, FaultRule] = {}
        self._prefixes: list[FaultRule] = []    # rules armed with 'xyz:*'
        self._corrupt_rules: dict[str, FaultRule] = {}
        self._corrupt_prefixes: list[FaultRule] = []
        self._rng = random.Random(seed)
        self.history: list[str] = []            # fired points, in order
        # fired-fault observers (the flight recorder's autodump hook —
        # DESIGN.md §15). NOT cleared by reset(): tests reset rules in
        # teardown and the recorder must survive that.
        self._listeners: list = []

    # -- arming ---------------------------------------------------------
    def arm(self, point: str, exc: Optional[type] = None,
            nth: Optional[int] = None, prob: Optional[float] = None,
            times: int = 1, message: Optional[str] = None) -> FaultRule:
        rule = FaultRule(point=point, exc=exc, nth=nth, prob=prob,
                         times=int(times), message=message)
        with self._lock:
            if point.endswith("*"):
                self._prefixes = [r for r in self._prefixes
                                  if r.point != point] + [rule]
            else:
                self._rules[point] = rule
        return rule

    def corrupt(self, point: str, mode: str = "bitflip",
                nth: Optional[int] = None, prob: Optional[float] = None,
                times: int = 1) -> FaultRule:
        """Arm silent on-disk corruption at ``point``: the next matching
        ``mutate(point, path)`` call mutilates the just-written artifact
        instead of raising (see module docstring)."""
        if mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corruption mode {mode!r}")
        rule = FaultRule(point=point, nth=nth, prob=prob,
                         times=int(times), mode=mode)
        with self._lock:
            if point.endswith("*"):
                self._corrupt_prefixes = [
                    r for r in self._corrupt_prefixes
                    if r.point != point] + [rule]
            else:
                self._corrupt_rules[point] = rule
        return rule

    def disarm(self, point: str) -> None:
        with self._lock:
            self._rules.pop(point, None)
            self._prefixes = [r for r in self._prefixes if r.point != point]
            self._corrupt_rules.pop(point, None)
            self._corrupt_prefixes = [r for r in self._corrupt_prefixes
                                      if r.point != point]

    def reset(self, seed: int = 0) -> None:
        with self._lock:
            self._rules.clear()
            self._prefixes.clear()
            self._corrupt_rules.clear()
            self._corrupt_prefixes.clear()
            self._rng = random.Random(seed)
            self.history.clear()

    # -- listeners ------------------------------------------------------
    def add_listener(self, fn) -> None:
        """Register ``fn(point)`` to run every time a fault FIRES (after
        the registry lock is released, before the exception is raised).
        Listener errors are swallowed — observability must never mask
        the injected fault itself."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            self._listeners = [f for f in self._listeners if f is not fn]

    # -- introspection --------------------------------------------------
    def armed(self) -> list[str]:
        with self._lock:
            return (sorted(self._rules)
                    + sorted(r.point for r in self._prefixes)
                    + sorted(self._corrupt_rules)
                    + sorted(r.point for r in self._corrupt_prefixes))

    def fired(self, point: Optional[str] = None) -> int:
        with self._lock:
            if point is None:
                return len(self.history)
            return sum(1 for p in self.history if p == point)

    # -- the hot-path check ---------------------------------------------
    def check(self, point: str, exc: type = FaultError) -> None:
        """Raise if a rule matching ``point`` decides to fire.

        Fast path (nothing armed): one attribute load + truthiness test
        per collection, no lock.  A momentarily stale read is fine —
        arming happens in test setup, not concurrently with the call
        under test.
        """
        if not self._rules and not self._prefixes:
            return
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                for r in self._prefixes:
                    if point.startswith(r.point[:-1]):
                        rule = r
                        break
            if rule is None or not rule.should_fire(self._rng):
                return
            rule.fired += 1
            self.history.append(point)
            etype = rule.exc or exc
            msg = rule.message or f"injected fault at {point}"
            listeners = list(self._listeners)
        for fn in listeners:        # outside the lock: a listener may
            try:                    # re-enter the registry (recorder
                fn(point)           # dumps read `fired()`)
            except Exception:
                pass
        raise etype(msg)

    def mutate(self, point: str, path: str) -> bool:
        """Corruption-injection hook: production write paths call this
        right after persisting an artifact at *path*.  Fast path
        (nothing armed): one attribute load per collection, no lock.
        When an armed corruption rule fires, the file's bytes are
        mutilated in place and the call returns True — the write path
        itself keeps reporting success (silent corruption)."""
        if not self._corrupt_rules and not self._corrupt_prefixes:
            return False
        with self._lock:
            rule = self._corrupt_rules.get(point)
            if rule is None:
                for r in self._corrupt_prefixes:
                    if point.startswith(r.point[:-1]):
                        rule = r
                        break
            if rule is None or not rule.should_fire(self._rng):
                return False
            rule.fired += 1
            self.history.append(point)
            mode = rule.mode or "bitflip"
        return corrupt_file(path, mode)

    def notify(self, point: str) -> None:
        """Fire the listener hooks without raising — used by REAL
        corruption detection so a checksum mismatch found in the wild
        dumps flight-recorder evidence exactly like an injected fault
        (the recorder's autodump listener is point-agnostic)."""
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(point)
            except Exception:
                pass


FAULTS = FaultRegistry()
