"""Write-ahead log with compensating transactions (paper §III-C3).

Cross-tier consistency protocol:
  1. INTENT        — ingest begins; payload captures everything needed to
                     re-drive or compensate the transaction
  2. COLD_OK       — cold-tier (durable, ACID) append committed
  3. HOT_OK        — hot-tier apply finished
  4. COMMIT        — transaction fully visible

On crash, ``pending()`` returns in-flight transactions; the reconciler
either rolls them FORWARD (cold tier committed => finish the hot-tier
apply: the cold tier is the source of truth) or COMPENSATES (cold tier not
committed => mark aborted, nothing became visible). This yields eventual
consistency with bounded staleness (<1s in the paper's prototype).

The log is an append-only JSONL file; every record is one fsync'd line
carrying a CRC-32 of its own canonical JSON (DESIGN.md §16).  Replay
verifies every record: at the first torn line (crash mid-write) or CRC
mismatch (bit-rot inside a committed record) the file is physically
truncated to the last good record and recovery resumes loudly — a
``wal_truncated_records`` counter fires and, for a CRC mismatch, the
discarded tail bytes are quarantined as forensic evidence.  Records
written before CRCs existed (no ``crc`` field) replay unchanged.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Optional

from ..obs import REGISTRY
from ..testing.faults import FAULTS
from .integrity import Quarantine, report_corruption

INTENT = "INTENT"
COLD_OK = "COLD_OK"
HOT_OK = "HOT_OK"
COMMIT = "COMMIT"
ABORT = "ABORT"

_TERMINAL = (COMMIT, ABORT)
_ORDER = {INTENT: 0, COLD_OK: 1, HOT_OK: 2, COMMIT: 3, ABORT: 3}


def _record_crc(rec: dict) -> int:
    """CRC-32 over the record's canonical JSON, ``crc`` field excluded."""
    body = {k: v for k, v in rec.items() if k != "crc"}
    return zlib.crc32(
        json.dumps(body, separators=(",", ":"), sort_keys=True)
        .encode("utf-8"))


def _parse_record(raw: str) -> Optional[dict]:
    """One replayed line -> record dict, or None when torn/corrupt
    (unparseable JSON, or a present ``crc`` that doesn't match)."""
    try:
        rec = json.loads(raw)
    except json.JSONDecodeError:
        return None
    if not isinstance(rec, dict):
        return None
    if "crc" in rec and rec["crc"] != _record_crc(rec):
        return None
    return rec


class WriteAheadLog:
    def __init__(self, path: str):
        self._path = path
        root = os.path.dirname(os.path.abspath(path))
        os.makedirs(root, exist_ok=True)
        self.quarantine = Quarantine(root, "wal")
        self._next_txn = 1
        self._state: dict[int, str] = {}
        self._payload: dict[int, dict] = {}
        self.truncated_records = 0
        # txn allocation + line append must be atomic together: ingest
        # (serving thread) and seal/merge publishes (maintenance worker)
        # write the same file (DESIGN.md §13)
        self._lock = threading.Lock()
        if os.path.exists(path):
            self._replay_file()

    # -- writing ---------------------------------------------------------
    def _append(self, rec: dict) -> None:
        rec["crc"] = _record_crc(rec)
        line = json.dumps(rec, separators=(",", ":"))
        with open(self._path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        FAULTS.mutate("wal:record", self._path)

    def begin(self, op: str, payload: Optional[dict[str, Any]] = None) -> int:
        with self._lock:
            txn = self._next_txn
            self._next_txn += 1
            rec = {"txn": txn, "state": INTENT, "op": op,
                   "payload": payload or {}, "ts": time.time_ns() // 1000}
            self._append(rec)
            self._state[txn] = INTENT
            self._payload[txn] = rec["payload"]
            return txn

    def mark(self, txn: int, state: str) -> None:
        if state not in _ORDER:
            raise ValueError(f"unknown WAL state {state!r}")
        with self._lock:
            cur = self._state.get(txn)
            if cur is None:
                raise KeyError(f"unknown txn {txn}")
            if _ORDER[state] <= _ORDER[cur] and state != cur:
                raise ValueError(f"txn {txn}: cannot move {cur} -> {state}")
            self._append({"txn": txn, "state": state,
                          "ts": time.time_ns() // 1000})
            self._state[txn] = state

    # -- recovery ----------------------------------------------------------
    def _replay_file(self) -> None:
        """Replay every verified record; on the first torn or corrupt
        line, physically truncate the file there and resume loudly.

        Truncating (instead of the old silent ``break``) matters: a
        survived torn line would sit MID-file once new records append
        after it, and the next replay would then discard every good
        record behind it."""
        good_end = 0
        bad_crc = False
        with open(self._path, "rb") as f:
            data = f.read()
        for line in data.splitlines(keepends=True):
            raw = line.decode("utf-8", errors="replace").strip()
            if not raw:
                good_end += len(line)
                continue
            rec = _parse_record(raw)
            if rec is None or "txn" not in rec:
                bad_crc = rec is not None or b'"crc"' in line
                break
            txn = rec["txn"]
            self._state[txn] = rec["state"]
            if "payload" in rec:
                self._payload[txn] = rec["payload"]
            self._next_txn = max(self._next_txn, txn + 1)
            good_end += len(line)
        if good_end >= len(data):
            return
        # loud truncation: count it, keep the discarded bytes as
        # evidence when they look like bit-rot (a bare torn final line
        # is a normal crash artifact, not silent corruption)
        tail = data[good_end:]
        dropped = max(1, tail.count(b"\n"))
        self.truncated_records += dropped
        REGISTRY.counter("wal_truncated_records").inc(dropped)
        if bad_crc:
            evidence = self._path + f".tail-{good_end}"
            try:
                with open(evidence, "wb") as f:
                    f.write(tail)
                self.quarantine.quarantine(
                    evidence, "wal_record",
                    f"bad record at byte {good_end} "
                    f"({dropped} record(s) dropped)",
                    docs=[], data_loss=False)
            except OSError:
                pass
            report_corruption("wal_record", "wal")
        with open(self._path, "r+b") as f:
            f.truncate(good_end)
            f.flush()
            os.fsync(f.fileno())

    def scrub(self, pace_s: float = 0.0, chunk: int = 16) -> dict:
        """Re-verify every on-disk record (background scrubber hook).
        A bad record found while live is self-healed: the tail is
        quarantined as evidence and the log is rewritten from the
        authoritative in-memory state (same rewrite as
        ``truncate_committed``).

        The CRC walk runs on a byte snapshot OUTSIDE the lock — a
        background scrub must never stall ingest (or hold the GIL) for
        a whole-log parse. ``pace_s`` > 0 additionally sleeps every
        *chunk* records so serving threads interleave. Records appended
        after the snapshot are untouched by the heal: the rewrite
        regenerates the log from the authoritative in-memory state."""
        with self._lock:
            try:
                with open(self._path, "rb") as f:
                    data = f.read()
            except OSError:
                return {"records": 0, "bad": 0}
        records = bad = 0
        first_bad = None
        off = 0
        for line in data.splitlines(keepends=True):
            raw = line.decode("utf-8", errors="replace").strip()
            if raw:
                records += 1
                if _parse_record(raw) is None:
                    bad += 1
                    if first_bad is None:
                        first_bad = off
                if pace_s > 0 and chunk > 0 and records % chunk == 0:
                    time.sleep(pace_s)
            off += len(line)
        if bad:
            with self._lock:
                evidence = self._path + f".tail-{first_bad}"
                try:
                    with open(evidence, "wb") as f:
                        f.write(data[first_bad:])
                    self.quarantine.quarantine(
                        evidence, "wal_record",
                        f"scrub found {bad} bad record(s)",
                        docs=[], data_loss=False)
                except OSError:
                    pass
                report_corruption("wal_record", "wal")
                REGISTRY.counter("wal_truncated_records").inc(bad)
                self.truncated_records += bad
                self._truncate_locked()
        return {"records": records, "bad": bad}

    def state(self, txn: int) -> Optional[str]:
        return self._state.get(txn)

    def payload(self, txn: int) -> dict:
        return self._payload.get(txn, {})

    def pending(self) -> list[tuple[int, str, dict]]:
        """Transactions that began but never reached COMMIT/ABORT, oldest
        first: [(txn, last_state, payload)]."""
        return [(t, s, self._payload.get(t, {}))
                for t, s in sorted(self._state.items()) if s not in _TERMINAL]

    def truncate_committed(self) -> None:
        """Compaction: rewrite the log keeping only non-terminal txns
        (periodic reconciliation housekeeping)."""
        with self._lock:
            self._truncate_locked()

    def _truncate_locked(self) -> None:
        keep = {t for t, s in self._state.items() if s not in _TERMINAL}
        tmp = self._path + ".compact"
        with open(tmp, "w") as f:
            for t in sorted(keep):
                rec = {"txn": t, "state": self._state[t], "op": "?",
                       "payload": self._payload.get(t, {}), "ts": 0}
                rec["crc"] = _record_crc(rec)
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)
        self._state = {t: self._state[t] for t in keep}
        self._payload = {t: self._payload.get(t, {}) for t in keep}
