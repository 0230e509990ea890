"""Deterministic size-tiered compaction policy (DESIGN.md §7.3).

Seals and merges are triggered by the write path itself (insert volume),
never by wall-clock or threads, so every run over the same update stream
produces byte-identical segment layouts — a property the fault-tolerance
tests and the shard-ready design both rely on. Two rules, checked in
order after every write batch:

  1. size-tiered merge: segments are bucketed by
     floor(log_fanout(alive rows)); when a bucket reaches ``fanout``
     members, the oldest ``fanout`` are merged into one segment of the
     next tier (classic Cassandra/RocksDB STCS — write amplification
     O(log_fanout N) per row). The tier base follows ``fanout`` so a
     merge of ``fanout`` same-tier segments always lands in a HIGHER
     tier and cannot re-merge with its own inputs' peers forever.
  2. tombstone purge: a segment more than half dead is rewritten alone,
     dropping its tombstoned rows.

``CompactionStats`` tracks write amplification (segment rows written per
row ingested) and is surfaced through ``LiveVectorLake.stats()``.
"""
from __future__ import annotations

import dataclasses

from .segment import Segment


@dataclasses.dataclass
class CompactionStats:
    rows_ingested: int = 0      # rows entering the index (inserts)
    rows_written: int = 0       # rows written into segments (seal + merge)
    seals: int = 0
    merges: int = 0
    tombstones_purged: int = 0

    @property
    def write_amplification(self) -> float:
        return self.rows_written / max(self.rows_ingested, 1)

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "write_amplification": self.write_amplification}


def _tier(n_alive: int, base: int = 4) -> int:
    """Size tier = floor(log_base(n_alive)): with base=4 that is 0 for
    <4 rows, 1 for 4-15, 2 for 16-63, ..."""
    t = 0
    while n_alive >= base:
        n_alive //= base
        t += 1
    return t


class SizeTieredCompactor:
    def __init__(self, fanout: int = 4, purge_min_rows: int = 64):
        assert fanout >= 2
        self.fanout = fanout
        self.purge_min_rows = purge_min_rows

    def pick(self, segments: list[Segment]) -> list[Segment]:
        """Next merge set, oldest-first (deterministic), or [] when the
        layout is stable. Callers loop until []."""
        by_tier: dict[int, list[Segment]] = {}
        for s in segments:                     # insertion order == seal order
            by_tier.setdefault(_tier(s.n_alive, self.fanout), []).append(s)
        for t in sorted(by_tier):
            if len(by_tier[t]) >= self.fanout:
                return by_tier[t][: self.fanout]
        for s in segments:                     # tombstone-heavy rewrite
            if len(s) >= self.purge_min_rows and s.n_alive * 2 < len(s):
                return [s]
        return []
