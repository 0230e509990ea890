"""Chunk-level change detection (paper §III-A3).

Classification of each chunk in the NEW version against the stored hash
list of the PREVIOUS version:

  - Unchanged: same hash at same position
  - Moved:     hash present in previous version at a different position
               (content identical => no re-embedding; metadata-only update)
  - Modified:  different hash at a position that existed before
  - New:       hash not in previous version at a position beyond the old doc
  - Deleted:   old hash absent from the new version

Hash equality is content equality (SHA-256), so this is deterministic:
100% precision / recall for exact content matching (paper §V-B3).
"""
from __future__ import annotations

import dataclasses
from collections import Counter

from .types import (STATUS_DELETED, STATUS_SUPERSEDED, VALID_TO_OPEN,
                    ChangeSet, Chunk, ChunkRecord)


def detect_changes(new_chunks: list[Chunk], old_hashes: list[str]) -> ChangeSet:
    cs = ChangeSet()
    old_multiset = Counter(old_hashes)
    # position of each old hash (first occurrence wins for 'moved' lookup)
    old_pos: dict[str, int] = {}
    for p, h in enumerate(old_hashes):
        old_pos.setdefault(h, p)

    consumed: Counter = Counter()    # old-content occurrences surviving in new
    superseded: set[int] = set()     # old positions replaced by a modification
    for chunk in new_chunks:
        p, h = chunk.position, chunk.chunk_id
        if p < len(old_hashes) and old_hashes[p] == h:
            cs.unchanged.append(chunk)
            consumed[h] += 1
        elif consumed[h] < old_multiset[h]:
            # content existed in the previous version, at another position
            cs.moved.append((chunk, old_pos[h]))
            consumed[h] += 1
        elif p < len(old_hashes):
            cs.modified.append(chunk)
            superseded.add(p)
        else:
            cs.new.append(chunk)

    # Deleted = old content occurrences that neither survive (unchanged /
    # moved) nor were superseded in place by a modification.
    budget = Counter(consumed)
    for p, h in enumerate(old_hashes):
        if p in superseded:
            continue
        if budget[h] > 0:
            budget[h] -= 1
        else:
            cs.deleted.append((p, h))
    return cs


def positional_diff(new_chunks: list[Chunk], old_hashes: list[str]
                    ) -> tuple[list[int], list[int]]:
    """Storage-level actions derived from the positional diff.

    Returns (close_positions, append_positions):
      - close:  old (doc, position) records whose content is replaced or gone
      - append: new-version positions needing a fresh record

    CDC classes decide *embedding work*; this decides *tier writes*. One
    live record per (doc, position) is the storage invariant.
    """
    n_old, n_new = len(old_hashes), len(new_chunks)
    close, append = [], []
    for p in range(max(n_old, n_new)):
        old_h = old_hashes[p] if p < n_old else None
        new_h = new_chunks[p].chunk_id if p < n_new else None
        if old_h == new_h:
            continue
        if old_h is not None:
            close.append(p)
        if new_h is not None:
            append.append(p)
    return close, append


@dataclasses.dataclass
class HistoryEvent:
    """One commit's worth of a single document's history, reconstructed
    from its validity intervals (the inverse of the ingest CDC diff)."""

    ts: int                          # commit instant (valid_from / closed_at)
    records: list[ChunkRecord]       # rows opened at ts
    closures: list[dict]             # rows closed at ts
    hashes_after: list[str]          # position-ordered live hashes after ts


def history_to_events(rows: list[ChunkRecord]) -> list[HistoryEvent]:
    """Re-derive the per-commit CDC delta stream of ONE document from its
    full-history rows (every version, open and closed).

    A row ``[valid_from, valid_to)`` contributes an open event at
    ``valid_from`` and — when closed — a closure event at ``valid_to``.
    Replaying the returned events in order through ``ColdTier.commit``
    reproduces the document's exact validity intervals on another shard:
    this is how migration moves a doc WITHOUT changing temporal
    semantics (DESIGN.md §10.4). ``hashes_after`` is the hash-store
    entry the CDC layer needs after each event, so a migrated doc diffs
    future ingests identically to the source.
    """
    instants: set[int] = set()
    for r in rows:
        instants.add(int(r.valid_from))
        if r.valid_to != VALID_TO_OPEN:
            instants.add(int(r.valid_to))
    events: list[HistoryEvent] = []
    live: dict[int, str] = {}        # position -> chunk hash
    for ts in sorted(instants):
        opened = sorted((r for r in rows if int(r.valid_from) == ts),
                        key=lambda r: r.position)
        closed = sorted((r for r in rows
                         if r.valid_to != VALID_TO_OPEN
                         and int(r.valid_to) == ts),
                        key=lambda r: r.position)
        opened_pos = {r.position for r in opened}
        closures = [{"doc_id": r.doc_id, "position": r.position,
                     "closed_at": ts,
                     "status": (STATUS_SUPERSEDED if r.position in opened_pos
                                else STATUS_DELETED)}
                    for r in closed]
        for c in closures:
            if c["status"] == STATUS_DELETED:
                live.pop(c["position"], None)
        for r in opened:
            live[r.position] = r.chunk_id
        events.append(HistoryEvent(
            ts=ts, records=opened, closures=closures,
            hashes_after=[live[p] for p in sorted(live)]))
    return events
