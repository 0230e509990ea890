"""Shared datatypes for the LiveVectorLake core.

These mirror the paper's schema (§III-C):

hot tier row:  {chunk_id, embedding, doc_id, position, valid_from, status, content}
cold tier row: hot row + {valid_to, version_number, parent_hash}
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Sentinel for "still valid" (valid_to = NULL in the paper). Using int64 max
# keeps validity filtering branch-free: valid_from <= ts < valid_to.
VALID_TO_OPEN: int = np.iinfo(np.int64).max

STATUS_ACTIVE = "active"
STATUS_SUPERSEDED = "superseded"
STATUS_DELETED = "deleted"


def pad_queries(queries: np.ndarray) -> tuple[np.ndarray, int]:
    """(Q, d) float32 query block padded to >= 2 rows, plus the real Q.

    Single-row products take a different (bit-inequivalent) BLAS/kernel
    path than multi-row ones; the batched engine guarantees a query
    scores identically alone or inside any batch, so every scoring path
    pads Q=1 to 2 (zero row) and slices the result back to Q rows."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    nq = q.shape[0]
    if nq >= 2:
        return q, nq
    return np.concatenate(
        [q, np.zeros((2 - nq, q.shape[1]), np.float32)]), nq


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A semantic chunk produced by the chunker (paper §III-A1).

    ``chunk_id`` is the SHA-256 content address of the normalized text
    (paper eq. 1) — identity IS content.
    """

    text: str
    position: int           # paragraph index in the source document
    chunk_id: str           # sha256 hex of normalize(text)
    kind: str = "para"      # para | code | table | list (atomic kinds)


@dataclasses.dataclass
class ChunkRecord:
    """A versioned chunk row. This is the cold-tier record; the hot tier
    stores the subset of fields it needs for active chunks."""

    chunk_id: str
    doc_id: str
    position: int
    valid_from: int                      # unix microseconds
    valid_to: int = VALID_TO_OPEN        # open interval end (exclusive)
    version: int = 0                     # monotonic per-store commit number
    parent_hash: Optional[str] = None    # hash of chunk this one superseded
    status: str = STATUS_ACTIVE
    text: str = ""
    embedding: Optional[np.ndarray] = None
    tenant: str = ""                     # tenant namespace ("" = default)
    # dense registry id for ``tenant``, resolved by the owning store's
    # TenantRegistry before the record reaches any tier; persisted
    # columns carry this id, cross-shard transfers carry the name
    tenant_id: int = 0

    @property
    def key(self) -> str:
        """Identity of the *logical slot* a record occupies: one live record
        per (doc, position) at any instant."""
        return f"{self.doc_id}@{self.position}"


@dataclasses.dataclass
class ChangeSet:
    """Output of CDC classification (paper §III-A3)."""

    new: list[Chunk] = dataclasses.field(default_factory=list)
    modified: list[Chunk] = dataclasses.field(default_factory=list)
    # (position, hash) pairs present in the old version but absent now.
    deleted: list[tuple[int, str]] = dataclasses.field(default_factory=list)
    unchanged: list[Chunk] = dataclasses.field(default_factory=list)
    # Same content hash, new position: metadata-only update, NO re-embedding.
    moved: list[tuple[Chunk, int]] = dataclasses.field(default_factory=list)  # (chunk, old_position)

    @property
    def to_embed(self) -> list[Chunk]:
        """Chunks whose content is new to this document — the paper's O(dC)."""
        return self.new + self.modified

    @property
    def n_total(self) -> int:
        return (len(self.new) + len(self.modified) + len(self.unchanged)
                + len(self.moved))

    @property
    def n_changed(self) -> int:
        return len(self.new) + len(self.modified)

    @property
    def reprocess_fraction(self) -> float:
        """Fraction of current-version content that needs (re)embedding —
        the paper's headline 10-15% metric."""
        n = self.n_total
        return (self.n_changed / n) if n else 0.0


@dataclasses.dataclass
class CDCSummary:
    """Returned by ``LiveVectorLake.ingest`` (paper §IV-B)."""

    doc_id: str
    version: int
    ts: int
    n_new: int
    n_modified: int
    n_deleted: int
    n_unchanged: int
    n_moved: int
    n_embedded: int           # embeddings actually computed (after dedup)
    n_dedup_hits: int         # embeddings reused from the content-address cache
    reprocess_fraction: float

    @property
    def n_total(self) -> int:
        return self.n_new + self.n_modified + self.n_unchanged + self.n_moved


@dataclasses.dataclass
class SearchResult:
    chunk_id: str
    doc_id: str
    position: int
    score: float
    text: str
    valid_from: int
    valid_to: int = VALID_TO_OPEN
    version: int = 0
    tier: str = "hot"         # which tier answered (hot | cold)
    tenant: str = ""          # tenant namespace of the returned row
