"""Hot tier: latency-optimized vector index over ACTIVE chunks only
(paper §III-C1).

TPU-native adaptation (DESIGN.md §2, §7): the paper uses Milvus+HNSW;
graph ANN is pointer-chasing and hostile to the MXU, so the hot tier is
backed by the LSM-style segmented index (index.SegmentedIndex): a
small mutable memtable absorbs streaming writes and is exact-scanned by
the fused top-k kernel (kernels/topk_search); immutable IVF-partitioned
base segments serve the bulk of the corpus sub-linearly (centroid
routing, nprobe partitions — dense MXU matmuls, no pointer chasing); a
deterministic size-tiered compactor seals/merges segments off the query
path. Per-query results are combined by a k-candidate top-k merge — the
same merge a shard_map fan-out feeds (every device scores its segments;
the global merge is tiny).

Write semantics match the paper: new chunk => insert; modified => old row
tombstoned + new row inserted; deleted => tombstone. Only chunks with
valid_to = OPEN live here; history belongs to the cold tier. The hot tier
persists its segment set via an atomic manifest, but remains a *cache* of
the cold tier's current snapshot: recovery reconciles every segment row
against the cold snapshot and re-inserts only the delta (fault
tolerance — see ``LiveVectorLake.recover``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..index.lsm import SegmentedIndex
from .types import ChunkRecord, SearchResult


class HotTier:
    def __init__(self, dim: int, capacity: int = 4096,
                 root: Optional[str] = None, wal=None, nprobe: int = 8,
                 ivf_min_rows: int = 1024, quantized: bool = False,
                 rescore_factor: int = 4, device=None):
        """``device``: where the exact scans run (None = the CUDA
        device; raises without one — pass "cpu" for the plain path)."""
        self.dim = dim
        self._mem_capacity = capacity
        self.index = SegmentedIndex(dim, mem_capacity=capacity, root=root,
                                    wal=wal, nprobe=nprobe,
                                    ivf_min_rows=ivf_min_rows,
                                    quantized=quantized,
                                    rescore_factor=rescore_factor,
                                    device=device)
        self.device = self.index.device

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.index)

    @property
    def capacity(self) -> int:
        """Total addressable slots (memtable capacity + sealed rows) —
        grows as segments are sealed, never shrinks below the memtable."""
        return self.index.capacity

    @property
    def _by_key(self) -> dict:
        """Key -> location map (memtable slot int | (seg_id, row))."""
        return self.index._by_key

    @property
    def _emb(self) -> np.ndarray:
        """Memtable slot array (memtable-resident keys only)."""
        return self.index.mem._emb

    def doc_keys(self, doc_id: str) -> list[tuple[str, int]]:
        """Snapshot of one document's live keys, taken under the index
        lock so a background compaction can't mutate the map mid-scan."""
        with self.index._lock:
            return [k for k in self.index._by_key if k[0] == doc_id]

    # -- writes ----------------------------------------------------------
    def insert(self, records: Sequence[ChunkRecord]) -> None:
        self.index.insert(records)

    def delete(self, keys: Sequence[tuple[str, int]]) -> int:
        return self.index.delete(keys)

    def clear(self) -> None:
        """Explicit reset of the engine state (NOT ``__init__`` re-entry,
        so the segmented index and its on-disk manifest are reset through
        their own code path and nothing is silently dropped)."""
        self.index.reset(drop_disk=True)

    # -- reads ------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int = 5,
               visible: Optional[np.ndarray] = None
               ) -> list[list[SearchResult]]:
        """Top-k cosine search over active chunks (queries and corpus are
        expected L2-normalized => dot == cosine). Exact over the memtable,
        nprobe-routed over base segments, merged. ``visible`` is the
        resolved visible-tenant-id array (None = unscoped), enforced
        pre-ranking inside the index's scan kernels."""
        return self.index.search(queries, k=k, visible=visible)

    # -- recovery ----------------------------------------------------------
    def rebuild(self, records: Sequence[ChunkRecord]) -> dict:
        """Restore from the persisted segment set, reconciled against the
        authoritative cold-tier records; inserts only the delta."""
        return self.index.rebuild(records)

    # -- introspection ------------------------------------------------------
    def active_embeddings(self) -> np.ndarray:
        return self.index.active_embeddings()

    def stats(self) -> dict:
        return {"active": len(self.index), "capacity": self.capacity,
                "bytes": self.index.nbytes(), "index": self.index.stats()}
