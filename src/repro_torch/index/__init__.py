"""Segmented streaming vector index (DESIGN.md §7).

LSM-style layout for the hot tier: a small mutable memtable absorbs
streaming writes and is searched exactly; immutable IVF-partitioned base
segments hold the bulk of the corpus and are searched sub-linearly; a
deterministic size-tiered compactor seals/merges segments and purges
tombstones; an atomic manifest makes the on-disk segment set crash-safe.
"""
from .compaction import CompactionStats, SizeTieredCompactor
from .lsm import CompactionInterrupted, SegmentedIndex
from .manifest import Manifest
from .memtable import Memtable
from .segment import Segment

__all__ = ["CompactionInterrupted", "CompactionStats", "Manifest",
           "Memtable", "Segment", "SegmentedIndex", "SizeTieredCompactor"]
