"""Mutable write buffer of the segmented index (DESIGN.md §7.1).

The memtable is the only mutable structure on the write path: streaming
inserts/overwrites/deletes land here in O(1) slot operations, and reads
run the exact fused top-k kernel over the slot array (the same
kernels/topk_search path the flat hot tier used). When full it is sealed
into an immutable base segment by the compactor — the memtable itself
never grows, so the exact-scan cost on the query path stays bounded by
``capacity`` regardless of corpus size.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.types import ChunkRecord
from .quant import fixed_scale, quantize_rows


class Memtable:
    """``quantized=True`` additionally maintains an int8 mirror of the
    slot array under the FIXED 1/127 scale (embeddings are L2-normalized
    so the fixed scale is always valid, and a mutable buffer cannot use
    a data-dependent scale without re-quantizing every row on every
    write): the fused scan block streams the int8 mirror, the fp32 slot
    array stays resident as the exact-rescore source and seal input —
    the memtable is capacity-bounded, so its fp32 cost never grows with
    the corpus (DESIGN.md §11)."""

    def __init__(self, dim: int, capacity: int = 4096,
                 quantized: bool = False):
        self.dim = dim
        self.capacity = capacity
        self.quantized = bool(quantized)
        self._emb = np.zeros((capacity, dim), np.float32)
        self._q8 = (np.zeros((capacity, dim), np.int8) if quantized
                    else None)
        self._qscale = fixed_scale(dim) if quantized else None
        self._active = np.zeros(capacity, bool)
        self._valid_from = np.zeros(capacity, np.int64)
        self._positions = np.zeros(capacity, np.int64)
        self._tenants = np.zeros(capacity, np.int32)
        self._chunk_ids: list[Optional[str]] = [None] * capacity
        self._doc_ids: list[Optional[str]] = [None] * capacity
        self._texts: list[str] = [""] * capacity
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        # per-slot write generation: bumped on EVERY content change
        # (put/overwrite/remove). The off-lock seal snapshots (slot, gen)
        # pairs so its publish step can tell "slot still holds the row I
        # sealed" from "slot was rewritten while I built" — even when the
        # rewrite re-used the same key (DESIGN.md §14 two-phase seal).
        self._gen = np.zeros(capacity, np.int64)

    def __len__(self) -> int:
        return self.capacity - len(self._free)

    @property
    def full(self) -> bool:
        return not self._free

    # -- writes ----------------------------------------------------------
    def put(self, r: ChunkRecord) -> int:
        """Claim a free slot for a new row. Caller seals before putting
        into a full memtable."""
        assert self._free, "memtable full — seal first"
        slot = self._free.pop()
        self._write(slot, r)
        return slot

    def overwrite(self, slot: int, r: ChunkRecord) -> None:
        """In-place update of a live slot (same (doc, position) key)."""
        assert self._active[slot], slot
        self._write(slot, r)

    def _write(self, slot: int, r: ChunkRecord) -> None:
        self._emb[slot] = np.asarray(r.embedding, np.float32)
        if self._q8 is not None:
            self._q8[slot] = quantize_rows(self._emb[slot][None],
                                           self._qscale)[0]
        self._active[slot] = True
        self._valid_from[slot] = r.valid_from
        self._positions[slot] = r.position
        self._tenants[slot] = r.tenant_id
        self._chunk_ids[slot] = r.chunk_id
        self._doc_ids[slot] = r.doc_id
        self._texts[slot] = r.text
        self._gen[slot] += 1

    def remove(self, slot: int) -> None:
        self._active[slot] = False
        self._emb[slot] = 0.0
        if self._q8 is not None:
            self._q8[slot] = 0
        self._tenants[slot] = 0
        self._chunk_ids[slot] = None
        self._doc_ids[slot] = None
        self._texts[slot] = ""
        self._free.append(slot)
        self._gen[slot] += 1

    def reset(self) -> None:
        # swap in FRESH arrays instead of zeroing in place: any reader
        # holding references from before a (background) seal keeps seeing
        # the pre-seal rows, never a zeroed-under-it column
        self._emb = np.zeros((self.capacity, self.dim), np.float32)
        if self._q8 is not None:
            self._q8 = np.zeros((self.capacity, self.dim), np.int8)
        self._active = np.zeros(self.capacity, bool)
        self._valid_from = np.zeros(self.capacity, np.int64)
        self._positions = np.zeros(self.capacity, np.int64)
        self._tenants = np.zeros(self.capacity, np.int32)
        self._chunk_ids = [None] * self.capacity
        self._doc_ids = [None] * self.capacity
        self._texts = [""] * self.capacity
        self._free = list(range(self.capacity - 1, -1, -1))
        # generations survive reset monotonically: a snapshot taken
        # before the reset must not see a recycled slot as "unchanged"
        self._gen = self._gen + 1

    # -- reads ------------------------------------------------------------
    # (Queries never hit the memtable directly: SegmentedIndex.search
    # scans the slot array through its fused small-source block.)
    def extract(self) -> dict:
        """Columnar copy of the live rows (seal input), in slot order, plus
        their (doc_id, position) keys. Non-destructive: also carries each
        row's (slot, generation) so the two-phase seal can detect
        concurrent rewrites at publish time."""
        sel = np.nonzero(self._active)[0]
        return {
            "emb": self._emb[sel].copy(),
            "valid_from": self._valid_from[sel].copy(),
            "positions": self._positions[sel].copy(),
            "tenant_ids": self._tenants[sel].copy(),
            "chunk_ids": [self._chunk_ids[i] or "" for i in sel],
            "doc_ids": [self._doc_ids[i] or "" for i in sel],
            "texts": [self._texts[i] for i in sel],
            "keys": [(self._doc_ids[i] or "", int(self._positions[i]))
                     for i in sel],
            "slots": sel.copy(),
            "gens": self._gen[sel].copy(),
        }

    def nbytes(self) -> int:
        """Resident embedding bytes: the fp32 slot array plus, when
        quantized, the int8 mirror the fused scan actually streams."""
        n = int(self._emb.nbytes)
        if self._q8 is not None:
            n += int(self._q8.nbytes) + int(self._qscale.nbytes)
        return n
