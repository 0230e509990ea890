"""SegmentedIndex: LSM-style orchestration of memtable + base segments
(DESIGN.md §7).

Write path: inserts land in the memtable (O(1)); when it fills, it is
SEALED into an immutable IVF-partitioned segment and the deterministic
size-tiered compactor merges segments / purges tombstones. The write
path never rebuilds the whole index — queries stay servable during
compaction because the old segment set remains live until one atomic
manifest publish swaps in the merged result.

Read path (batched, array-native — DESIGN.md §8): a (Q, d) query block
runs exactly over the memtable PLUS every small segment in one fused
top-k kernel dispatch, and sub-linearly over each IVF segment (batched
centroid routing, nprobe partitions); per-source (Q, k) score/row blocks
are mapped to global row ids and merged by one stable top-k over the
concatenated (Q, n_sources*k) candidate matrix. The same merge serves a
future shard_map fan-out: a shard is just another candidate source
(DESIGN.md §7.5).

QUANTIZED read path (``quantized=True`` — DESIGN.md §11): every scan
streams int8 instead of fp32 — the fused block scans the memtable's int8
mirror + small segments' int8 rows under the fixed 1/127 scale, IVF
member scans gather int8 — and each source over-fetches a candidate pool
(k' = rescore_factor*k) that is exactly rescored in fp32 (memtable slots
from the resident slot array, segment rows through the mmap winners-row
cache) BEFORE the global merge, so merged scores are fp32-exact and the
fp32 path remains the oracle the recall gates compare against.

Consistency: ``_by_key`` maps every live (doc_id, position) to exactly
one location — a memtable slot (int) or a (seg_id, row) pair. Inserting
over a key that lives in a segment tombstones the old row; the merge
drops any candidate whose location is no longer the key's authority, so
a query can never return two versions of one logical slot.

Durability: segment files + atomic manifest under ``root`` (optional);
seal/merge transactions are bracketed in the store's WAL. ``rebuild()``
restores segments from the manifest and re-inserts only the delta.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core.integrity import CorruptionError, Quarantine
from ..core.tenancy import visible_rows
from ..core.types import (ChunkRecord, SearchResult, VALID_TO_OPEN,
                          pad_queries)
from ..kernels.common import resolve_device
from ..testing.faults import FAULTS
from .compaction import CompactionStats, SizeTieredCompactor
from .manifest import Manifest
from .memtable import Memtable
from .quant import fixed_scale, pool_k, rescore_topk
from .segment import Segment


class CompactionInterrupted(RuntimeError):
    """Raised by the fault-injection hook to simulate a crash mid-seal or
    mid-compaction (tests only)."""


def merge_topk_candidates(scores: np.ndarray, gids: np.ndarray,
                          authority: np.ndarray, k: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Array-native top-k merge over the concatenated per-source candidate
    matrix (DESIGN.md §8).

    ``scores``/``gids``: (Q, W) blocks from every source side by side
    (W = sum of per-source k). ``authority`` is the concatenated
    per-source authority row-array over the global row-id space: bit g is
    set iff the index's ``_by_key`` maps row g's key to exactly row g —
    so the per-candidate dict lookup of the old tuple-sort merge becomes
    ONE vectorized gather. A 2-D ``authority`` is taken as an explicit
    per-candidate (Q, W) mask instead (the shard planner's ownership +
    replica-dedup bits vary per query, not per global row). Returns
    (top_s, top_g), both (Q, k); losers and empty slots are (-inf, -1).

    Ordering matches the old stable tuple sort exactly: descending score,
    ties broken by candidate column (i.e. source order, then the
    source's own rank order).

    INVARIANT (audited, regression-tested in tests/test_tenant_isolation
    .py): ``gids >= 0`` is folded into ``valid`` BEFORE any authority
    gather. The ``np.clip(gids, 0, None)`` below aliases every padding
    row (gid -1) onto global row 0, so a padding candidate reads row 0's
    authority — and, now that authority carries tenant visibility bits,
    row 0's tenant bit. The pre-applied ``gids >= 0`` term guarantees
    those aliased reads can never validate a padding slot; any new mask
    gather added to this function must keep that ordering.
    """
    valid = np.isfinite(scores) & (gids >= 0)
    authority = np.asarray(authority, bool)
    if authority.ndim == 2:
        # 2-D explicit per-candidate mask: no gather happens, but the
        # (gids >= 0) term above still rejects padding rows even when a
        # caller hands an all-True column for them
        valid &= authority
    else:
        valid &= authority[np.clip(gids, 0, None)]
    s = np.where(valid, scores, -np.inf).astype(np.float32)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    top_s = np.take_along_axis(s, order, axis=1)
    top_g = np.where(np.isfinite(top_s),
                     np.take_along_axis(np.asarray(gids), order, axis=1), -1)
    if top_s.shape[1] < k:                       # fewer candidates than k
        pad = k - top_s.shape[1]
        top_s = np.pad(top_s, ((0, 0), (0, pad)),
                       constant_values=-np.inf)
        top_g = np.pad(top_g, ((0, 0), (0, pad)), constant_values=-1)
    return top_s, top_g


@dataclasses.dataclass
class _Catalog:
    """Immutable-until-structural-change view of the source set.

    Global row-id space: memtable slots occupy [0, mem_capacity); each
    segment (in seal order) occupies [start, start + len). ``fused_emb``
    concatenates the memtable slot array with every small (non-IVF)
    segment so they are scanned by ONE fused top-k dispatch instead of a
    dispatch per source; ``fused_gids`` maps fused-local rows back to
    global ids. ``fused_emb`` lives on the index's device and stays
    resident across queries until the segment set changes; it is always
    a copy, so every memtable write is mirrored into it (``_mirror``).
    ``mirrored`` says whether small segments are fused behind the
    memtable. Quantized
    catalogs fuse the int8 mirrors instead (``fused_emb`` is int8 under
    the fixed scale) and carry ``fused_f32``, the fused-local exact-row
    fetch used by the rescore, plus per-column result gathers
    (``seg_cols``) for the vectorized result build."""

    segs: list                    # all segments, seal order
    seg_starts: np.ndarray        # (n_segs,) global row-id base per segment
    ivf: list                     # [(segment, base)] for IVF-partitioned
    small: list                   # [(segment, base)] for exact-scan
    solo: list                    # [(segment, base)] scanned individually
    fused_emb: torch.Tensor       # (mem_capacity + small rows, d) f32|int8
    fused_gids: np.ndarray        # fused-local row -> global row id
    mirrored: bool
    fused_f32: Optional[Callable] = None   # fused-local rows -> exact fp32
    seg_cols: Optional[dict] = None        # vectorized result columns


class SegmentedIndex:
    def __init__(self, dim: int, mem_capacity: int = 4096,
                 root: Optional[str] = None, wal=None, nprobe: int = 8,
                 ivf_min_rows: int = 1024, fanout: int = 4, seed: int = 0,
                 quantized: bool = False, rescore_factor: int = 4,
                 device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self.root = root
        self.wal = wal
        self.nprobe = nprobe
        self.ivf_min_rows = ivf_min_rows
        self.seed = seed
        self.quantized = bool(quantized)
        self.rescore_factor = int(rescore_factor)
        self.mem = Memtable(dim, mem_capacity, quantized=self.quantized)
        self.segments: dict[str, Segment] = {}     # insertion == seal order
        self.compactor = SizeTieredCompactor(fanout=fanout)
        self.cstats = CompactionStats()
        self.manifest = Manifest(root) if root else None
        self.quarantine = Quarantine(root, "hot") if root else None
        # key -> memtable slot (int) | (seg_id, row)
        self._by_key: dict[tuple[str, int], object] = {}
        self._seg_meta: dict[str, tuple[str, str]] = {}  # id -> (file, sha)
        self._cat: Optional[_Catalog] = None   # read-path source catalog
        self._seq = 0
        self._scan_scanned = 0
        self._scan_denom = 0
        self.fail_at: Optional[str] = None     # e.g. "seal:before_manifest"
        # Concurrency (DESIGN.md §13): one reentrant lock serializes every
        # structural mutation AND the read snapshot. Maintenance stays off
        # the query path by doing the EXPENSIVE work (merged-segment build,
        # k-means, file writes) outside the lock — only the atomic publish
        # and the memtable seal hold it.
        self._lock = threading.RLock()
        # When True, the inline write path never compacts; it signals the
        # maintenance hook ("seal"/"compact") and a background worker
        # drives seal_if_above()/compact_once() instead.
        self.deferred_compaction = False
        self.seal_watermark = 0.75             # fill fraction to wish a seal
        self.maintenance_hook: Optional[Callable[[str], None]] = None
        # optional tid -> tenant-name resolver (set by the owning store's
        # TenantRegistry) so results carry the tenant NAME; bare indexes
        # leave results on the default tenant ""
        self.tenant_namer: Optional[Callable[[int], str]] = None

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._by_key)

    @property
    def capacity(self) -> int:
        """Total row slots: memtable capacity + sealed segment rows."""
        return self.mem.capacity + sum(len(s) for s in self.segments.values())

    def nbytes(self) -> int:
        """RESIDENT embedding bytes (what scans + rescores pin in RAM —
        quantized segments count int8 + scale + winners cache, not the
        on-disk fp32 sidecar)."""
        return self.mem.nbytes() + sum(s.emb_nbytes()
                                       for s in self.segments.values())

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def insert(self, records: Sequence[ChunkRecord]) -> None:
        wishes: list[str] = []
        with self._lock:
            for r in records:
                key = (r.doc_id, r.position)
                loc = self._by_key.get(key)
                if isinstance(loc, int):           # live in memtable: in-place
                    self.mem.overwrite(loc, r)
                    self._mirror(loc)
                else:
                    if loc is not None:            # live in a segment: shadow
                        seg_id, row = loc
                        self.segments[seg_id].kill(row)
                    if self.mem.full:
                        self.seal()
                    slot = self.mem.put(r)
                    self._by_key[key] = slot
                    self._mirror(slot)
                self.cstats.rows_ingested += 1
            if self.deferred_compaction:
                if len(self.mem) >= self._watermark_rows():
                    wishes.append("seal")
                if self.compactor.pick(list(self.segments.values())):
                    wishes.append("compact")
                # every write ticks the hook so cadence-based jobs
                # (cold checkpoints) can fire without a seal wish
                wishes.append("tick")
            else:
                self.maybe_compact()
        hook = self.maintenance_hook
        if hook is not None:
            for w in wishes:
                hook(w)

    def _mirror(self, slot: int) -> None:
        """Keep the fused scan block's memtable rows in sync: the block is
        a device copy, so every memtable write lands in it too (a missed
        write would serve stale vectors to current queries)."""
        if self._cat is not None:
            row = (self.mem._q8[slot] if self.quantized
                   else self.mem._emb[slot])
            self._cat.fused_emb[slot] = torch.as_tensor(row)

    def delete(self, keys: Sequence[tuple[str, int]]) -> int:
        n = 0
        wish = False
        with self._lock:
            for key in keys:
                loc = self._by_key.pop(key, None)
                if loc is None:
                    continue
                if isinstance(loc, int):
                    self.mem.remove(loc)
                    self._mirror(loc)
                else:
                    seg_id, row = loc
                    self.segments[seg_id].kill(row)
                n += 1
            if n:
                if self.deferred_compaction:
                    wish = bool(self.compactor.pick(
                        list(self.segments.values())))
                else:
                    self.maybe_compact()     # delete-heavy streams purge too
        if wish and self.maintenance_hook is not None:
            self.maintenance_hook("compact")
        return n

    # ------------------------------------------------------------------
    # seal + compaction
    # ------------------------------------------------------------------
    def _next_id(self) -> str:
        self._seq += 1
        return f"{self._seq:08d}"

    def _new_segment(self, seg_id: str, emb, valid_from, positions,
                     chunk_ids, doc_ids, texts, ivf_state=None,
                     tenant_ids=None) -> Segment:
        return Segment(seg_id, emb, valid_from, positions, chunk_ids,
                       doc_ids, texts, ivf_min_rows=self.ivf_min_rows,
                       seed=self.seed, quantized=self.quantized,
                       rescore_factor=self.rescore_factor,
                       ivf_state=ivf_state, tenant_ids=tenant_ids,
                       device=self.device)

    def seal(self) -> Optional[Segment]:
        """Freeze the memtable into a new base segment (IVF-partitioned at
        or above ivf_min_rows), publish it, and reset the memtable. Runs
        atomically under the index lock — the INLINE path for a full
        memtable mid-insert, where the caller already holds the lock and
        needs the slot free before it can continue. The background path
        is ``seal_if_above`` below, which keeps the expensive build off
        the lock entirely."""
        with self._lock:
            if len(self.mem) == 0:
                return None
            cols = self.mem.extract()
            seg = self._new_segment(self._next_id(), cols["emb"],
                                    cols["valid_from"], cols["positions"],
                                    cols["chunk_ids"], cols["doc_ids"],
                                    cols["texts"],
                                    tenant_ids=cols["tenant_ids"])
            self._commit_segments("seal", add=[seg], remove=[])
            self.segments[seg.seg_id] = seg
            self._cat = None
            for row, key in enumerate(cols["keys"]):
                self._by_key[key] = (seg.seg_id, row)
            self.mem.reset()
            self.cstats.rows_written += len(seg)
            self.cstats.seals += 1
            return seg

    def _watermark_rows(self) -> int:
        return max(1, int(self.seal_watermark * self.mem.capacity))

    def seal_if_above(self, frac: Optional[float] = None) -> bool:
        """Background-seal entry point (maintenance worker): seal only if
        the memtable fill has reached ``frac`` (default: the configured
        watermark). Returns True iff a segment was published.

        TWO-PHASE (the storm-p99 fix): the expensive part of a seal
        — k-means partitioning, quantization, the fsync'd file write —
        used to run inside ``seal()`` under the index lock, stalling
        every query behind it during churn. Here the lock is held only
        to (1) snapshot the live rows with their (slot, generation)
        pairs and (2) publish: the segment build + save run off-lock
        while queries keep serving from the memtable. At publish, a row
        survives only if its slot's generation is unchanged AND
        ``_by_key`` still maps its key to that slot — a row overwritten,
        deleted, or inline-sealed during the build is killed on arrival
        (same dead-on-arrival reconciliation as ``compact_once``), so
        the background seal can never resurrect stale data. Sealed slots
        are then freed individually (no blanket reset), keeping rows
        ingested mid-build live."""
        frac = self.seal_watermark if frac is None else frac
        with self._lock:
            if len(self.mem) < max(1, int(frac * self.mem.capacity)):
                return False
            cols = self.mem.extract()
            if not len(cols["slots"]):
                return False
            seg_id = self._next_id()
        # heavy build (quantize + k-means) and fsync'd save, OFF the lock
        seg = self._new_segment(seg_id, cols["emb"], cols["valid_from"],
                                cols["positions"], cols["chunk_ids"],
                                cols["doc_ids"], cols["texts"],
                                tenant_ids=cols["tenant_ids"])
        if self.manifest is not None:
            # pre-save: _commit_segments skips re-saving registered ids
            self._seg_meta[seg.seg_id] = seg.save(self.root)
        with self._lock:
            fresh = np.zeros(len(seg), bool)
            for row, (key, slot, gen) in enumerate(
                    zip(cols["keys"], cols["slots"], cols["gens"])):
                slot = int(slot)
                if (self.mem._gen[slot] == gen
                        and self._by_key.get(key) == slot):
                    fresh[row] = True
                else:
                    seg.kill(row)
            if not fresh.any():
                # every snapshotted row changed under us (e.g. an inline
                # seal already published them): abandon — the orphan
                # file is swept at the next manifest publish
                self._seg_meta.pop(seg.seg_id, None)
                return False
            self._commit_segments("seal", add=[seg], remove=[])
            self.segments[seg.seg_id] = seg
            self._cat = None
            for row in np.nonzero(fresh)[0]:
                key, slot = cols["keys"][row], int(cols["slots"][row])
                self._by_key[key] = (seg.seg_id, int(row))
                self.mem.remove(slot)
            self.cstats.rows_written += len(seg)
            self.cstats.seals += 1
            return True

    def maybe_compact(self) -> int:
        """Run the deterministic compactor to a fixed point; returns the
        number of merges performed. A no-op in deferred mode — the
        maintenance worker drives ``compact_once`` instead."""
        if self.deferred_compaction:
            return 0
        n = 0
        with self._lock:
            while True:
                victims = self.compactor.pick(list(self.segments.values()))
                if not victims:
                    return n
                self._merge(victims)
                n += 1

    def compact_once(self) -> bool:
        """One background-safe compaction round: victim pick + alive-row
        snapshot under the lock, the EXPENSIVE merged-segment build
        (fp32 fetch, re-quantize, k-means, file write) outside it so
        queries keep serving on the old segment set, then the atomic
        publish back under the lock. Returns True iff a merge was
        published — the worker calls it in a loop to reach the
        compactor's fixed point.

        Rows that die or move while the build runs off-lock are
        reconciled at publish: ``_publish_merge`` only re-points a key at
        the merged copy if ``_by_key`` still maps it to the exact victim
        row the build snapshotted; otherwise the merged copy is killed on
        arrival, so a concurrent delete/overwrite can never be
        resurrected by a background merge."""
        with self._lock:
            victims = self.compactor.pick(list(self.segments.values()))
            if not victims:
                return False
            keep = [(v, np.nonzero(v.alive)[0]) for v in victims]
            seg_id = self._next_id()
        merged = self._build_merged(keep, seg_id)     # heavy, off-lock
        if merged is not None and self.manifest is not None:
            # file write off-lock too; _commit_segments skips the re-save
            self._seg_meta[merged.seg_id] = merged.save(self.root)
        with self._lock:
            if any(v.seg_id not in self.segments for v in victims):
                # the segment set changed under us (reset/rebuild):
                # abandon — the orphan file is swept at the next publish
                if merged is not None:
                    self._seg_meta.pop(merged.seg_id, None)
                return False
            self._publish_merge(victims, keep, merged)
        return True

    def _merge(self, victims: list[Segment]) -> None:
        keep = [(v, np.nonzero(v.alive)[0]) for v in victims]
        self._publish_merge(victims, keep,
                            self._build_merged(keep, self._next_id()))

    def _build_merged(self, keep: list, seg_id: str) -> Optional[Segment]:
        total = sum(len(rows) for _, rows in keep)
        if total == 0:
            return None
        # fetch_f32 (not .emb): a quantized victim's fp32 rows live in
        # its sidecar — the merge re-quantizes the merged row set so
        # scale tightness never degrades across merge generations
        return self._new_segment(
            seg_id,
            np.concatenate([v.fetch_f32(rows) for v, rows in keep]),
            np.concatenate([v.valid_from[rows] for v, rows in keep]),
            np.concatenate([v.positions[rows] for v, rows in keep]),
            [v.chunk_ids[i] for v, rows in keep for i in rows],
            [v.doc_ids[i] for v, rows in keep for i in rows],
            [v.texts[i] for v, rows in keep for i in rows],
            tenant_ids=np.concatenate(
                [v.tenant_ids[rows] for v, rows in keep]))

    def _publish_merge(self, victims: list[Segment], keep: list,
                       merged: Optional[Segment]) -> None:
        purged = sum(len(v) - len(rows) for v, rows in keep)
        self._commit_segments("merge", add=[merged] if merged else [],
                              remove=victims)
        self._cat = None
        for v in victims:
            del self.segments[v.seg_id]
            self._seg_meta.pop(v.seg_id, None)
        if merged is not None:
            self.segments[merged.seg_id] = merged
            mrow = 0
            for v, rows in keep:
                for r in rows:
                    key = merged.key(mrow)
                    if self._by_key.get(key) == (v.seg_id, int(r)):
                        self._by_key[key] = (merged.seg_id, mrow)
                    else:
                        # key moved or died while the merge was built
                        # off-lock: the merged copy is dead on arrival
                        merged.kill(mrow)
                    mrow += 1
            self.cstats.rows_written += len(merged)
        self.cstats.merges += 1
        self.cstats.tombstones_purged += purged

    def _commit_segments(self, op: str, add: list[Segment],
                         remove: list[Segment]) -> None:
        """Durable transition of the live-segment set: write new files,
        atomically publish the manifest, then retire old files. Bracketed
        in the WAL; the manifest rename is the commit point, so a crash in
        any window leaves only orphan files (cleaned on next load). Once
        a quantized segment's fp32 sidecar is durable, its resident fp32
        copy is released — scans run on int8 from then on."""
        if self.manifest is None:
            return
        txn = None
        if self.wal is not None:
            txn = self.wal.begin("hot_compact", {
                "kind": "hot_compact", "op": op,
                "add": [s.filename() for s in add],
                "remove": [s.filename() for s in remove]})
        for seg in add:
            if seg.seg_id not in self._seg_meta:   # compact_once pre-saves
                self._seg_meta[seg.seg_id] = seg.save(self.root)
        self._fault(f"{op}:before_manifest")
        removed = {s.seg_id for s in remove}
        # add-segments are not yet registered in self.segments
        live = [s for s in self.segments.values()
                if s.seg_id not in removed] + add
        entries = [{"name": self._seg_meta[s.seg_id][0],
                    "checksum": self._seg_meta[s.seg_id][1],
                    "rows": len(s)} for s in live]
        self.manifest.commit(entries, seq=self._seq)
        self._fault(f"{op}:after_manifest")
        self.manifest.cleanup_orphans({e["name"] for e in entries},
                                      quarantined=self._qnames())
        for seg in add:
            seg.release_f32()
        if txn is not None:
            self.wal.mark(txn, "COMMIT")

    def _fault(self, point: str) -> None:
        if self.fail_at == point:                  # legacy per-index shim
            self.fail_at = None
            raise CompactionInterrupted(f"injected crash at {point}")
        FAULTS.check(f"lsm:{point}", exc=CompactionInterrupted)

    # ------------------------------------------------------------------
    # integrity (DESIGN.md §16)
    # ------------------------------------------------------------------
    def _qnames(self) -> Optional[set]:
        return self.quarantine.names() if self.quarantine else None

    def quarantine_segment_files(self, filename: str, reason: str):
        """Move a corrupt segment npz (and its fp32 sidecar, which lives
        or dies with it) into ``quarantine/``. Hot segments are caches of
        the cold tier's authoritative rows, so quarantining one is never
        data loss — a rebuild re-inserts its rows from cold."""
        if self.quarantine is None:
            return None
        sidecar = filename[:-len(".npz")] + ".f32.npy"
        return self.quarantine.quarantine(
            os.path.join(self.root, filename), "hot_segment", reason,
            docs=[], data_loss=False,
            companions=(os.path.join(self.root, sidecar),))

    # ------------------------------------------------------------------
    # reads (batched, array-native — DESIGN.md §8, §11)
    # ------------------------------------------------------------------
    def _catalog(self) -> _Catalog:
        """Build (lazily, cached until the segment set changes) the global
        row-id layout and the fused small-source scan block."""
        if self._cat is None:
            segs = list(self.segments.values())
            cap = self.mem.capacity
            seg_starts = np.empty(len(segs), np.int64)
            small, ivf, solo = [], [], []
            fixed = fixed_scale(self.dim)
            base = cap
            for i, s in enumerate(segs):
                seg_starts[i] = base
                if s.ivf is not None:
                    ivf.append((s, base))
                elif self.quantized and (s.scale is None or
                                         not np.array_equal(s.scale, fixed)):
                    # a data-scaled segment demoted below ivf_min_rows
                    # (config drift on reopen) cannot join the fused
                    # block — one shared scale vector per dispatch —
                    # so it is scanned as its own source
                    solo.append((s, base))
                else:
                    small.append((s, base))
                base += len(s)
            mem_block = self.mem._q8 if self.quantized else self.mem._emb
            if self.quantized:
                parts_e = [mem_block] + [s.q8 for s, _ in small]
            else:
                parts_e = [mem_block] + [s.emb for s, _ in small]
            parts_g = [np.arange(cap, dtype=np.int64)] + \
                [b + np.arange(len(s), dtype=np.int64) for s, b in small]
            mirrored = bool(small)
            small_offsets = np.cumsum(
                [cap] + [len(s) for s, _ in small])        # fused-local
            mem = self.mem

            def fused_f32(rows: np.ndarray) -> np.ndarray:
                """Exact fp32 rows by FUSED-LOCAL id (rescore source):
                memtable slots from the resident fp32 slot array, small
                segments through their winners-row caches."""
                rows = np.asarray(rows, np.int64)
                out = np.empty((len(rows), self.dim), np.float32)
                in_mem = rows < cap
                if in_mem.any():
                    out[in_mem] = mem._emb[rows[in_mem]]
                for si, (s, _) in enumerate(small):
                    lo, hi = small_offsets[si], small_offsets[si + 1]
                    sel = (rows >= lo) & (rows < hi)
                    if sel.any():
                        out[sel] = s.fetch_f32(rows[sel] - lo)
                return out

            # per-column gathers over the segment row space (vectorized
            # result build): concat of each segment's cached immutable
            # column arrays — one fancy-index replaces the per-winner
            # Python loop, and a catalog rebuild costs O(segments), not
            # O(corpus rows) of Python list flattening
            if segs:
                per_seg = [s.result_cols() for s in segs]
                seg_cols = {key: np.concatenate([c[key] for c in per_seg])
                            for key in per_seg[0]}
            else:
                seg_cols = None
            self._cat = _Catalog(
                segs=segs, seg_starts=seg_starts, ivf=ivf, small=small,
                solo=solo,
                fused_emb=torch.tensor(
                    np.concatenate(parts_e) if mirrored else mem_block,
                    device=self.device),
                fused_gids=(np.concatenate(parts_g) if mirrored
                            else parts_g[0]),
                mirrored=mirrored, fused_f32=fused_f32, seg_cols=seg_cols)
        return self._cat

    def _authority_rows(self, cat: _Catalog) -> np.ndarray:
        """The per-source authority row-arrays, concatenated over the
        global row-id space. The memtable's ``_active`` mask and each
        segment's ``alive`` deletion vector ARE these arrays: every
        write-path mutation keeps them in lockstep with ``_by_key``
        (insert over a live key kills the shadowed row, delete pops the
        key and frees/kills its row, rebuild claims each key exactly
        once), so bit g is set iff ``_by_key`` maps row g's key to row g.
        The merge then replaces the old per-candidate dict lookup with
        one boolean gather."""
        parts = [self.mem._active] + [s.alive for s in cat.segs]
        return np.concatenate(parts) if cat.segs else self.mem._active

    def _tenant_rows(self, cat: _Catalog) -> np.ndarray:
        """Per-row tenant ids over the same global row-id space as
        ``_authority_rows`` — memtable slots first, then each segment's
        immutable tenant column in seal order. Built per search (like the
        authority concat) because memtable tenants mutate in place."""
        parts = [self.mem._tenants] + [s.tenant_ids for s in cat.segs]
        return np.concatenate(parts) if cat.segs else self.mem._tenants

    def validate_authority(self) -> bool:
        """Invariant check (tests): the vectorized authority arrays agree
        with ``_by_key`` exactly."""
        cat = self._catalog()
        auth = self._authority_rows(cat)
        expect = np.zeros_like(auth)
        seg_pos = {s.seg_id: i for i, s in enumerate(cat.segs)}
        for key, loc in self._by_key.items():
            if isinstance(loc, int):
                expect[loc] = True
            else:
                i = seg_pos[loc[0]]
                expect[cat.seg_starts[i] + loc[1]] = True
        return bool(np.array_equal(auth, expect))

    def search(self, queries: np.ndarray, k: int = 5,
               visible: Optional[np.ndarray] = None
               ) -> list[list[SearchResult]]:
        """Batched top-k: ONE fused kernel dispatch over the memtable plus
        every small segment, one batched nprobe-routed pass per IVF
        segment, then one array-native merge over the concatenated
        (Q, n_sources*k) candidate matrix. A query's results are
        bit-identical whether it runs alone or inside a batch.

        ``visible``: optional sorted int32 array of visible tenant ids
        (None = no scoping). Visibility is enforced PRE-RANKING: the
        per-row tenant mask is AND-ed into the validity masks every
        kernel already honors (fused/solo/IVF alike), so a foreign-
        tenant row returns idx -1 and the fp32 rescore can never
        resurrect it — the same contract as the deletion vector.

        Scan accounting: ``_scan_scanned`` counts ROW-READS. The fused
        block reads each row ONCE for the whole batch (that is the point
        of the fused dispatch), so it contributes its row count once;
        IVF member scans are per-query gathers, so they contribute their
        per-query average times nq. The denominator is rows x queries,
        making ``avg_fraction_scanned`` the amortized per-query fraction
        for both source kinds."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = q.shape[0]
        # the whole read runs under the index lock: maintenance keeps its
        # heavy work OFF the lock (seal_if_above/compact_once build
        # off-lock), so a query only ever waits on an atomic publish or
        # an inline memtable-full seal
        with self._lock:
            return self._search_locked(q, nq, k, visible)

    def _search_locked(self, q: np.ndarray, nq: int, k: int,
                       visible: Optional[np.ndarray] = None
                       ) -> list[list[SearchResult]]:
        if not self._by_key:
            return [[] for _ in range(nq)]
        cat = self._catalog()
        auth = self._authority_rows(cat)
        vis = (None if visible is None
               else visible_rows(self._tenant_rows(cat), visible))
        if vis is not None:
            # defense in depth: visibility joins the authority array used
            # by the final merge, in addition to the per-source kernel
            # masks below — a row missed by a source mask still cannot
            # survive the merge
            auth = auth & vis
        blocks_s: list[np.ndarray] = []
        blocks_g: list[np.ndarray] = []
        scanned = 0
        # fused block: memtable + small segments, one kernel dispatch;
        # its alive mask is the authority array gathered by fused row
        # (which now carries the tenant visibility bits). The mask goes
        # to the device per dispatch (N bools); only (Q, k) comes back.
        fmask = auth[cat.fused_gids]
        if fmask.any():
            with obs.span("fused_scan") as fsp:
                qp, _ = pad_queries(q)
                k_eff = min(k, cat.fused_emb.shape[0])
                dev = self.device
                qd = torch.as_tensor(np.ascontiguousarray(qp), device=dev)
                fmask_d = torch.as_tensor(fmask, device=dev)
                if self.quantized:
                    from ..kernels.topk_search.ops import topk_search_q8
                    kp = pool_k(k_eff, cat.fused_emb.shape[0],
                                self.rescore_factor)
                    _, pool = topk_search_q8(qd, cat.fused_emb,
                                             fixed_scale(self.dim),
                                             fmask_d, kp)
                    fsp.add("rescore_pool", int(kp) * nq)
                    s, idx = rescore_topk(q, pool.cpu().numpy()[:nq],
                                          cat.fused_f32, k_eff)
                else:
                    from ..kernels.topk_search.ops import topk_search
                    s, idx = topk_search(qd, cat.fused_emb, fmask_d, k_eff)
                    s = s.cpu().numpy()[:nq]
                    idx = idx.cpu().numpy()[:nq]
                g = np.where(np.isfinite(s),
                             cat.fused_gids[np.clip(idx, 0, None)], -1)
                blocks_s.append(np.asarray(s, np.float32))
                blocks_g.append(g)
                # once per BATCH (fused)
                scanned += obs.scan_row_reads(
                    int(fmask.sum()), nq, per_query=False, source="fused",
                    row_bytes=self.dim * (1 if self.quantized else 4))
        # solo segments (scale-incompatible with the fused block): one
        # exact scan each, whole batch per dispatch — like fused.
        for seg, sbase in cat.solo:
            svis = (None if vis is None
                    else vis[sbase:sbase + len(seg)])
            if seg.n_alive == 0 or (svis is not None and not svis.any()):
                continue
            with obs.span(f"solo_scan:{seg.seg_id}"):
                s, rows, seg_scanned = seg.search(q, k,
                                                  nprobe=self.nprobe,
                                                  visible=svis)
                s = np.asarray(s, np.float32)
                rows = np.asarray(rows)
                g = np.where(rows >= 0, sbase + np.clip(rows, 0, None),
                             -1)
                blocks_s.append(s)
                blocks_g.append(g)
                # once per BATCH (exact)
                scanned += obs.scan_row_reads(
                    seg_scanned, nq, per_query=False, source="solo",
                    row_bytes=self.dim * (1 if self.quantized else 4))
        # IVF segments: batched centroid routing + per-query member scan.
        for seg, sbase in cat.ivf:
            svis = (None if vis is None
                    else vis[sbase:sbase + len(seg)])
            if seg.n_alive == 0 or (svis is not None and not svis.any()):
                continue
            with obs.span(f"ivf_scan:{seg.seg_id}") as isp:
                s, rows, seg_scanned = seg.search(q, k,
                                                  nprobe=self.nprobe,
                                                  visible=svis)
                s = np.asarray(s, np.float32)
                rows = np.asarray(rows)
                g = np.where(rows >= 0, sbase + np.clip(rows, 0, None),
                             -1)
                blocks_s.append(s)
                blocks_g.append(g)
                # per-query avg x queries (host-side member gathers, so
                # bytes are accounted here — no kernel span underneath)
                reads = obs.scan_row_reads(
                    seg_scanned, nq, per_query=True, source="ivf",
                    row_bytes=self.dim * (1 if self.quantized else 4))
                isp.add("bytes_streamed",
                        reads * self.dim * (1 if self.quantized else 4))
                scanned += reads
        self._scan_scanned += scanned
        self._scan_denom += max(len(self._by_key), 1) * nq
        if not blocks_s:
            return [[] for _ in range(nq)]
        top_s, top_g = merge_topk_candidates(
            np.concatenate(blocks_s, axis=1),
            np.concatenate(blocks_g, axis=1), auth, k)
        with obs.span("results"):
            return self._build_results(top_s, top_g, cat)

    def _build_results(self, top_s: np.ndarray, top_g: np.ndarray,
                       cat: _Catalog) -> list[list[SearchResult]]:
        """Materialize SearchResults for the Q*k winners only — column
        gathers over the catalog (one fancy-index per column) instead of
        a per-winner Python double loop; only the memtable's few winners
        are read through its mutable per-slot lists."""
        nq, kk = top_s.shape
        cap = self.mem.capacity
        g = top_g.reshape(-1)
        s = top_s.reshape(-1)
        valid = g >= 0
        in_seg = valid & (g >= cap)
        # one gather per column for ALL segment winners at once
        chunk_ids = np.empty(g.shape, object)
        doc_ids = np.empty(g.shape, object)
        texts = np.empty(g.shape, object)
        positions = np.zeros(g.shape, np.int64)
        valid_from = np.zeros(g.shape, np.int64)
        tenants = np.zeros(g.shape, np.int64)
        if in_seg.any():
            rows = g[in_seg] - cap
            cols = cat.seg_cols
            chunk_ids[in_seg] = cols["chunk_ids"][rows]
            doc_ids[in_seg] = cols["doc_ids"][rows]
            texts[in_seg] = cols["texts"][rows]
            positions[in_seg] = cols["positions"][rows]
            valid_from[in_seg] = cols["valid_from"][rows]
            tenants[in_seg] = cols["tenant_ids"][rows]
        in_mem = valid & (g < cap)
        mem = self.mem
        for j in np.nonzero(in_mem)[0]:          # few winners, mutable lists
            row = int(g[j])
            chunk_ids[j] = mem._chunk_ids[row] or ""
            doc_ids[j] = mem._doc_ids[row] or ""
            texts[j] = mem._texts[row]
            positions[j] = mem._positions[row]
            valid_from[j] = mem._valid_from[row]
            tenants[j] = mem._tenants[row]
        namer = self.tenant_namer
        out: list[list[SearchResult]] = []
        for qi in range(nq):
            res: list[SearchResult] = []
            for j in range(qi * kk, qi * kk + kk):
                if not valid[j]:
                    continue
                res.append(SearchResult(
                    chunk_id=chunk_ids[j], doc_id=doc_ids[j],
                    position=int(positions[j]), score=float(s[j]),
                    text=texts[j], valid_from=int(valid_from[j]),
                    valid_to=VALID_TO_OPEN, tier="hot",
                    tenant=(namer(int(tenants[j])) if namer is not None
                            else "")))
            out.append(res)
        return out

    def active_embeddings(self) -> np.ndarray:
        with self._lock:
            parts = [self.mem._emb[self.mem._active]]
            parts += [s.fetch_f32(np.nonzero(s.alive)[0])
                      for s in self.segments.values()]
            return (np.concatenate(parts) if parts
                    else np.zeros((0, self.dim)))

    # ------------------------------------------------------------------
    # recovery + reset
    # ------------------------------------------------------------------
    def rebuild(self, records: Sequence[ChunkRecord]) -> dict:
        """Crash-safe restore: load the manifest's segment set, reconcile
        every row against the cold tier's authoritative active records
        (``records``), and insert only the uncovered delta into the
        memtable. Any integrity failure falls back to a full re-insert —
        the cold tier is always the source of truth."""
        with self._lock:
            return self._rebuild_locked(records)

    def _rebuild_locked(self, records: Sequence[ChunkRecord]) -> dict:
        self.reset(drop_disk=False)
        auth = {(r.doc_id, r.position): r for r in records}
        claimed: dict[tuple[str, int], tuple[str, int]] = {}
        loaded: list[Segment] = []
        if self.manifest is not None:
            m = self.manifest.load()
            if m is not None:
                self._seq = max(self._seq, int(m.get("seq", 0)))
                for ent in m["segments"]:
                    try:
                        seg = Segment.load(
                            self.root, ent["name"], ent.get("checksum"),
                            ivf_min_rows=self.ivf_min_rows, seed=self.seed,
                            rescore_factor=self.rescore_factor,
                            device=self.device)
                    except CorruptionError as err:
                        # containment: quarantine ONLY the rotten file —
                        # its rows come back below via the cold-authority
                        # delta insert (CorruptionError must be caught
                        # before IOError: it subclasses it)
                        self.quarantine_segment_files(
                            ent["name"], reason=str(err))
                        continue
                    except (IOError, OSError, KeyError, ValueError):
                        loaded = []          # structural damage: full rebuild
                        self._seg_meta.clear()
                        break
                    seg = self._coerce_quantization(seg)
                    self._seg_meta[seg.seg_id] = (ent["name"],
                                                  ent["checksum"])
                    loaded.append(seg)
                self.manifest.cleanup_orphans({e.get("name")
                                               for e in m["segments"]},
                                              quarantined=self._qnames())
        # newest segment wins a key; a row survives only if the cold tier
        # agrees this exact chunk version is the currently active one
        for seg in reversed(loaded):
            alive = np.zeros(len(seg), bool)
            for row in range(len(seg)):
                key = seg.key(row)
                r = auth.get(key)
                if (r is not None and key not in claimed
                        and r.chunk_id == seg.chunk_ids[row]):
                    alive[row] = True
                    claimed[key] = (seg.seg_id, row)
            seg.alive = alive
        for seg in loaded:
            if seg.n_alive > 0:
                self.segments[seg.seg_id] = seg
            else:
                self._seg_meta.pop(seg.seg_id, None)
        self._by_key.update(claimed)
        delta = [r for key, r in auth.items() if key not in claimed]
        self.insert(delta)
        return {"restored": len(claimed), "inserted": len(delta)}

    def _coerce_quantization(self, seg: Segment) -> Segment:
        """Align a loaded segment's storage format with the index flag:
        a fp32-format segment in a quantized index is quantized in RAM
        (its fp32 stays resident until the next merge rewrites it with a
        sidecar); a quantized-format segment in a fp32 index has its
        sidecar materialized back into RAM."""
        if self.quantized == seg.quantized:
            return seg
        emb = seg.fetch_f32(np.arange(len(seg)))
        # coercion keeps row order, so the persisted IVF partitioning is
        # still exactly valid — no k-means re-run on a format flip
        ivf_state = ((seg.ivf.centroids, seg.ivf._assign)
                     if seg.ivf is not None else None)
        return self._new_segment(
            seg.seg_id, emb, seg.valid_from, seg.positions,
            seg.chunk_ids, seg.doc_ids, seg.texts,
            ivf_state=ivf_state,
            tenant_ids=seg.tenant_ids)._with_alive(seg.alive)

    def reset(self, drop_disk: bool = True) -> None:
        with self._lock:
            self.mem.reset()
            self.segments.clear()
            self._by_key.clear()
            self._seg_meta.clear()
            self._cat = None
            self._scan_scanned = self._scan_denom = 0
            self.cstats = CompactionStats()
            if drop_disk and self.manifest is not None:
                self.manifest.commit([], seq=self._seq)
                self.manifest.cleanup_orphans(set(),
                                              quarantined=self._qnames())

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        seg_rows = sum(len(s) for s in self.segments.values())
        seg_alive = sum(s.n_alive for s in self.segments.values())
        return {
            "memtable": len(self.mem),
            "mem_capacity": self.mem.capacity,
            "segments": len(self.segments),
            "segment_rows": seg_rows,
            "tombstones": seg_rows - seg_alive,
            "partitioned_segments": sum(1 for s in self.segments.values()
                                        if s.ivf is not None),
            "nprobe": self.nprobe,
            "quantized": self.quantized,
            "rescore_factor": self.rescore_factor,
            "resident_embedding_bytes": self.nbytes(),
            "quarantined": (sorted(self.quarantine.names())
                            if self.quarantine else []),
            "avg_fraction_scanned": (self._scan_scanned
                                     / max(self._scan_denom, 1)),
            **self.cstats.as_dict(),
        }
