"""LiveVectorLake facade: CDC ingestion + dual-tier storage + temporal
query routing (paper §III, §IV-B).

Ingest flow (paper's pseudo-code, with the WAL protocol of §III-C3):

  1. chunk + content-address hash            (Layer 1)
  2. CDC classify vs hash store              (Layer 1)
  3. embed ONLY new+modified, dedup by hash  (Layer 2)
  4. WAL INTENT
  5. cold-tier ACID commit (append + closures)     -> WAL COLD_OK
  6. hot-tier apply (delete closed / insert new)   -> WAL HOT_OK
  7. hash-store update, WAL COMMIT

Crash at any point is recovered by ``reconcile()``: cold tier committed =>
roll forward (cold is the source of truth; the hot tier is a rebuildable
cache); cold tier not committed => compensate/abort. ``fail_after`` is a
fault-injection hook used by the fault-tolerance tests.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from .cdc import detect_changes, positional_diff
from .chunking import chunk_document
from .cold_tier import ColdTier
from .embedder import CachingEmbedder, Embedder, HashProjectionEmbedder
from .hash_store import HashStore
from .hot_tier import HotTier
from .integrity import Scrubber, StoreIntegrity
from ..kernels.common import resolve_device
from ..obs import REGISTRY, span
from ..testing.faults import FAULTS
from .tenancy import TenantRegistry, Visibility
from .temporal import (CURRENT, COMPARATIVE, HISTORICAL, TemporalEngine,
                       classify_query)
from .types import (STATUS_DELETED, STATUS_SUPERSEDED, VALID_TO_OPEN,
                    CDCSummary, ChunkRecord, SearchResult)


class FaultInjected(RuntimeError):
    """Raised by the fault-injection hook to simulate a crash."""


class LiveVectorLake:
    def __init__(self, root: str, embedder: Optional[Embedder] = None,
                 dim: int = 384, hot_capacity: int = 4096,
                 device_resident_history: bool = True,
                 cold_checkpoint_interval: int = 8,
                 temporal_fused: Optional[bool] = None,
                 quantized: Optional[bool] = None, rescore_factor: int = 4,
                 max_pending_ingest: Optional[int] = None, device=None):
        """``temporal_fused`` selects the cold read path: True (default)
        routes temporal queries through the fused validity-masked kernel
        over the engine's resident full-history arrays; False uses the
        paper-faithful per-snapshot NumPy fold (the reference oracle).
        ``device_resident_history`` is the legacy alias for the same
        switch. ``cold_checkpoint_interval``: persist a cold-tier
        checkpoint every N commits (0 disables).

        ``quantized=True`` turns on the int8 scan fabric (DESIGN.md
        §11): every tier's scan streams int8 with exact fp32 rescoring
        of an over-fetched pool (k' = ``rescore_factor`` * k) — ~4x less
        resident embedding memory and scan traffic, recall@10 >= 0.99 vs
        the fp32 path (which remains the oracle at quantized=False).
        The flag is PERSISTED (STORE.json): reopening with the default
        ``quantized=None`` adopts the stored value, so a restart cannot
        silently materialize every quantized segment back to resident
        fp32; pass an explicit bool to switch formats.

        ``max_pending_ingest`` bounds the WRITE-side admission queue
        (DESIGN.md §14): an ``ingest`` that would leave more than this
        many writers convoying on the single-writer lock is rejected
        with ``AdmissionRejected`` — counted, never silent — mirroring
        the query batcher's ``max_queue``. None (default) = unbounded
        (the historical behavior).

        ``device``: where the hot tier's exact scans and the temporal
        engine's resident history run (int8 columns in a quantized
        store; the fp32 rescore and the IVF member scans stay on the
        host). None (default) = the CUDA device, and an error where
        there is none; pass "cpu" to run the kernels' plain PyTorch
        versions."""
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        # tenant namespace registry (TENANTS.json): name -> dense int32
        # id, persisted BEFORE any row carries a new id (DESIGN.md §14)
        self.tenants = TenantRegistry(root)
        inner = embedder or HashProjectionEmbedder(dim=dim)
        if inner.dim != dim:
            dim = inner.dim
        self.dim = dim
        self.quantized = self._resolve_quantized(quantized)
        self.embedder = CachingEmbedder(inner)
        self.hash_store = HashStore(os.path.join(root, "hash_store.json"))
        self.cold = ColdTier(os.path.join(root, "cold"), dim,
                             checkpoint_interval=cold_checkpoint_interval,
                             quant_sidecar=self.quantized)
        from .wal import WriteAheadLog
        self.wal = WriteAheadLog(os.path.join(root, "wal.jsonl"))
        self.hot = HotTier(dim, capacity=hot_capacity,
                           root=os.path.join(root, "hot_index"),
                           wal=self.wal, quantized=self.quantized,
                           rescore_factor=rescore_factor, device=self.device)
        fused = device_resident_history if temporal_fused is None \
            else temporal_fused
        self.temporal = TemporalEngine(self.cold, fused=fused,
                                       quantized=self.quantized,
                                       rescore_factor=rescore_factor,
                                       device=self.device)
        # results carry tenant NAMES; ids are a store-local encoding
        self.hot.index.tenant_namer = self.tenants.name_of
        self.temporal.tenant_namer = self.tenants.name_of
        # write-side admission state (bounded, counted — satellite of
        # ROADMAP item 2: query admission was bounded, ingest was not)
        self.max_pending_ingest = max_pending_ingest
        self._ingest_pending = 0
        self._ingest_gate = threading.Lock()
        self._c_ingest_rejected = REGISTRY.counter("ingest_rejected")
        self._last_ts = 0
        # One writer at a time per store (DESIGN.md §13): ingest, history
        # import (rebalance thread) and purge all serialize here — the
        # WAL txn protocol and cold version allocation assume a single
        # in-flight writer. Queries do NOT take this lock; they
        # synchronize on the index/temporal-engine locks only.
        self._write_lock = threading.RLock()
        # storage integrity (DESIGN.md §16): aggregated quarantine view +
        # the background scrubber that re-verifies every on-disk artifact
        self.integrity = StoreIntegrity(self.hot.index.quarantine,
                                        self.cold.quarantine,
                                        self.wal.quarantine)
        self.scrubber = Scrubber(self)
        if self.cold.latest_version() > 0:
            self.recover()

    def _resolve_quantized(self, quantized: Optional[bool]) -> bool:
        """Adopt (or persist) the store's on-disk scan format. None =
        reopen with whatever format the store was created with."""
        import json
        path = os.path.join(self.root, "STORE.json")
        cfg = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    cfg = json.load(f)
            except (json.JSONDecodeError, OSError):
                cfg = {}
        out = (bool(cfg.get("quantized", False)) if quantized is None
               else bool(quantized))
        # the store manifest names its tenancy sidecar so tools can
        # find the registry without hard-coding the layout
        changed = cfg.get("tenants_file") != TenantRegistry.FILENAME
        cfg["tenants_file"] = TenantRegistry.FILENAME
        if quantized is not None and cfg.get("quantized") != out:
            cfg["quantized"] = out
            changed = True
        if changed:
            with open(path, "w") as f:
                json.dump(cfg, f, indent=1)
        return out

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def ingest(self, doc_id: str, text: str, ts: Optional[int] = None,
               fail_after: Optional[str] = None,
               tenant: str = "") -> CDCSummary:
        """Ingest one document version into ``tenant``'s namespace
        ("" = the default namespace; legacy calls are unchanged).
        ``fail_after`` in {"intent", "cold", "hot"} simulates a crash
        after that stage (tests only)."""
        self._admit_ingest()
        try:
            with self._write_lock:
                return self._ingest_locked(doc_id, text, ts, fail_after,
                                           tenant)
        finally:
            with self._ingest_gate:
                self._ingest_pending -= 1

    def _admit_ingest(self) -> None:
        """Bounded, counted write admission (mirrors the query
        batcher's ``max_queue``): with ``max_pending_ingest`` set, an
        ingest arriving while that many writers are already pending on
        the single-writer lock is REJECTED WITH AN ERROR — the caller
        sees ``AdmissionRejected`` immediately and can back off, and
        the rejection is counted (``ingest_rejected``). Nothing is
        ever silently queued without bound or silently dropped."""
        with self._ingest_gate:
            if (self.max_pending_ingest is not None
                    and self._ingest_pending >= self.max_pending_ingest):
                self._c_ingest_rejected.inc()
                from ..serve.batcher import AdmissionRejected
                raise AdmissionRejected(
                    f"ingest admission: {self._ingest_pending} writers "
                    f"already pending "
                    f"(max_pending_ingest={self.max_pending_ingest})")
            self._ingest_pending += 1

    def _ingest_locked(self, doc_id: str, text: str, ts: Optional[int],
                       fail_after: Optional[str],
                       tenant: str = "") -> CDCSummary:
        tenant_id = self.tenants.resolve(tenant)
        REGISTRY.counter("ingest_docs",
                         tenant=tenant or "default").inc()
        ts = self._monotonic_ts(ts)
        chunks = chunk_document(text)
        old_hashes = self.hash_store.get(doc_id)
        cs = detect_changes(chunks, old_hashes)
        doc_version = self.hash_store.version(doc_id) + 1

        # Layer 2: embed only new+modified; content-address cache dedups
        # moved/unchanged content and cross-document duplicates for free.
        close_pos, append_pos = positional_diff(chunks, old_hashes)
        append_chunks = [chunks[p] for p in append_pos]
        h0, m0 = self.embedder.hits, self.embedder.misses
        embeddings = self.embedder.embed_chunks(
            [c.chunk_id for c in append_chunks],
            [c.text for c in append_chunks])
        n_dedup = self.embedder.hits - h0
        n_embedded = self.embedder.misses - m0

        records = []
        for c, e in zip(append_chunks, embeddings):
            parent = old_hashes[c.position] if c.position < len(old_hashes) else None
            records.append(ChunkRecord(
                chunk_id=c.chunk_id, doc_id=doc_id, position=c.position,
                valid_from=ts, parent_hash=parent, text=c.text, embedding=e,
                tenant=tenant, tenant_id=tenant_id))
        n_new_chunks = len(chunks)
        closures = [{"doc_id": doc_id, "position": p, "closed_at": ts,
                     "status": (STATUS_SUPERSEDED if p < n_new_chunks
                                else STATUS_DELETED)}
                    for p in close_pos]

        # WAL protocol -------------------------------------------------
        expected_version = self.cold.latest_version() + 1
        txn = self.wal.begin("ingest", {
            "doc_id": doc_id, "ts": ts, "cold_version": expected_version,
            "doc_version": doc_version,
            "hashes": [c.chunk_id for c in chunks]})
        if fail_after == "intent":                 # legacy per-call shim
            raise FaultInjected("crash after WAL INTENT")
        FAULTS.check("store:ingest:intent", exc=FaultInjected)

        version = self.cold.commit(records, closures, ts)
        assert version == expected_version
        self.wal.mark(txn, "COLD_OK")
        if fail_after == "cold":                   # legacy per-call shim
            raise FaultInjected("crash after cold-tier commit")
        FAULTS.check("store:ingest:cold", exc=FaultInjected)

        self._hot_apply(records, closures)
        self.wal.mark(txn, "HOT_OK")
        if fail_after == "hot":                    # legacy per-call shim
            raise FaultInjected("crash after hot-tier apply")
        FAULTS.check("store:ingest:hot", exc=FaultInjected)

        self.hash_store.put(doc_id, [c.chunk_id for c in chunks], doc_version)
        self.wal.mark(txn, "COMMIT")
        # incremental: the engine's resident history is APPENDED to from
        # this commit's in-memory delta, never rebuilt (no segment re-read)
        self.temporal.on_commit(version=version, records=records,
                                closures=closures)

        return CDCSummary(
            doc_id=doc_id, version=doc_version, ts=ts,
            n_new=len(cs.new), n_modified=len(cs.modified),
            n_deleted=len(cs.deleted), n_unchanged=len(cs.unchanged),
            n_moved=len(cs.moved), n_embedded=n_embedded,
            n_dedup_hits=n_dedup, reprocess_fraction=cs.reprocess_fraction)

    def ingest_batch(self, docs: Sequence[tuple[str, str]],
                     ts: Optional[int] = None,
                     tenant: str = "") -> list[CDCSummary]:
        ts = self._monotonic_ts(ts)
        return [self.ingest(doc_id, text, ts, tenant=tenant)
                for doc_id, text in docs]

    def _hot_apply(self, records: list[ChunkRecord],
                   closures: list[dict]) -> None:
        # delete-then-insert keeps (doc, position) uniqueness; both ops are
        # idempotent so WAL roll-forward can repeat them safely.
        appended = {(r.doc_id, r.position) for r in records}
        self.hot.delete([(c["doc_id"], c["position"]) for c in closures
                         if (c["doc_id"], c["position"]) not in appended])
        self.hot.insert(records)

    def _monotonic_ts(self, ts: Optional[int]) -> int:
        if ts is None:
            ts = time.time_ns() // 1000
        ts = max(int(ts), self._last_ts + 1)
        self._last_ts = ts
        return ts

    # ------------------------------------------------------------------
    # queries (paper §III-D; batched engine DESIGN.md §8)
    # ------------------------------------------------------------------
    def query(self, text: str, k: int = 5, at: Optional[int] = None,
              window: Optional[tuple[int, int]] = None,
              visibility: Visibility = None) -> list[SearchResult]:
        return self.query_batch([text], k=k, at=at, window=window,
                                visibility=visibility)[0]

    def query_batch(self, texts: Sequence[str], k: int = 5,
                    at: Optional[int] = None,
                    window: Optional[tuple[int, int]] = None,
                    visibility: Visibility = None
                    ) -> list[list[SearchResult]]:
        """Batched retrieval: embed ALL queries in one embedder call,
        group them by temporal intent ((mode, at, window) — explicit
        arguments or expressions parsed from each text), and execute each
        group as ONE batched pass over its tier. Results come back in
        input order and are bit-identical to ``[query(t) for t in
        texts]`` — the engine guarantees a query scores the same alone or
        inside a batch.

        ``visibility`` scopes the whole batch to a tenant name (or
        sequence of names): the resolved visible-tenant-id set is
        AND-ed into the scan validity masks PRE-ranking on every path
        (DESIGN.md §14). None = unscoped (legacy behavior, bit-
        identical results). Unknown names fail CLOSED (empty set)."""
        if not texts:
            return []
        with span("store:query_batch") as sp:
            t_store = time.perf_counter()
            visible = self.tenants.visible_tids(visibility)
            with span("classify"):
                groups: dict[tuple, list[int]] = {}
                for i, t in enumerate(texts):
                    it = classify_query(t, at=at, window=window)
                    groups.setdefault((it.mode, it.at, it.window),
                                      []).append(i)
            with span("embed"):
                vecs = self.embedder.embed(list(texts))
            out: list[Optional[list[SearchResult]]] = [None] * len(texts)
            for (mode, g_at, g_window), idxs in groups.items():
                q = vecs[idxs]
                t_group = time.perf_counter()
                with span(f"intent:{mode}") as isp:
                    isp.add("queries", len(idxs))
                    if visible is not None:
                        isp.add("visible_tenants", len(visible))
                    if mode == CURRENT:
                        tier = "hot"
                        res = self.hot.search(q, k=k, visible=visible)
                    elif mode == HISTORICAL:
                        tier = "cold"
                        res = self.temporal.query_at_batch(
                            q, g_at, k=k, visible=visible)
                        with span("results"):
                            for r in res:
                                self.temporal.assert_no_leakage(r, g_at)
                    else:
                        assert mode == COMPARATIVE
                        tier = "cold"
                        res = self.temporal.query_window_batch(
                            q, *g_window, k=k, visible=visible)
                REGISTRY.histogram("query_latency_ms", tier=tier,
                                   intent=mode).observe(
                    (time.perf_counter() - t_group) * 1e3)
                for j, i in enumerate(idxs):
                    out[i] = res[j]
            sp.add("queries", len(texts))
            REGISTRY.histogram("store_query_batch_ms").observe(
                (time.perf_counter() - t_store) * 1e3)
            return out

    def query_batcher(self, k: int = 5, max_batch: int = 32,
                      max_wait_s: float = 0.0,
                      max_queue: Optional[int] = None,
                      default_deadline_s: Optional[float] = None,
                      tenant_quota: Optional[int] = None,
                      tenant_rate: Optional[float] = None,
                      tenant_burst: Optional[int] = None) -> "Batcher":
        """A serving-layer batcher (serve/batcher.py) over this store:
        concurrent queries queue and coalesce into batched
        ``query_batch`` passes, bucketed by temporal intent AND
        visibility scope so one dispatched batch maps to ONE engine
        group — all concurrent CURRENT queries of one tenant scope land
        in a single hot-tier batch. ``max_queue`` turns on admission
        control, ``default_deadline_s`` per-request deadlines
        (DESIGN.md §13); ``tenant_quota``/``tenant_rate`` add the
        per-tenant fairness gates (DESIGN.md §14)."""
        from ..serve.batcher import intent_batcher
        return intent_batcher(self.query_batch, k=k, max_batch=max_batch,
                              max_wait_s=max_wait_s, max_queue=max_queue,
                              default_deadline_s=default_deadline_s,
                              tenant_quota=tenant_quota,
                              tenant_rate=tenant_rate,
                              tenant_burst=tenant_burst)

    # ------------------------------------------------------------------
    # fault tolerance
    # ------------------------------------------------------------------
    def recover(self) -> dict:
        """Full restart path: reconcile the WAL, restore the hot tier's
        segmented index from its manifest (reconciled row-by-row against
        the cold tier — the source of truth — so only the delta since the
        last seal is re-inserted, not one monolithic insert), rebuild the
        hash store, warm the embedding cache."""
        report = self.reconcile()
        records = self._cold_active_records()
        by_doc: dict[str, list[tuple[int, str]]] = {}
        for r in records:
            by_doc.setdefault(r.doc_id, []).append(
                (r.position, r.chunk_id))
        hot_report = self.hot.rebuild(records)
        # the rebuild above IS the hot-tier repair: any segment
        # quarantined during manifest load just had its rows re-derived
        # from cold authority (DESIGN.md §16)
        if self.hot.index.quarantine is not None:
            self.hot.index.quarantine.mark_repaired()
        for doc_id, pairs in by_doc.items():
            pairs.sort()
            self.hash_store.put(doc_id, [h for _, h in pairs],
                                max(self.hash_store.version(doc_id), 1))
        full = self.cold.snapshot(include_closed=True)
        self.embedder.warm(full.chunk_ids, full.embeddings)
        self._last_ts = max(self._last_ts,
                            int(full.valid_from.max()) if len(full) else 0)
        self.temporal.invalidate()
        report["hot_rebuilt"] = len(records)
        report["hot_restored_from_segments"] = hot_report["restored"]
        report["hot_delta_inserted"] = hot_report["inserted"]
        return report

    def _cold_active_records(self) -> list[ChunkRecord]:
        """The cold tier's authoritative currently-active rows as
        ChunkRecords (the hot tier's rebuild input)."""
        snap = self.cold.snapshot()
        snap_tids = snap.tenants()
        records = []
        for i in range(len(snap)):
            records.append(ChunkRecord(
                chunk_id=snap.chunk_ids[i], doc_id=snap.doc_ids[i],
                position=int(snap.position[i]),
                valid_from=int(snap.valid_from[i]),
                version=int(snap.version[i]), text=snap.texts[i],
                embedding=snap.embeddings[i],
                tenant=self.tenants.name_of(int(snap_tids[i])),
                tenant_id=int(snap_tids[i])))
        return records

    def rebuild_hot(self) -> dict:
        """Self-heal the hot tier from cold authority (DESIGN.md §16):
        after a hot segment is quarantined (load failure or scrub find)
        its rows are simply re-derived — the cold tier is the source of
        truth, so a hot-tier quarantine is never data loss. Marks the
        hot quarantine records repaired once the rebuild lands."""
        with self._write_lock:
            records = self._cold_active_records()
            rep = self.hot.rebuild(records)
            if self.hot.index.quarantine is not None:
                self.hot.index.quarantine.mark_repaired()
            return rep

    def reconcile(self, policy: str = "roll_forward") -> dict:
        """WAL reconciliation (paper: 'periodic reconciliation cleans
        uncommitted records').

        roll_forward: if the cold commit landed, finish the transaction
        (hot apply + hash store) — the paper's 'mark committed on success'.
        compensate:  flag the cold version uncommitted and abort — the
        paper's 'On Milvus failure, flag Delta record uncommitted'.
        """
        actions = {"rolled_forward": 0, "compensated": 0, "aborted": 0,
                   "hot_compact_closed": 0}
        for txn, state, payload in self.wal.pending():
            if payload.get("kind") == "hot_compact":
                # seal/merge of the segmented index: the manifest rename is
                # its own commit point and orphan segment files are swept
                # on load, so an in-flight txn needs no compensation.
                self.wal.mark(txn, "ABORT")
                actions["hot_compact_closed"] += 1
                continue
            v = payload.get("cold_version")
            cold_landed = v is not None and os.path.exists(
                self.cold._log_path(v))
            if not cold_landed:
                self.wal.mark(txn, "ABORT")   # nothing durable: pure abort
                actions["aborted"] += 1
            elif policy == "compensate":
                self.cold.mark_committed(v, committed=False)
                self.wal.mark(txn, "ABORT")
                # the rolled-back entry may already be folded into the
                # temporal engine's resident history (it was committed
                # until now): force a full re-seed so the fused path can
                # never serve compensated rows
                self.temporal.invalidate()
                actions["compensated"] += 1
            else:
                # roll forward from the durable cold state
                doc_id = payload["doc_id"]
                self.hash_store.put(doc_id, payload["hashes"],
                                    payload.get("doc_version", 1))
                self.wal.mark(txn, "COMMIT")
                actions["rolled_forward"] += 1
        return actions

    # ------------------------------------------------------------------
    # shard migration primitives (DESIGN.md §10.4)
    # ------------------------------------------------------------------
    def export_doc_history(self, doc_id: str) -> tuple[list[ChunkRecord], int]:
        """Full-history rows of one document (every version, open and
        closed) plus its CDC doc version — the unit a shard migration
        copies. Uses the cold tier's DOC-SCOPED fold (zone-map key sets
        prune every segment/archive not touching the doc, same path as
        ``history()``), so exporting one doc does not fold the whole
        lake. Replaying the rows through ``import_history`` on another
        lake reproduces the exact validity intervals, so temporal
        queries survive the move."""
        fold = self.cold._fold(only_doc=doc_id)
        cols = fold.columns()
        # rows travel with tenant NAMES, never ids: the tid encoding is
        # store-local (each lake's TENANTS.json allocates independently),
        # so the importing lake re-resolves names into its own registry
        rows = [ChunkRecord(
            chunk_id=cols["chunk_ids"][i], doc_id=doc_id,
            position=int(cols["position"][i]),
            valid_from=int(cols["valid_from"][i]),
            valid_to=int(cols["valid_to"][i]),
            version=int(cols["version"][i]), text=cols["texts"][i],
            embedding=cols["embeddings"][i],
            tenant=self.tenants.name_of(int(cols["tenant_ids"][i])))
            for i in range(fold.n)]
        return rows, self.hash_store.version(doc_id)

    def import_history(self, doc_id: str, rows: Sequence[ChunkRecord],
                       doc_version: int,
                       fail_after_events: Optional[int] = None) -> dict:
        """Replay one document's full history into this lake (migration
        receive path). The history is decomposed back into its per-commit
        CDC deltas (``history_to_events``) and each event runs the normal
        WAL -> cold -> hot protocol at its ORIGINAL timestamp, so the
        imported validity intervals are byte-identical to the source's.

        Idempotent at event granularity: events at or before the newest
        instant this lake has already applied for the doc are skipped, so
        a re-run after a mid-import crash (or a doc moving back to a
        shard that served it before) resumes instead of duplicating
        rows. ``fail_after_events`` crashes after N applied events
        (tests only)."""
        with self._write_lock:
            return self._import_history_locked(doc_id, rows, doc_version,
                                               fail_after_events)

    def _import_history_locked(self, doc_id: str,
                               rows: Sequence[ChunkRecord],
                               doc_version: int,
                               fail_after_events: Optional[int]) -> dict:
        from .cdc import history_to_events
        events = history_to_events(list(rows))
        have, _ = self.export_doc_history(doc_id)
        applied_up_to = max(
            [int(r.valid_from) for r in have] +
            [int(r.valid_to) for r in have if r.valid_to != VALID_TO_OPEN],
            default=0)
        applied = 0
        for n_applied, ev in enumerate(events):
            if ev.ts <= applied_up_to:
                continue
            if fail_after_events is not None \
                    and applied >= fail_after_events:
                raise FaultInjected(
                    f"crash after importing {applied} events")
            records = [dataclasses.replace(
                r, valid_to=VALID_TO_OPEN, version=0,
                tenant_id=self.tenants.resolve(r.tenant))
                for r in ev.records]
            expected_version = self.cold.latest_version() + 1
            txn = self.wal.begin("ingest", {
                "doc_id": doc_id, "ts": ev.ts,
                "cold_version": expected_version,
                "doc_version": min(n_applied + 1, doc_version),
                "hashes": ev.hashes_after})
            version = self.cold.commit(records, ev.closures, ev.ts)
            assert version == expected_version
            self.wal.mark(txn, "COLD_OK")
            self._hot_apply(records, ev.closures)
            self.wal.mark(txn, "HOT_OK")
            self.hash_store.put(doc_id, ev.hashes_after,
                                min(n_applied + 1, doc_version))
            self.wal.mark(txn, "COMMIT")
            self.temporal.on_commit(version=version, records=records,
                                    closures=ev.closures)
            applied += 1
        # A doc can return to a lake that previously handed it off (hot
        # rows purged, cold history retained): every event replays as a
        # no-op, so re-seat its open rows and hash entry explicitly.
        open_rows = [dataclasses.replace(
            r, version=0, tenant_id=self.tenants.resolve(r.tenant))
            for r in rows if r.valid_to == VALID_TO_OPEN]
        self._hot_apply(open_rows, [])
        final_hashes = [r.chunk_id for r in
                        sorted(open_rows, key=lambda r: r.position)]
        self.hash_store.put(doc_id, final_hashes, doc_version)
        self.embedder.warm([r.chunk_id for r in rows],
                           np.stack([r.embedding for r in rows])
                           if rows else np.zeros((0, self.dim), np.float32))
        if events:
            self._last_ts = max(self._last_ts, events[-1].ts)
        return {"events_total": len(events), "events_applied": applied,
                "events_skipped": len(events) - applied}

    # ------------------------------------------------------------------
    # replica-driven repair (DESIGN.md §16)
    # ------------------------------------------------------------------
    def doc_history_digest(self, doc_id: str) -> str:
        """Anti-entropy digest: SHA-256 over the doc's sorted
        full-history (chunk_id, position, valid_from, valid_to) tuples.
        chunk_id is itself the content-address hash, so two replicas
        agree on the digest iff they agree on every row's content AND
        validity interval. Quarantined segments are skipped by the fold,
        so a replica with rotten rows produces a DIFFERENT digest — the
        fabric's anti-entropy pass diffs digests to find silent
        divergence without shipping any rows."""
        import hashlib
        import json
        rows, _ = self.export_doc_history(doc_id)
        items = sorted((r.chunk_id, int(r.position), int(r.valid_from),
                        int(r.valid_to)) for r in rows)
        return hashlib.sha256(
            json.dumps(items, separators=(",", ":")).encode()).hexdigest()

    def repair_doc(self, doc_id: str, donor_rows: Sequence[ChunkRecord],
                   doc_version: int) -> dict:
        """Restore this doc's history from a replica's export.

        The local (quarantine-skipping) fold tells us which rows
        survived; every donor row we lack is committed back in ONE
        WAL-bracketed repair commit with its ORIGINAL validity interval
        baked in — ``_Fold.append_rows`` only treats ``VALID_TO_OPEN``
        rows as open, so closed intervals restore exactly without
        replaying their closures. Rows that are open locally but closed
        on the donor get explicit closures. Idempotent: a second run
        finds nothing missing and commits nothing."""
        with self._write_lock:
            return self._repair_doc_locked(doc_id, list(donor_rows),
                                           doc_version)

    def _repair_doc_locked(self, doc_id: str,
                           donor_rows: list[ChunkRecord],
                           doc_version: int) -> dict:
        def key(r):
            return (r.chunk_id, int(r.position), int(r.valid_from))
        local, _ = self.export_doc_history(doc_id)
        have = {key(r) for r in local}
        donor_by_key = {key(r): r for r in donor_rows}
        missing = [r for r in donor_rows if key(r) not in have]
        closures = []
        for r in local:
            d = donor_by_key.get(key(r))
            if (r.valid_to == VALID_TO_OPEN and d is not None
                    and d.valid_to != VALID_TO_OPEN):
                superseded = any(
                    int(dr.position) == int(r.position)
                    and int(dr.valid_from) >= int(d.valid_to)
                    for dr in donor_rows)
                closures.append({
                    "doc_id": doc_id, "position": int(r.position),
                    "closed_at": int(d.valid_to),
                    "status": (STATUS_SUPERSEDED if superseded
                               else STATUS_DELETED)})
        open_rows = [dataclasses.replace(
            r, version=0, tenant_id=self.tenants.resolve(r.tenant))
            for r in donor_rows if r.valid_to == VALID_TO_OPEN]
        final_hashes = [r.chunk_id for r in
                        sorted(open_rows, key=lambda r: r.position)]
        out = {"added_rows": len(missing), "closed": len(closures),
               "cold_version": None}
        if missing or closures:
            records = [dataclasses.replace(
                r, version=0, tenant_id=self.tenants.resolve(r.tenant))
                for r in missing]
            # entry ts = the earliest instant any repaired row touches,
            # so every as_of that should see a row folds this entry in
            # (per-row validity masks handle the rest); non-monotonic
            # entry timestamps are already supported post-rebalance
            ts = min([int(r.valid_from) for r in missing] +
                     [c["closed_at"] for c in closures])
            expected_version = self.cold.latest_version() + 1
            txn = self.wal.begin("repair", {
                "doc_id": doc_id, "ts": ts,
                "cold_version": expected_version,
                "doc_version": doc_version, "hashes": final_hashes})
            version = self.cold.commit(records, closures, ts)
            assert version == expected_version
            self.wal.mark(txn, "COLD_OK")
            self._hot_apply([r for r in records
                             if r.valid_to == VALID_TO_OPEN], closures)
            self.wal.mark(txn, "HOT_OK")
            self.hash_store.put(doc_id, final_hashes, doc_version)
            self.wal.mark(txn, "COMMIT")
            out["cold_version"] = version
            # the resident history may hold pre-corruption rows or lack
            # the repaired ones: full re-seed keeps fused == fold
            self.temporal.invalidate()
        # re-seat the serving rows even when no cold delta was needed
        # (a hot-tier hole after quarantine has no cold-side symptom)
        self._hot_apply(open_rows, [])
        self.hash_store.put(doc_id, final_hashes,
                            max(doc_version,
                                self.hash_store.version(doc_id)))
        if donor_rows:
            self.embedder.warm(
                [r.chunk_id for r in donor_rows],
                np.stack([r.embedding for r in donor_rows]))
            self._last_ts = max(
                self._last_ts,
                max(int(r.valid_from) for r in donor_rows),
                max([int(r.valid_to) for r in donor_rows
                     if r.valid_to != VALID_TO_OPEN], default=0))
        return out

    def purge_doc(self, doc_id: str) -> int:
        """Drop a document from this lake's SERVING state (migration
        hand-off: another shard now owns it). Hot rows and the hash-store
        entry go away; the cold history stays on disk — it is immutable
        audit state, and the fabric's ownership filter keeps non-owners'
        copies out of every query result. Returns hot rows removed."""
        with self._write_lock:
            removed = self.hot.delete(self.hot.doc_keys(doc_id))
            self.hash_store.remove(doc_id)
            return removed

    def compact_cold(self, min_run: int = 2) -> dict:
        """Cold-tier maintenance: rewrite fully-closed commit runs into
        sorted zone-mapped archives (DESIGN.md §9). Read-only overlays —
        no visible state changes, so the temporal engine stays valid."""
        return self.cold.compact(min_run=min_run)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        cold = self.cold.stats()
        hot = self.hot.stats()
        total = max(cold["total_records"], 1)
        return {
            "hot": hot, "cold": cold,
            "hot_fraction_of_history": hot["active"] / total,
            "docs": len(self.hash_store),
            "embed_cache": {"hits": self.embedder.hits,
                            "misses": self.embedder.misses},
            "integrity": self.integrity.summary(),
        }
