"""Shard-local lakes + the fabric facade (DESIGN.md §10).

A shard is a full ``LiveVectorLake`` under its own directory — own WAL,
own segmented hot tier, own cold tier with checkpoints/archives — so
every per-shard query runs the exact same code path a single-process
deployment runs ("a shard is just another candidate source",
DESIGN.md §7.5). ``ShardFabric`` is the serving facade in front of S
such lakes:

  ingest:  resolve a fabric-global monotonic timestamp (same semantics
           as ``LiveVectorLake._monotonic_ts``, so sharded validity
           intervals match the single-lake oracle bit for bit), route
           the CDC delta to the document's ring owners, and apply it to
           each owner's lake. With replication R every doc lands on R
           lakes.
  query:   scatter-gather through ``ScatterGatherPlanner`` — per-shard
           batched passes merged by ``merge_topk_candidates`` with an
           ownership + replica-dedup authority mask (planner.py).
  rebalance: shard split/merge and replica migration via manifest
           epochs (rebalance.py); during a migration's copy phase the
           fabric dual-writes ingests so no commit is stranded on the
           losing side of the flip.

The fabric manifest (FABRIC.json) is the root of trust: a fabric opened
on an existing root adopts the manifest's ring verbatim, and refuses to
serve if the manifest fails its checksum.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

from ..core.store import LiveVectorLake
from ..core.types import CDCSummary, SearchResult
from ..kernels.common import resolve_device
from .manifest import FabricManifest
from .planner import ScatterGatherPlanner
from .ring import HashRing


class CorruptFabricManifest(RuntimeError):
    """FABRIC.json exists but fails integrity checks — the fabric
    refuses to route rather than guess at ownership."""


class ShardLake:
    """One shard's lake: a ``LiveVectorLake`` under the fabric root,
    addressed by shard id. Thin by design — every storage/query
    behavior is the store's own, so sharded semantics can never drift
    from single-lake semantics."""

    def __init__(self, shard_id: str, root: str, embedder=None, **kw):
        self.shard_id = shard_id
        self.root = root
        self.store = LiveVectorLake(root, embedder=embedder, **kw)

    # -- ingest / migration -------------------------------------------
    def ingest(self, doc_id: str, text: str, ts: Optional[int] = None,
               tenant: str = "") -> CDCSummary:
        return self.store.ingest(doc_id, text, ts=ts, tenant=tenant)

    def export_doc_history(self, doc_id: str):
        return self.store.export_doc_history(doc_id)

    def import_history(self, doc_id: str, rows, doc_version: int,
                       fail_after_events: Optional[int] = None) -> dict:
        return self.store.import_history(
            doc_id, rows, doc_version,
            fail_after_events=fail_after_events)

    def purge_doc(self, doc_id: str) -> int:
        return self.store.purge_doc(doc_id)

    # -- queries -------------------------------------------------------
    def query_batch(self, texts: Sequence[str], k: int = 5,
                    at: Optional[int] = None,
                    window: Optional[tuple[int, int]] = None,
                    visibility=None) -> list[list[SearchResult]]:
        return self.store.query_batch(texts, k=k, at=at, window=window,
                                      visibility=visibility)

    # -- introspection -------------------------------------------------
    @property
    def doc_ids(self) -> list[str]:
        return self.store.hash_store.doc_ids()

    def has_doc(self, doc_id: str) -> bool:
        return doc_id in self.store.hash_store

    def stats(self) -> dict:
        return self.store.stats()


class ShardFabric:
    def __init__(self, root: str, n_shards: int = 2, vnodes: int = 64,
                 replicas: int = 1, dim: int = 384,
                 embedder_factory=None, hot_capacity: int = 4096,
                 cold_checkpoint_interval: int = 8,
                 temporal_fused: Optional[bool] = None,
                 quantized: Optional[bool] = None,
                 auto_resume_rebalance: bool = True,
                 shard_timeout_s: Optional[float] = None,
                 shard_retries: int = 0,
                 degraded_reads: bool = False, device=None):
        """Open (or bootstrap) a shard fabric at ``root``.

        On a fresh root, shards ``s00..s{n-1}`` are created and epoch 1
        is committed. On an existing root the manifest wins: ``n_shards``
        / ``vnodes`` / ``replicas`` are ignored in favor of the persisted
        ring, and a pending migration is resumed (roll-forward) unless
        ``auto_resume_rebalance=False``. ``embedder_factory()`` builds
        one embedder per shard lake (default: the deterministic
        hash-projection embedder, identical across shards and to the
        single-lake oracle).

        ``device``: where every shard lake's scans and resident history
        run (``LiveVectorLake``'s ``device``). None (default) = the CUDA
        device, and an error where there is none; pass "cpu" to run the
        kernels' plain PyTorch versions. Like ``embedder_factory`` it is
        a per-process setting, never written to FABRIC.json."""
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.manifest = FabricManifest(root)
        self.embedder_factory = embedder_factory
        self._lake_kwargs = dict(
            dim=dim, hot_capacity=hot_capacity,
            cold_checkpoint_interval=cold_checkpoint_interval,
            temporal_fused=temporal_fused,
            quantized=bool(quantized))
        state = self.manifest.load()
        if state is None:
            if self.manifest.exists():
                raise CorruptFabricManifest(
                    f"{root}/FABRIC.json failed checksum verification")
            shards = [f"s{i:02d}" for i in range(n_shards)]
            self.ring = HashRing(shards, vnodes=vnodes, replicas=replicas)
            self.manifest.commit({"ring": self.ring.to_dict(),
                                  "transition": None,
                                  "lake": self._persisted_lake_config(),
                                  "tenancy": "names-v1"})
            state = self.manifest.load()
        # the manifest is the root of trust: adopt the persisted lake
        # geometry so a bare ShardFabric(root) reopens correctly; an
        # EXPLICIT quantized flag is the one deliberate override (format
        # switch, like LiveVectorLake's STORE.json) and is re-persisted
        # (compare against the MANIFEST's value, absent on pre-§11
        # manifests — not the ctor-seeded kwargs, which always match)
        persisted_q = bool(state.get("lake", {}).get("quantized", False))
        self._lake_kwargs.update(state.get("lake", {}))
        if quantized is not None and persisted_q != bool(quantized):
            self._lake_kwargs["quantized"] = bool(quantized)
            self.manifest.commit({"ring": state["ring"],
                                  "transition": state.get("transition"),
                                  "lake": self._persisted_lake_config()})
        self.ring = HashRing.from_dict(state["ring"])
        self._lakes: dict[str, ShardLake] = {}
        # parallel scatter workers open lakes lazily from pool threads
        self._lake_lock = threading.RLock()
        self._last_ts = 0
        self._clock_synced = False
        self.planner = ScatterGatherPlanner(
            self, shard_timeout_s=shard_timeout_s,
            shard_retries=shard_retries, degraded_ok=degraded_reads)
        self._transition: Optional[dict] = state.get("transition")
        if self._transition is not None and auto_resume_rebalance:
            self.recover()

    def _persisted_lake_config(self) -> dict:
        # dim/capacity/checkpointing/quantization persist (reopening must
        # not depend on the caller remembering them — a quantized shard's
        # segments are quantized ON DISK); embedder_factory and
        # temporal_fused stay per-process (not serializable / a debug
        # switch)
        return {k: self._lake_kwargs[k]
                for k in ("dim", "hot_capacity",
                          "cold_checkpoint_interval", "quantized")}

    def commit_state(self, ring: dict, transition: Optional[dict]) -> int:
        """Commit a new fabric epoch, carrying the persistent lake
        config forward (the manifest payload is whole-state, not a
        patch). ``tenancy`` stamps the cross-shard tenant identity
        scheme: visibility and migrations carry tenant NAMES (tid
        encodings are lake-local, DESIGN.md §14)."""
        return self.manifest.commit({
            "ring": ring, "transition": transition,
            "lake": self._persisted_lake_config(),
            "tenancy": "names-v1"})

    # ------------------------------------------------------------------
    # shard lakes
    # ------------------------------------------------------------------
    def shard_dir(self, shard_id: str) -> str:
        return os.path.join(self.root, "shards", shard_id)

    def lake(self, shard_id: str) -> ShardLake:
        """The shard's lake, opened lazily (a lake with an existing cold
        tier recovers itself on open)."""
        lk = self._lakes.get(shard_id)
        if lk is None:
            with self._lake_lock:
                lk = self._lakes.get(shard_id)
                if lk is None:
                    embedder = (self.embedder_factory()
                                if self.embedder_factory else None)
                    lk = ShardLake(shard_id, self.shard_dir(shard_id),
                                   embedder=embedder, device=self.device,
                                   **self._lake_kwargs)
                    self._lakes[shard_id] = lk
                    self._last_ts = max(self._last_ts,
                                        lk.store._last_ts)
        return lk

    def drop_lake(self, shard_id: str) -> None:
        with self._lake_lock:
            self._lakes.pop(shard_id, None)

    # ------------------------------------------------------------------
    # ingest fan-out
    # ------------------------------------------------------------------
    def _sync_clock(self) -> None:
        """Fold EVERY ring shard's last stored instant into the fabric
        clock (once, before the first ts resolution): a reopened fabric
        must never assign a valid_from at or below an instant some
        shard already stored, or sharded intervals diverge from the
        single-lake oracle."""
        if self._clock_synced:
            return
        self._clock_synced = True
        for s in self.ring.shards:
            self.lake(s)            # opening folds the lake's _last_ts

    def _monotonic_ts(self, ts: Optional[int]) -> int:
        # fabric-global monotonic resolution BEFORE routing: every owner
        # lake stores the same valid_from, and the resolved sequence is
        # identical to what a single lake fed the same calls would store
        self._sync_clock()
        if ts is None:
            ts = time.time_ns() // 1000
        ts = max(int(ts), self._last_ts + 1)
        self._last_ts = ts
        return ts

    def ingest_owners(self, doc_id: str) -> tuple[str, ...]:
        """Where a write for ``doc_id`` must land right now. Outside a
        migration: the ring owners. During a migration's copy phase:
        docs on the move write to their old owners (the copy will carry
        the new commit) plus, once copied, their destinations
        (dual-write — the copied history must not go stale before the
        flip); every other doc writes to the union of old and target
        owners, which bootstraps docs created mid-migration onto the
        post-flip layout."""
        owners = list(self.ring.owners(doc_id))
        t = self._transition
        if t is not None and t.get("phase") == "copy":
            if doc_id in t["docs"]:
                if doc_id in set(t.get("done", ())):
                    owners += [s for s in t["docs"][doc_id]
                               if s not in owners]
            else:
                target = HashRing.from_dict(t["ring"])
                owners += [s for s in target.owners(doc_id)
                           if s not in owners]
        return tuple(owners)

    def ingest(self, doc_id: str, text: str, ts: Optional[int] = None,
               tenant: str = "") -> CDCSummary:
        """Route one CDC delta by ring position: chunk/diff/embed/commit
        runs on each owner lake (embedding is deterministic, so replicas
        store identical records). Returns the primary owner's summary.
        ``tenant`` names the owning namespace — each owner lake resolves
        the name against its own registry (DESIGN.md §14)."""
        owners = self.ingest_owners(doc_id)
        ts = self._monotonic_ts(ts)   # syncs every shard's clock first
        summaries = [self.lake(s).ingest(doc_id, text, ts=ts,
                                         tenant=tenant)
                     for s in owners]
        return summaries[0]

    def ingest_batch(self, docs: Sequence[tuple[str, str]],
                     ts: Optional[int] = None,
                     tenant: str = "") -> list[CDCSummary]:
        ts = self._monotonic_ts(ts)
        return [self.ingest(doc_id, text, ts, tenant=tenant)
                for doc_id, text in docs]

    # ------------------------------------------------------------------
    # queries (scatter-gather, planner.py)
    # ------------------------------------------------------------------
    def query(self, text: str, k: int = 5, at: Optional[int] = None,
              window: Optional[tuple[int, int]] = None,
              visibility=None) -> list[SearchResult]:
        return self.query_batch([text], k=k, at=at, window=window,
                                visibility=visibility)[0]

    def query_batch(self, texts: Sequence[str], k: int = 5,
                    at: Optional[int] = None,
                    window: Optional[tuple[int, int]] = None,
                    degraded_ok: Optional[bool] = None,
                    visibility=None) -> list[list[SearchResult]]:
        return self.planner.query_batch(texts, k=k, at=at, window=window,
                                        degraded_ok=degraded_ok,
                                        visibility=visibility)

    def query_batcher(self, k: int = 5, max_batch: int = 32,
                      max_wait_s: float = 0.0,
                      max_queue: Optional[int] = None,
                      default_deadline_s: Optional[float] = None,
                      tenant_quota: Optional[int] = None,
                      tenant_rate: Optional[float] = None,
                      tenant_burst: Optional[int] = None):
        """Serving-layer coalescing over the fabric, same contract (and
        same factory) as ``LiveVectorLake.query_batcher``: requests
        bucket by temporal intent, one dispatched batch == one
        scatter-gather pass. A shard failing mid-gather fails only that
        batch's requests; other buckets keep draining. With degraded
        reads enabled, a served-degraded batch stamps every member
        request's ``info`` with the gather's degradation markers
        (serve/batcher.py, DESIGN.md §13)."""
        from ..serve.batcher import intent_batcher

        def annotate() -> Optional[dict]:
            lg = self.planner.last_gather
            if lg and lg.get("degraded"):
                return {"degraded": True,
                        "shards_missing": lg["shards_missing"]}
            return None

        return intent_batcher(self.query_batch, k=k, max_batch=max_batch,
                              max_wait_s=max_wait_s, max_queue=max_queue,
                              default_deadline_s=default_deadline_s,
                              annotate=annotate,
                              tenant_quota=tenant_quota,
                              tenant_rate=tenant_rate,
                              tenant_burst=tenant_burst)

    # ------------------------------------------------------------------
    # membership / recovery
    # ------------------------------------------------------------------
    def set_transition(self, transition: Optional[dict]) -> None:
        """Called by the rebalancer after every manifest commit so the
        ingest/query paths see the current migration state."""
        self._transition = transition

    def recover(self) -> dict:
        """Roll a pending migration forward to completion (the manifest
        transition record says exactly which step to resume); per-lake
        WAL/manifest recovery already happened when each lake opened."""
        from .rebalance import Rebalancer
        if self._transition is None:
            return {"resumed": False}
        report = Rebalancer(self).resume()
        report["resumed"] = True
        return report

    # ------------------------------------------------------------------
    # replica-driven repair + anti-entropy (DESIGN.md §16)
    # ------------------------------------------------------------------
    def _donor_for(self, doc_id: str, exclude: str) -> Optional[str]:
        """A replica that can donate ``doc_id``'s full history: another
        ring owner first, then any shard still holding the doc
        (post-rebalance stragglers retain cold history)."""
        for s in self.ring.owners(doc_id):
            if s != exclude and self.lake(s).has_doc(doc_id):
                return s
        for s in self.ring.shards:
            if s != exclude and self.lake(s).has_doc(doc_id):
                return s
        return None

    def repair(self, shard_id: Optional[str] = None,
               anti_entropy: bool = False) -> dict:
        """Replica-driven repair of every quarantined artifact
        (DESIGN.md §16).

        Hot-tier quarantines rebuild locally from cold authority (no
        replica needed). Cold data-loss quarantines are repaired per
        affected doc: a replica owner exports the doc's FULL history
        (doc-scoped zone-pruned fold) and ``repair_doc`` commits back
        exactly the rows this shard lost, original validity intervals
        baked in — current AND temporal queries come back
        oracle-equivalent. A quarantine record whose affected-doc set
        is unknown (zone map too wide) repairs every doc the shard
        owns. Docs with no surviving replica are reported
        ``unrepairable`` and the shard stays degraded (loudly)."""
        shards = [shard_id] if shard_id else list(self.ring.shards)
        report: dict = {"shards": {}, "docs_repaired": 0,
                        "rows_restored": 0, "unrepairable": [],
                        "anti_entropy": None}
        from ..obs import REGISTRY
        for s in shards:
            st = self.lake(s).store
            rep: dict = {"hot_rebuilt": False, "docs": {},
                         "unrepairable": []}
            if st.integrity.hot_pending():
                st.rebuild_hot()
                rep["hot_rebuilt"] = True
            affected = st.integrity.affected_docs()
            if affected is not None and not affected:
                report["shards"][s] = rep
                continue
            docs = (sorted(affected) if affected is not None
                    else [d for d in self.all_docs()
                          if s in self.ring.owners(d)])
            for doc in docs:
                donor = self._donor_for(doc, exclude=s)
                if donor is None:
                    rep["unrepairable"].append(doc)
                    continue
                rows, ver = self.lake(donor).export_doc_history(doc)
                r = st.repair_doc(doc, rows, ver)
                rep["docs"][doc] = {**r, "donor": donor}
                report["docs_repaired"] += 1
                report["rows_restored"] += r["added_rows"]
                REGISTRY.counter("repair_docs", shard=s).inc()
            if rep["unrepairable"]:
                report["unrepairable"].extend(rep["unrepairable"])
            else:
                # every affected doc restored: the quarantined files are
                # retired evidence, the shard leaves degraded serving
                st.integrity.cold.mark_repaired()
            report["shards"][s] = rep
        if anti_entropy:
            report["anti_entropy"] = self.run_anti_entropy()
        return report

    def run_anti_entropy(self) -> dict:
        """Silent-divergence sweep: for every doc with >= 2 live
        replicas, compare the per-doc history digests
        (``doc_history_digest`` — SHA-256 over sorted (chunk-hash,
        position, interval) tuples, no row shipping). Divergent docs
        are merged BIDIRECTIONALLY: each replica repairs from every
        other's export, so all converge on the union history."""
        from ..obs import REGISTRY
        checked = diverged = 0
        repaired: list[str] = []
        for doc in self.all_docs():
            owners = [s for s in self.ring.owners(doc)
                      if self.lake(s).has_doc(doc)]
            if len(owners) < 2:
                continue
            checked += 1
            digests = {s: self.lake(s).store.doc_history_digest(doc)
                       for s in owners}
            if len(set(digests.values())) == 1:
                continue
            diverged += 1
            REGISTRY.counter("anti_entropy_diverged").inc()
            exports = {s: self.lake(s).export_doc_history(doc)
                       for s in owners}
            for s in owners:
                for d, (rows, ver) in exports.items():
                    if d != s:
                        self.lake(s).store.repair_doc(doc, rows, ver)
            repaired.append(doc)
        return {"docs_checked": checked, "diverged": diverged,
                "repaired": repaired}

    def all_docs(self) -> list[str]:
        """Every document the fabric serves (union over ring shards)."""
        seen: set[str] = set()
        for s in self.ring.shards:
            seen.update(self.lake(s).doc_ids)
        return sorted(seen)

    def stats(self) -> dict:
        state = self.manifest.load() or {}
        per_shard = {}
        for s in self.ring.shards:
            st = self.lake(s).stats()
            per_shard[s] = {"docs": st["docs"],
                            "active_chunks": st["hot"]["active"],
                            "cold_records": st["cold"]["total_records"],
                            "integrity": st["integrity"]}
        return {
            "epoch": state.get("epoch", 0),
            "ring": self.ring.to_dict(),
            "transition": self._transition,
            "shards": per_shard,
            "docs": len(self.all_docs()),
        }

    def health(self) -> dict:
        """Fabric-wide health in ONE call (DESIGN.md §12, §15):
        topology + per-shard tier stats (``stats()``), the planner's
        gather counters, the process-wide metrics snapshot (per-tier
        latency histograms, scan-accounting counters, batcher series),
        the slow-query log summary, every declared SLO's burn rates +
        alert state, and the flight recorder's retention summary."""
        from ..obs import (FLIGHT_RECORDER, REGISTRY, SLO_ENGINE,
                           SLOW_QUERIES)
        return {
            "fabric": self.stats(),
            "planner": dict(self.planner.stats),
            "last_gather": self.planner.last_gather,
            "metrics": REGISTRY.snapshot(),
            "slow_queries": SLOW_QUERIES.summary(),
            "slo": SLO_ENGINE.summary(),
            "flight_recorder": FLIGHT_RECORDER.summary(),
            # storage integrity (DESIGN.md §16): quarantine/degraded
            # state + per-tier scrub progress and last-verified stamps
            "integrity": {s: self.lake(s).store.integrity.summary()
                          for s in self.ring.shards},
            "scrub": {s: self.lake(s).store.scrubber.state()
                      for s in self.ring.shards},
        }
