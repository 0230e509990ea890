"""Temporal query engine (paper §III-D).

Query classification by temporal intent:
  - current:     no temporal constraint            -> hot tier
  - historical:  specific timestamp                -> cold tier, snapshot @ ts
  - comparative: date range                        -> both tiers

Temporal-leakage prevention (paper §III-D3): validity filtering precedes
similarity ranking. Two enforcement layers:
  1. the cold tier's snapshot() only materializes records whose validity
     interval covers the target instant;
  2. the scoring kernel (kernels/temporal_mask_score) re-applies the
     interval test *inside* the fused score+top-k, so even a device-
     resident full-history corpus can never rank an invalid chunk
     (invalid rows are -inf BEFORE selection).

Execution paths (DESIGN.md §9):
  - FUSED (default): the engine keeps a RESIDENT full-history array pair
    (embeddings + validity intervals) that is appended to incrementally
    on every commit — never rebuilt — and routes both point-in-time and
    window queries through the fused validity-masked top-k kernel with
    the interval test evaluated per query INSIDE the kernel. No per-
    timestamp materialized snapshot copy ever exists, so temporal query
    cost does not scale with history length.
  - ORACLE (``fused=False``): the paper-faithful path — materialize a
    point-in-time snapshot via the (checkpoint-accelerated) log fold,
    then score with the pure-NumPy reference kernel. Retained as the
    reference the equivalence gates and the property suite compare the
    fused path against.
"""
from __future__ import annotations

import dataclasses
import re
import threading
from datetime import datetime, timezone
from typing import Optional

import numpy as np
import torch

from .. import obs
from .cold_tier import ColdSnapshot, ColdTier
from ..kernels.common import Q8_NOT_PORTED, resolve_device
from .integrity import CorruptionError
from .tenancy import visible_rows
from .types import SearchResult, VALID_TO_OPEN, pad_queries

CURRENT = "current"
HISTORICAL = "historical"
COMPARATIVE = "comparative"

_AS_OF = re.compile(r"\b(?:as of|as at|at|on)\s+(\d{4}-\d{2}-\d{2})\b", re.I)
_BETWEEN = re.compile(
    r"\bbetween\s+(\d{4}-\d{2}-\d{2})\s+and\s+(\d{4}-\d{2}-\d{2})\b", re.I)


def _iso_to_us(s: str) -> int:
    dt = datetime.strptime(s, "%Y-%m-%d").replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1_000_000)


@dataclasses.dataclass(frozen=True)
class TemporalIntent:
    mode: str
    at: Optional[int] = None                     # unix micros
    window: Optional[tuple[int, int]] = None     # [t0, t1) unix micros


def classify_query(text: str = "", at: Optional[int] = None,
                   window: Optional[tuple[int, int]] = None) -> TemporalIntent:
    """Classify by explicit arguments first, then by temporal expressions
    in the query text ("as of 2025-03-01", "between A and B")."""
    if window is not None:
        return TemporalIntent(COMPARATIVE, window=tuple(window))
    if at is not None:
        return TemporalIntent(HISTORICAL, at=at)
    m = _BETWEEN.search(text)
    if m:
        return TemporalIntent(
            COMPARATIVE, window=(_iso_to_us(m.group(1)), _iso_to_us(m.group(2))))
    m = _AS_OF.search(text)
    if m:
        return TemporalIntent(HISTORICAL, at=_iso_to_us(m.group(1)))
    return TemporalIntent(CURRENT)


class ResidentHistory:
    """The engine's resident full-history columns: embeddings + validity
    intervals (+ result metadata), grown geometrically and APPENDED to on
    every commit instead of rebuilt. ``valid_to`` is mutated in place when
    a later commit closes a row — the arrays always equal the cold tier's
    full-history fold, record for record (the incremental-fold invariant,
    DESIGN.md §9).

    The scan columns live on ``device`` and grow there: ``emb``,
    ``vf_dev``/``vt_dev`` (validity) and ``tids_dev`` (tenant ids, for
    the visibility pushdown). The host keeps what results need: ``vf``,
    ``vt``, ``ver``, ``pos``, ``tids`` and the string columns. Every
    validity write goes through ``_push`` (appended rows) or ``_close``
    (closures), which write host and device together — a closure missed
    on the device would be a temporal leak."""

    _HOST = ("vf", "vt", "ver", "pos", "tids")
    _DEVICE = ("emb", "vf_dev", "vt_dev", "tids_dev")

    def __init__(self, dim: int, device=None):
        self.dim = dim
        self.n = 0
        self.device = resolve_device(device)
        cap = 1024
        dev = self.device
        self.emb = torch.zeros((cap, dim), dtype=torch.float32, device=dev)
        self.vf_dev = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.vt_dev = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.tids_dev = torch.zeros(cap, dtype=torch.int32, device=dev)
        self.vf = np.zeros(cap, np.int64)
        self.vt = np.zeros(cap, np.int64)
        self.ver = np.zeros(cap, np.int32)
        self.pos = np.zeros(cap, np.int64)
        self.tids = np.zeros(cap, np.int32)
        self.chunk_ids: list[str] = []
        self.doc_ids: list[str] = []
        self.texts: list[str] = []
        self.open_idx: dict[tuple[str, int], int] = {}
        self.applied_version = 0

    def _reserve(self, m: int) -> None:
        need = self.n + m
        cap = self.vf.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in self._HOST:
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], old.dtype)
            new[:self.n] = old[:self.n]
            setattr(self, name, new)
        for name in self._DEVICE:
            old = getattr(self, name)
            new = torch.zeros((cap,) + tuple(old.shape[1:]), dtype=old.dtype,
                              device=old.device)
            new[:self.n] = old[:self.n]
            setattr(self, name, new)

    def _push(self, lo: int, hi: int, emb_f32: np.ndarray) -> None:
        """Land rows [lo, hi) on the device: their embeddings, and their
        validity and tenant columns as the host now holds them."""
        self.emb[lo:hi] = torch.as_tensor(np.asarray(emb_f32, np.float32))
        self.vf_dev[lo:hi] = torch.from_numpy(self.vf[lo:hi])
        self.vt_dev[lo:hi] = torch.from_numpy(self.vt[lo:hi])
        self.tids_dev[lo:hi] = torch.from_numpy(self.tids[lo:hi])

    def _close(self, closures) -> None:
        """Close the open rows named by ``closures`` in place, on the
        host and on the device."""
        rows = []
        for c in closures:
            row = self.open_idx.pop((c["doc_id"], int(c["position"])), None)
            if row is not None:
                self.vt[row] = int(c["closed_at"])
                rows.append(row)
        if rows:
            rows = np.asarray(rows, np.int64)
            self.vt_dev[torch.from_numpy(rows).to(self.device)] = \
                torch.from_numpy(self.vt[rows]).to(self.device)

    def seed(self, snap: ColdSnapshot, applied_version: int) -> None:
        """Initialize from a full-history (include_closed) snapshot."""
        m = len(snap)
        self._reserve(m)
        self.vf[:m] = snap.valid_from
        self.vt[:m] = snap.valid_to
        self.ver[:m] = snap.version
        self.pos[:m] = snap.position
        self.tids[:m] = snap.tenants()
        self._push(0, m, snap.embeddings)
        self.chunk_ids = list(snap.chunk_ids)
        self.doc_ids = list(snap.doc_ids)
        self.texts = list(snap.texts)
        self.n = m
        self.open_idx = {}
        for i in range(m):                    # last-wins = fold semantics
            if self.vt[i] == VALID_TO_OPEN:
                self.open_idx[(self.doc_ids[i], int(self.pos[i]))] = i
        self.applied_version = applied_version

    def apply_records(self, records, closures, version: int) -> int:
        """Fold one commit's IN-MEMORY delta (the exact records/closures
        ``ColdTier.commit`` just serialized) — the write-hot path never
        re-reads the segment it wrote milliseconds earlier. Semantics
        are identical to ``apply_entry`` on the durable log entry."""
        self._close(closures)
        m = len(records)
        if m == 0:
            return 0
        self._reserve(m)
        block = np.stack([np.asarray(r.embedding, np.float32)
                          for r in records])
        for i, r in enumerate(records):
            j = self.n + i
            self.vf[j] = r.valid_from
            self.vt[j] = r.valid_to
            self.ver[j] = version
            self.pos[j] = r.position
            self.tids[j] = r.tenant_id
            self.chunk_ids.append(r.chunk_id)
            self.doc_ids.append(r.doc_id)
            self.texts.append(r.text)
            if r.valid_to == VALID_TO_OPEN:
                self.open_idx[(r.doc_id, int(r.position))] = j
        self._push(self.n, self.n + m, block)
        self.n += m
        return m

    def apply_entry(self, cold: ColdTier, entry: dict) -> int:
        """Fold one committed log entry into the resident columns:
        closures mutate valid_to in place, appended records extend the
        arrays. Returns the number of rows appended."""
        self._close(entry["closures"])
        if not entry["segment"]:
            return 0
        seg = cold.load_segment(entry["segment"], entry.get("checksum"))
        m = len(seg["position"])
        self._reserve(m)
        s = slice(self.n, self.n + m)
        self.vf[s] = seg["valid_from"]
        self.vt[s] = seg["valid_to"]
        self.ver[s] = seg["version"]
        self.pos[s] = seg["position"]
        self.tids[s] = seg.get("tenant_ids",
                               np.zeros(m, np.int32))
        self._push(self.n, self.n + m, seg["embeddings"])
        doc_ids = seg["doc_ids"].tolist()
        self.chunk_ids.extend(seg["chunk_ids"].tolist())
        self.doc_ids.extend(doc_ids)
        self.texts.extend(seg["texts"].tolist())
        for i in range(m):
            if self.vt[self.n + i] == VALID_TO_OPEN:
                self.open_idx[(doc_ids[i], int(seg["position"][i]))] = \
                    self.n + i
        self.n += m
        return m

    def views(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(embedding column, valid_from, valid_to) device views."""
        return self.emb[:self.n], self.vf_dev[:self.n], self.vt_dev[:self.n]

    def visible(self, visible: np.ndarray) -> torch.Tensor:
        """(n,) device bool: rows whose tenant is in ``visible`` (the
        sorted visible tenant-id array), computed on the device."""
        ids = torch.as_tensor(np.asarray(visible, np.int32),
                              device=self.device)
        return torch.isin(self.tids_dev[:self.n], ids)


def _snapshot_results(snap: ColdSnapshot, scores: np.ndarray,
                      idx: np.ndarray, k: int,
                      namer=None) -> list[SearchResult]:
    out = []
    tids = snap.tenant_ids if namer is not None else None
    for j in range(min(k, idx.shape[0])):
        i, s = int(idx[j]), float(scores[j])
        if not np.isfinite(s):
            continue
        out.append(SearchResult(
            chunk_id=snap.chunk_ids[i], doc_id=snap.doc_ids[i],
            position=int(snap.position[i]), score=s, text=snap.texts[i],
            valid_from=int(snap.valid_from[i]), valid_to=int(snap.valid_to[i]),
            version=int(snap.version[i]), tier="cold",
            tenant=(namer(int(tids[i]))
                    if namer is not None and tids is not None else "")))
    return out


class TemporalEngine:
    """Cold-path execution, batched over a (Q, d) query block.

    FUSED default: one fused validity-masked score+top-k kernel dispatch
    over the resident full-history arrays per query block — the validity
    interval test runs per query INSIDE the kernel, so no point-in-time
    copy is ever materialized and latency is independent of how many
    versions of history exist.

    ORACLE (``fused=False``): snapshot load (checkpoint-seeded log fold,
    memoized by (latest cold version, ts)) -> pure-NumPy reference
    scoring. This is the paper-faithful path and the reference the fused
    path is gated against."""

    SNAP_CACHE_MAX = 32

    def __init__(self, cold: ColdTier, fused: bool = True,
                 quantized: bool = False, rescore_factor: int = 4,
                 device=None):
        """``device``: where the resident history lives and the fused
        kernel runs (None = the CUDA device; raises without one — pass
        "cpu" for the plain path). ``quantized=True`` (the int8 history)
        is not ported yet and raises."""
        if quantized:
            raise NotImplementedError(Q8_NOT_PORTED)
        self.cold = cold
        self.device = resolve_device(device)
        self.fused = fused
        self.quantized = bool(quantized)
        self.rescore_factor = int(rescore_factor)
        # tenant-id -> name resolver for result labeling (wired by the
        # owning store; None leaves SearchResult.tenant = "")
        self.tenant_namer = None
        self._resident: Optional[ResidentHistory] = None
        self._snap_cache: dict[tuple, ColdSnapshot] = {}
        # serializes resident-history mutation (on_commit from the write
        # thread, the safety _advance from query threads) and snap-cache
        # bookkeeping — the fused kernel itself runs on array refs taken
        # under the lock, which stay consistent after release because
        # appends land beyond the sliced n (DESIGN.md §13)
        self._lock = threading.RLock()
        self.snap_hits = 0
        self.snap_misses = 0
        self.resident_builds = 0
        self.resident_appended_rows = 0
        self.fused_dispatches = 0

    def invalidate(self) -> None:
        """Full reset (store recovery / external log mutation): the next
        query re-seeds the resident columns from the checkpointed fold."""
        with self._lock:
            self._resident = None
            self._snap_cache.clear()

    def on_commit(self, version: Optional[int] = None,
                  records=None, closures=None) -> None:
        """Called by the store after every cold-tier commit: advance the
        resident columns by the delta only — O(new rows), not
        O(history). When the committer passes its in-memory
        (version, records, closures) and the resident is exactly one
        version behind, they are applied directly — no segment re-read;
        otherwise fall back to replaying the durable log entries."""
        with self._lock:
            self._snap_cache.clear()
            res = self._resident
            if res is None:
                return                        # lazily seeded on first query
            if (version is not None and records is not None
                    and res.applied_version == version - 1):
                self.resident_appended_rows += res.apply_records(
                    records, closures or [], version)
                res.applied_version = version
                return
            self._advance(res)

    def _advance(self, res: ResidentHistory) -> None:
        latest = self.cold.latest_version()
        if res.applied_version >= latest:
            return
        for e in self.cold.read_entries(res.applied_version + 1, latest):
            try:
                self.resident_appended_rows += res.apply_entry(self.cold, e)
            except CorruptionError:
                # containment (DESIGN.md §16): quarantine the rotten
                # segment (affected docs from its zone map) and drop the
                # half-advanced resident — apply_entry mutated closures
                # before the load failed, so partial state is unusable.
                # The next query re-seeds from the quarantine-skipping
                # fold: the store keeps serving minus the lost rows.
                self.cold.quarantine_segment(
                    e, "checksum mismatch during resident advance")
                self._resident = None
                self._snap_cache.clear()
                return
        res.applied_version = latest

    def _resident_history(self) -> ResidentHistory:
        with self._lock:
            if self._resident is not None:
                self._advance(self._resident)  # safety: never serve stale
            if self._resident is None:
                # (re)seed — also the corruption-containment path:
                # ``_advance`` nulls a resident poisoned by a rotten
                # segment, and the quarantine-skipping fold rebuilds the
                # columns here without the lost rows
                res = ResidentHistory(self.cold.dim, device=self.device)
                snap = self.cold.snapshot(include_closed=True)
                latest = self.cold.latest_version()
                res.seed(snap, latest)
                self._resident = res
                self.resident_builds += 1
            return self._resident

    def _snapshot_at(self, ts: Optional[int], include_closed: bool = False
                     ) -> ColdSnapshot:
        """Memoized ``ColdTier.snapshot``; FIFO-bounded. The cold tier is
        append-only, so a (latest version, ts) snapshot is immutable."""
        with self._lock:
            key = (self.cold.latest_version(), ts, include_closed)
            snap = self._snap_cache.get(key)
            if snap is not None:
                self.snap_hits += 1
                return snap
            self.snap_misses += 1
        snap = self.cold.snapshot(as_of_ts=ts,
                                  include_closed=include_closed)
        with self._lock:
            while len(self._snap_cache) >= self.SNAP_CACHE_MAX:
                self._snap_cache.pop(next(iter(self._snap_cache)))
            self._snap_cache[key] = snap
        return snap

    # ------------------------------------------------------------------
    # point-in-time
    # ------------------------------------------------------------------
    def query_at(self, q_vec: np.ndarray, ts: int, k: int = 5,
                 visible: Optional[np.ndarray] = None
                 ) -> list[SearchResult]:
        return self.query_at_batch(
            np.asarray(q_vec, np.float32).reshape(1, -1), ts, k=k,
            visible=visible)[0]

    def query_at_batch(self, queries: np.ndarray, ts: int, k: int = 5,
                       visible: Optional[np.ndarray] = None
                       ) -> list[list[SearchResult]]:
        """Point-in-time retrieval for a whole (Q, d) query block: ONE
        fused validity-masked score+top-k dispatch over the resident
        full-history arrays (no per-ts materialized copy). ``visible``
        is the resolved visible-tenant-id array (None = unscoped),
        enforced pre-ranking (see ``_fused_topk``)."""
        if not self.fused:
            return self._oracle_at_batch(queries, ts, k=k, visible=visible)
        qp, nq = pad_queries(queries)
        res = self._resident_history()
        if res.n == 0:
            return [[] for _ in range(nq)]
        bounds = np.full(qp.shape[0], int(ts), np.int64)
        scores, idx = self._fused_topk(qp, nq, res, bounds, bounds + 1,
                                       min(k, res.n), visible=visible)
        return [self._resident_results(res, scores[qi], idx[qi], k)
                for qi in range(nq)]

    def _fused_topk(self, qp: np.ndarray, nq: int, res: ResidentHistory,
                    t0s: np.ndarray, t1s: np.ndarray, k: int,
                    visible: Optional[np.ndarray] = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """One fused validity-masked dispatch over the resident history
        on its device; only the (Q, k) results come back to the host.

        Tenant visibility pushdown (DESIGN.md §14): rows outside the
        visible tenant set get ``valid_from = VALID_TO_OPEN`` — an
        always-empty validity interval — so the UNCHANGED fused kernel
        masks them to -inf/-1 BEFORE ranking, exactly like a temporally
        invalid row. The pushdown runs on the device (``torch.where``
        over the resident tenant column)."""
        with obs.span("fused_temporal"):
            emb, vf, vt = res.views()
            if visible is not None:
                vf = torch.where(res.visible(visible), vf, VALID_TO_OPEN)
            from ..kernels.temporal_mask_score.ops import (
                temporal_window_topk)
            qd = torch.as_tensor(np.ascontiguousarray(qp), device=res.device)
            scores, idx = temporal_window_topk(qd, emb, vf, vt, t0s, t1s, k)
            # the fused temporal block reads the whole resident history
            # once per BATCH, same convention as the hot fused scan
            obs.scan_row_reads(
                res.n, nq, per_query=False, source="fused_temporal",
                row_bytes=emb.shape[1] * 4)
            self.fused_dispatches += 1
            return scores.cpu().numpy(), idx.cpu().numpy()

    def _oracle_at_batch(self, queries: np.ndarray, ts: int, k: int = 5,
                         visible: Optional[np.ndarray] = None
                         ) -> list[list[SearchResult]]:
        """Paper-faithful reference: materialize the snapshot at ts via
        the log fold, score with the pure-NumPy oracle kernel. Tenant
        scoping uses the same empty-interval trick as the fused path so
        both paths stay result-identical."""
        from ..kernels.temporal_mask_score.ref import temporal_topk_ref

        qp, nq = pad_queries(queries)
        snap = self._snapshot_at(ts)
        if len(snap) == 0:
            return [[] for _ in range(nq)]
        vf = snap.valid_from
        if visible is not None:
            vis = visible_rows(snap.tenants(), visible)
            vf = np.where(vis, vf, VALID_TO_OPEN)
        scores, idx = temporal_topk_ref(qp, snap.embeddings, vf,
                                        snap.valid_to, ts, min(k, len(snap)))
        return [_snapshot_results(snap, scores[qi], idx[qi], k,
                                  namer=self.tenant_namer)
                for qi in range(nq)]

    # ------------------------------------------------------------------
    # windows
    # ------------------------------------------------------------------
    def query_window(self, q_vec: np.ndarray, t0: int, t1: int,
                     k: int = 5, visible: Optional[np.ndarray] = None
                     ) -> list[SearchResult]:
        return self.query_window_batch(
            np.asarray(q_vec, np.float32).reshape(1, -1), t0, t1, k=k,
            visible=visible)[0]

    def query_window_batch(self, queries: np.ndarray, t0: int, t1: int,
                           k: int = 5,
                           visible: Optional[np.ndarray] = None
                           ) -> list[list[SearchResult]]:
        """Records valid at ANY instant of [t0, t1): interval overlap
        (valid_from < t1) and (valid_to > t0), fused into the same kernel
        as the point path (a point query is the window [ts, ts+1))."""
        if not self.fused:
            return self._oracle_window_batch(queries, t0, t1, k=k,
                                             visible=visible)
        qp, nq = pad_queries(queries)
        res = self._resident_history()
        if res.n == 0:
            return [[] for _ in range(nq)]
        t0s = np.full(qp.shape[0], int(t0), np.int64)
        t1s = np.full(qp.shape[0], int(t1), np.int64)
        scores, idx = self._fused_topk(qp, nq, res, t0s, t1s,
                                       min(k, res.n), visible=visible)
        return [self._resident_results(res, scores[qi], idx[qi], k)
                for qi in range(nq)]

    def _oracle_window_batch(self, queries: np.ndarray, t0: int, t1: int,
                             k: int = 5,
                             visible: Optional[np.ndarray] = None
                             ) -> list[list[SearchResult]]:
        """NumPy reference over the materialized full-history fold."""
        qp, nq = pad_queries(queries)
        snap = self._full_history_snapshot()
        if len(snap) == 0:
            return [[] for _ in range(nq)]
        overlap = (snap.valid_from < t1) & (snap.valid_to > t0)
        if visible is not None:
            overlap &= visible_rows(snap.tenants(), visible)
        if not overlap.any():
            return [[] for _ in range(nq)]
        scores = (snap.embeddings @ qp.T).T[:nq]     # (Q, N)
        scores = np.where(overlap[None, :], scores, -np.inf)
        idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return [_snapshot_results(snap, scores[qi, idx[qi]], idx[qi], k,
                                  namer=self.tenant_namer)
                for qi in range(nq)]

    def _full_history_snapshot(self) -> ColdSnapshot:
        # ts=None folds everything: the same memo serves both shapes
        return self._snapshot_at(None, include_closed=True)

    def _resident_results(self, res: ResidentHistory, scores: np.ndarray,
                          idx: np.ndarray, k: int) -> list[SearchResult]:
        out = []
        for j in range(min(k, idx.shape[0])):
            i, s = int(idx[j]), float(scores[j])
            if not np.isfinite(s):
                continue
            namer = self.tenant_namer
            out.append(SearchResult(
                chunk_id=res.chunk_ids[i], doc_id=res.doc_ids[i],
                position=int(res.pos[i]), score=s, text=res.texts[i],
                valid_from=int(res.vf[i]), valid_to=int(res.vt[i]),
                version=int(res.ver[i]), tier="cold",
                tenant=(namer(int(res.tids[i])) if namer is not None
                        else "")))
        return out

    # ------------------------------------------------------------------
    def assert_no_leakage(self, results: list[SearchResult], ts: int) -> None:
        """Invariant check used by tests/benchmarks: every returned chunk's
        validity interval must cover the query instant."""
        for r in results:
            if not (r.valid_from <= ts < r.valid_to):
                raise AssertionError(
                    f"temporal leakage: chunk {r.chunk_id[:12]} valid "
                    f"[{r.valid_from}, {r.valid_to}) queried at {ts}")

    def assert_no_window_leakage(self, results: list[SearchResult],
                                 t0: int, t1: int) -> None:
        """Window variant: every returned chunk's validity interval must
        OVERLAP [t0, t1)."""
        for r in results:
            if not (r.valid_from < t1 and t0 < r.valid_to):
                raise AssertionError(
                    f"temporal window leakage: chunk {r.chunk_id[:12]} "
                    f"valid [{r.valid_from}, {r.valid_to}) queried for "
                    f"[{t0}, {t1})")
