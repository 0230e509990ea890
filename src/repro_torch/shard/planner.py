"""Scatter-gather query planner (DESIGN.md §10.3).

One fabric query fans the whole (Q, d) batch to every ring shard —
each shard runs its normal batched engine pass (hot fused top-k for
CURRENT, the fused temporal kernel over its own cold-tier resident
history for HISTORICAL/COMPARATIVE) — and the per-shard top-k blocks
are merged by the SAME ``merge_topk_candidates`` primitive the
segmented index uses internally: a shard really is just another
candidate source.

Correctness model (the oracle-equivalence guarantee, property-tested;
``results_equivalent`` below is its executable statement):

  - authority: a candidate counts iff its source shard is a CURRENT
    ring owner of the candidate's document. Copies left behind by a
    migration (stale pre-flip owners, mid-copy destinations) are
    filtered here, which is what lets rebalancing run online without a
    stop-the-world cutover.
  - replica dedup: with replication R an authoritative record arrives
    from R shards with identical record fields (replica lakes store
    identical rows); the first owner in shard order wins, so dedup is
    deterministic and never drops a distinct record.
  - merge: stable top-k by score over the (Q, S*k) candidate matrix —
    per-shard exact top-k blocks are supersets of each shard's
    contribution to the global top-k, so the merged result equals the
    single-lake result record for record and rank for rank wherever
    score gaps exceed float noise. Score BITS can differ from the
    oracle's by a few ulp: BLAS/XLA pick different accumulation
    kernels for different matrix shapes, so the same row scored inside
    a small shard matrix vs the oracle's big one may round differently
    (measurably: ids stay identical, scores agree to ~1e-6 relative).
    Within an equal-score run order is layout-dependent on BOTH sides
    (memtable slot order vs shard order) and therefore unordered.

One ring a gather: ``query_batch`` reads ``fabric.ring`` once and both
the scatter and the merge's ownership filter use that ring. A split
that flips between the two (R = 1) would otherwise filter the old
owners' candidates of moved docs by the new ring, which the scatter
never asked. This is where the port's copy differs: repro's
``shard/planner.py`` reads the ring again in its merge (ROADMAP Queue 3,
repaired in the port only; repro is the frozen reference).

Failure: a shard raising mid-gather is tolerated while fewer than R
shards failed (every record has R distinct owners, so some responding
owner still serves it); otherwise ``ShardGatherError`` fails just this
batch — the serving batcher maps that to the affected requests only.

Fault tolerance under SLO (DESIGN.md §13): with ``shard_timeout_s``
set (or a request deadline active) the scatter runs on a thread pool
and every shard gets a bounded reply window; per-shard transient
faults are retried with exponential backoff (``shard_retries``, off by
default). ANY gather missing >= 1 shard is stamped degraded
(``last_gather["degraded"]``/``shards_missing``, a ``degraded``
counter on the plan span, the fabric health report); while fewer than
R shards are missing the response is additionally ``complete`` —
replication still covers every record, so this is correct data served
at reduced redundancy. When >= R shards are missing, ``degraded_ok``
trades completeness for availability: the gather merges what arrived
rather than failing the batch. That mode is opt-in precisely because
it can under-report: a record whose every owner is missing is silently
absent from the merge.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from ..core.types import SearchResult
from ..index.lsm import merge_topk_candidates
from ..obs import Span, current_trace, span, subtrace
from ..serve.deadline import DeadlineExceeded, deadline_at
# defined in testing/ (the port's tests use it without the fabric);
# re-exported here, where repro defines it
from ..testing.equivalence import results_equivalent  # noqa: F401
from ..testing.faults import FAULTS


class ShardGatherError(RuntimeError):
    """Raised when >= R shards failed during a gather: some records may
    have no responding owner left, so the batch cannot be served
    completely (and is failed rather than served wrong)."""

    def __init__(self, failures: dict):
        self.failures = failures
        detail = "; ".join(f"{s}: {type(e).__name__}: {e}"
                           for s, e in sorted(failures.items()))
        super().__init__(f"{len(failures)} shard(s) failed mid-gather "
                         f"({detail})")


class ScatterGatherPlanner:
    def __init__(self, fabric, shard_timeout_s: Optional[float] = None,
                 shard_retries: int = 0, retry_backoff_s: float = 0.005,
                 degraded_ok: bool = False, max_workers: int = 8):
        self.fabric = fabric
        self.shard_timeout_s = shard_timeout_s
        self.shard_retries = int(shard_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.degraded_ok = bool(degraded_ok)
        self.max_workers = int(max_workers)
        self.stats = {"gathers": 0, "shard_failures": 0,
                      "shard_retries": 0, "degraded_gathers": 0,
                      "candidates_merged": 0, "dedup_dropped": 0,
                      "non_owner_dropped": 0}
        self.last_gather: Optional[dict] = None
        self._stats_lock = threading.Lock()
        self._pool = None              # lazy, parallel scatter only

    # ------------------------------------------------------------------
    def _one_shard(self, s: str, texts, k, at, window, visibility=None):
        """One shard's engine pass with bounded retry: transient faults
        (the chaos suite arms them at ``shard:<id>:query``) back off
        exponentially for up to ``shard_retries`` re-attempts before the
        shard counts as failed for this gather. ``visibility`` travels
        as tenant NAMES — each shard lake resolves them against its own
        registry (tid encodings are lake-local, DESIGN.md §14)."""
        last: Optional[Exception] = None
        for attempt in range(self.shard_retries + 1):
            if attempt:
                with self._stats_lock:
                    self.stats["shard_retries"] += 1
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            try:
                # inside the try so an armed transient fault is retryable
                FAULTS.check(f"shard:{s}:query")
                return self.fabric.lake(s).query_batch(
                    texts, k=k, at=at, window=window,
                    visibility=visibility)
            except Exception as e:  # noqa: BLE001 — shard fault domain
                last = e
        raise last

    def query_batch(self, texts: Sequence[str], k: int = 5,
                    at: Optional[int] = None,
                    window: Optional[tuple[int, int]] = None,
                    degraded_ok: Optional[bool] = None,
                    visibility=None
                    ) -> list[list[SearchResult]]:
        if not texts:
            return []
        if degraded_ok is None:
            degraded_ok = self.degraded_ok
        with span("plan") as plan_sp:
            ring = self.fabric.ring
            per_shard: dict[str, list[list[SearchResult]]] = {}
            failures: dict[str, Exception] = {}
            if self.shard_timeout_s is not None \
                    or deadline_at() is not None:
                self._scatter_parallel(ring, texts, k, at, window,
                                       per_shard, failures, plan_sp,
                                       visibility=visibility)
            else:
                # sequential scatter: the default path, span-for-span
                # identical to the pre-§13 planner
                for s in ring.shards:
                    with span(f"shard:{s}"):
                        try:
                            per_shard[s] = self._one_shard(
                                s, texts, k, at, window,
                                visibility=visibility)
                        except Exception as e:  # noqa: BLE001
                            failures[s] = e
            with self._stats_lock:
                self.stats["gathers"] += 1
                self.stats["shard_failures"] += len(failures)
            plan_sp.add("queries", len(texts))
            plan_sp.add("shards", len(ring.shards))
            plan_sp.add("shard_failures", len(failures))
            # degraded = the gather is missing >= 1 shard's reply;
            # complete = replication still guarantees full coverage
            # (fewer than R shards missing). A complete-but-degraded
            # response is correct data served at reduced redundancy —
            # stamped so clients/SLO dashboards see the shrunk fabric.
            # storage-integrity degradation (DESIGN.md §16): a shard
            # with unrepaired data loss answered, but minus quarantined
            # rows. Only OPEN lakes are consulted (pending() reads a
            # cached manifest — cheap), so the stamp costs nothing on a
            # healthy fabric and never forces a lake open.
            integ_degraded = sorted(
                s for s, lk in self.fabric._lakes.items()
                if lk.store.integrity.degraded())
            degraded = bool(failures) or bool(integ_degraded)
            complete = len(failures) < ring.replicas
            if failures and not complete:
                if not (degraded_ok and per_shard):
                    if not per_shard:
                        dl = deadline_at()
                        if dl is not None and time.perf_counter() >= dl:
                            raise DeadlineExceeded(
                                "plan: every shard timed out past the "
                                "request deadline")
                    raise ShardGatherError(failures)
            if degraded:
                with self._stats_lock:
                    self.stats["degraded_gathers"] += 1
                plan_sp.add("degraded", 1)
                plan_sp.add("shards_missing", len(failures))
                # stamp the whole REQUEST degraded (DESIGN.md §15): the
                # flight recorder always retains degraded traces and
                # SLOs with degraded_bad burn budget on them
                tr = current_trace()
                if tr is not None:
                    tr.attrs["degraded"] = True
            self.last_gather = {
                "degraded": degraded,
                "complete": complete,
                "shards_missing": sorted(failures),
                "integrity_degraded": integ_degraded,
                "failures": {s: f"{type(e).__name__}: {e}"
                             for s, e in failures.items()},
            }
            return self._merge(texts, per_shard, k, ring)

    def _scatter_parallel(self, ring, texts, k, at, window,
                          per_shard: dict, failures: dict,
                          plan_sp, visibility=None) -> None:
        """Thread-pool scatter with a bounded reply window per gather:
        min(shard_timeout_s from now, the active request deadline). A
        shard that misses the window counts as failed for THIS gather;
        its worker thread finishes harmlessly in the background (the
        result is discarded). Worker threads don't inherit the trace
        contextvar, so each opens a detached ``subtrace`` whose finished
        root is grafted under the plan span."""
        from concurrent.futures import (ThreadPoolExecutor,
                                        TimeoutError as FutTimeout)
        t0 = time.perf_counter()
        limit = (t0 + self.shard_timeout_s
                 if self.shard_timeout_s is not None else None)
        dl = deadline_at()
        if dl is not None and (limit is None or dl < limit):
            limit = dl
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(1, self.max_workers),
                thread_name_prefix="scatter")

        def one(s: str):
            with subtrace(f"shard:{s}") as sroot:
                return self._one_shard(s, texts, k, at, window,
                                       visibility=visibility), sroot

        futs = {s: self._pool.submit(one, s) for s in ring.shards}
        graft = getattr(plan_sp, "children", None)
        for s in ring.shards:
            timeout = (None if limit is None
                       else max(0.0, limit - time.perf_counter()))
            try:
                res, sroot = futs[s].result(timeout=timeout)
                per_shard[s] = res
                if graft is not None and isinstance(sroot, Span):
                    graft.append(sroot)
            except FutTimeout:
                futs[s].cancel()
                failures[s] = TimeoutError(
                    f"shard {s}: no reply within the gather window")
            except Exception as e:  # noqa: BLE001 — shard fault domain
                failures[s] = e

    # ------------------------------------------------------------------
    def _merge(self, texts: Sequence[str],
               per_shard: dict[str, list[list[SearchResult]]], k: int,
               ring) -> list[list[SearchResult]]:
        """Build the (Q, S*k) candidate matrix + the per-candidate
        authority mask (ownership AND replica-dedup) under ``ring``, the
        ring the scatter read, and run the shared stable top-k merge."""
        with span("merge") as merge_sp:
            return self._merge_inner(texts, per_shard, k, merge_sp, ring)

    def _merge_inner(self, texts, per_shard, k, merge_sp, ring
                     ) -> list[list[SearchResult]]:
        shards = [s for s in ring.shards if s in per_shard]
        nq = len(texts)
        width = max(len(shards) * k, 1)
        scores = np.full((nq, width), -np.inf, np.float32)
        gids = np.full((nq, width), -1, np.int64)
        auth = np.zeros((nq, width), bool)
        refs: list[list[Optional[SearchResult]]] = \
            [[None] * width for _ in range(nq)]
        owners_memo: dict[str, tuple[str, ...]] = {}
        non_owner = dedup = 0          # flushed under the lock once
        for qi in range(nq):
            seen: set[tuple] = set()   # replica dedup, per query
            for si, s in enumerate(shards):
                for j, r in enumerate(per_shard[s][qi]):
                    col = si * k + j   # shard blocks stay column-aligned
                    scores[qi, col] = np.float32(r.score)
                    gids[qi, col] = col
                    refs[qi][col] = r
                    owners = owners_memo.get(r.doc_id)
                    if owners is None:
                        owners = ring.owners(r.doc_id)
                        owners_memo[r.doc_id] = owners
                    if s not in owners:
                        non_owner += 1
                    else:
                        ident = (r.doc_id, r.position, r.valid_from)
                        if ident in seen:
                            dedup += 1
                        else:
                            seen.add(ident)
                            auth[qi, col] = True
        with self._stats_lock:
            self.stats["non_owner_dropped"] += non_owner
            self.stats["dedup_dropped"] += dedup
            self.stats["candidates_merged"] += int(auth.sum())
        merge_sp.add("candidates", int(auth.sum()))
        top_s, top_g = merge_topk_candidates(scores, gids, auth, k)
        out: list[list[SearchResult]] = []
        for qi in range(nq):
            res = []
            for j in range(top_g.shape[1]):
                g = int(top_g[qi, j])
                if g >= 0 and np.isfinite(top_s[qi, j]):
                    res.append(refs[qi][g])
            out.append(res)
        return out


def device_fanout_topk(queries, emb_stack, mask_stack, k: int,
                       devices=None, mesh=None):
    """Device fan-out hook (DESIGN.md §10.5): score a (Q, d) query block
    against S shard-local corpora stacked as (S, N_pad, d) with alive
    masks (S, N_pad), returning per-shard candidate blocks
    (scores (S, Q, k), idx (S, Q, k)) ready for the planner merge.

    Each shard's score path is ONE fused top-k kernel call
    (kernels/topk_search) on its own contiguous (N_pad, d) slice; every
    call is issued before the first host sync, and only the small
    (S, Q, k) blocks come back. NumPy stacks go to ``devices`` (default:
    the CUDA device, an error where there is none; ``["cpu"]`` runs the
    kernel's plain version): when ``len(devices)`` divides S, each
    device takes a contiguous block of shards, otherwise every shard
    runs on ``devices[0]``. Torch stacks stay on the device they lie on,
    so a resident corpus is not copied each call.

    With ``mesh`` (one rank of a ``DeviceMesh``; every rank calls with
    the same arguments), the shard dimension is split over the
    data-parallel axes by ``launch/sharding.fabric_fanout_specs``: the
    rank scores its own block of shards (one ``topk_search`` a shard, on
    the mesh's device) and the (S, Q, k) blocks are all-gathered. A DP
    extent that does not divide S leaves every rank all the shards."""
    import torch

    from ..kernels.common import resolve_device
    from ..kernels.topk_search.ops import topk_search

    q = np.atleast_2d(np.asarray(queries, np.float32))
    n_shards, n_pad = int(emb_stack.shape[0]), int(emb_stack.shape[1])
    k = int(min(k, n_pad)) if n_pad else 0
    if n_shards == 0 or k == 0:
        return (np.zeros((n_shards, q.shape[0], 0), np.float32),
                np.zeros((n_shards, q.shape[0], 0), np.int32))
    if mesh is not None:
        return _fanout_on_mesh(q, emb_stack, mask_stack, k, mesh)
    if isinstance(emb_stack, torch.Tensor):
        emb = emb_stack.to(torch.float32)
        mask = torch.as_tensor(mask_stack).to(emb.device, torch.bool)
        homes = [emb.device] * n_shards
    else:
        devs = [resolve_device(d) for d in (devices or [None])]
        per = n_shards // len(devs) if n_shards % len(devs) == 0 else n_shards
        homes = [devs[si // per] for si in range(n_shards)]
        emb = np.asarray(emb_stack, np.float32)
        mask = np.asarray(mask_stack, bool)
    blocks: dict = {}                   # device -> its shards' tensors
    for si, dev in enumerate(homes):
        blocks.setdefault(dev, []).append(si)
    out = [None] * n_shards
    for dev, shards in blocks.items():
        lo, hi = shards[0], shards[-1] + 1
        e_dev = torch.as_tensor(emb[lo:hi]).to(dev)
        m_dev = torch.as_tensor(mask[lo:hi]).to(dev)
        q_dev = torch.as_tensor(q).to(dev)
        for si in shards:
            out[si] = topk_search(q_dev, e_dev[si - lo].contiguous(),
                                  m_dev[si - lo].contiguous(), k)
    return (np.stack([o[0].cpu().numpy() for o in out]),
            np.stack([o[1].cpu().numpy() for o in out]))


def _fanout_on_mesh(q: np.ndarray, emb_stack, mask_stack, k: int, mesh):
    """``device_fanout_topk`` on one rank of ``mesh``."""
    import torch

    from ..kernels.common import resolve_device
    from ..kernels.topk_search.ops import topk_search
    from ..launch.collectives import all_gather
    from ..launch.mesh import coordinate
    from ..launch.sharding import fabric_fanout_specs, local_slice

    n_shards = int(emb_stack.shape[0])
    _, emb_spec, _, _ = fabric_fanout_specs(mesh, n_shards)
    dev = resolve_device(None if mesh.device_type == "cuda" else
                         mesh.device_type)
    rows = local_slice((n_shards,), emb_spec[:1], mesh,
                       coordinate(mesh))[0]
    emb = torch.as_tensor(emb_stack[rows]).to(dev, torch.float32)
    mask = torch.as_tensor(mask_stack[rows]).to(dev, torch.bool)
    q_dev = torch.as_tensor(q).to(dev)
    out = [topk_search(q_dev, emb[i].contiguous(), mask[i].contiguous(), k)
           for i in range(emb.shape[0])]
    s = torch.stack([o[0] for o in out])
    i = torch.stack([o[1] for o in out])
    if emb_spec[0] is not None:
        s = all_gather(s, mesh, emb_spec[0], dim=0)
        i = all_gather(i, mesh, emb_spec[0], dim=0)
    return s.cpu().numpy(), i.cpu().numpy()
