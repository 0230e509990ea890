"""IVF (inverted-file) index: the sub-linear hot-tier search path for
larger-than-exact-scan corpora (DESIGN.md §2 — ScaNN/TPU-KNN style).

k-means centroids partition the corpus; a query scores all centroids
(tiny matmul), visits the ``nprobe`` nearest partitions, and runs the
exact fused top-k only inside them. Recall is controlled by nprobe
(nprobe == n_centroids -> exact). Centroid assignment and scan both run
as dense MXU matmuls — no pointer chasing, static shapes, shardable by
partition.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import pad_queries


@dataclasses.dataclass
class IVFStats:
    n_centroids: int
    n_vectors: int
    fraction_scanned: float


class IVFIndex:
    def __init__(self, n_centroids: int = 64, n_iters: int = 10,
                 seed: int = 0):
        self.n_centroids = n_centroids
        self.n_iters = n_iters
        self.seed = seed
        self.centroids: np.ndarray | None = None     # (C, d)
        self._lists: list[np.ndarray] = []           # row ids per centroid
        self._vectors: np.ndarray | None = None
        self._members: np.ndarray | None = None      # (C, Lmax), -1-padded
        self._vq8: np.ndarray | None = None          # quantized scan copy
        self._vscale: np.ndarray | None = None
        self._f32_fetch = None
        self.rescore_factor = 4

    # -- build ----------------------------------------------------------
    def build(self, vectors: np.ndarray) -> None:
        """Lloyd k-means (deterministic seed), then invert."""
        v = np.asarray(vectors, np.float32)
        n = v.shape[0]
        c = min(self.n_centroids, n)
        rng = np.random.default_rng(self.seed)
        centroids = v[rng.choice(n, c, replace=False)].copy()
        for _ in range(self.n_iters):
            assign = np.argmax(v @ centroids.T, axis=1)
            for j in range(c):
                members = v[assign == j]
                if len(members):
                    centroids[j] = members.mean(0)
            norms = np.linalg.norm(centroids, axis=1, keepdims=True)
            centroids = centroids / np.maximum(norms, 1e-9)
        assign = np.argmax(v @ centroids.T, axis=1)
        self.centroids = centroids
        self._vectors = v
        self._assign = assign
        self._lists = [np.nonzero(assign == j)[0] for j in range(c)]
        self._members = None

    def restore(self, centroids: np.ndarray, vectors: np.ndarray | None,
                assign: np.ndarray) -> None:
        """Rebuild from persisted state (centroids + per-row partition
        assignment) without re-running k-means — segments are immutable,
        so their partitioning is serialized once at seal time.
        ``vectors`` may be None for a quantized segment whose fp32 rows
        stayed on disk: ``attach_quantized`` supplies the scan copy."""
        self.centroids = np.asarray(centroids, np.float32)
        self._vectors = (None if vectors is None
                         else np.asarray(vectors, np.float32))
        self._assign = np.asarray(assign, np.int64)
        c = self.centroids.shape[0]
        self._lists = [np.nonzero(self._assign == j)[0] for j in range(c)]
        self._members = None

    # -- quantized scan (DESIGN.md §11) ---------------------------------
    def attach_quantized(self, q8: np.ndarray, scale: np.ndarray,
                         f32_fetch, rescore_factor: int = 4) -> None:
        """Switch the member scan to int8 asymmetric scoring: gathered
        candidate rows are read at 1 byte/element and scored against the
        scale-folded query; the over-fetched pool (rescore_factor * k)
        is exactly rescored in fp32 through ``f32_fetch`` (the segment's
        winners-row cache), so returned scores remain fp32-exact."""
        self._vq8 = np.asarray(q8, np.int8)
        self._vscale = np.asarray(scale, np.float32)
        self._f32_fetch = f32_fetch
        self.rescore_factor = int(rescore_factor)

    def release_f32(self) -> None:
        """Drop the resident fp32 rows (quantized path armed)."""
        assert getattr(self, "_vq8", None) is not None
        self._vectors = None

    def _member_table(self) -> np.ndarray:
        """Partition member lists as one -1-padded (C, Lmax) array, so a
        batch's candidate rows come from one fancy-index instead of a
        per-query list concatenation."""
        if self._members is None:
            lmax = max((len(l) for l in self._lists), default=0)
            m = np.full((len(self._lists), max(lmax, 1)), -1, np.int64)
            for j, l in enumerate(self._lists):
                m[j, :len(l)] = l
            self._members = m
        return self._members

    # -- search -----------------------------------------------------------
    def search(self, queries: np.ndarray, k: int = 5, nprobe: int = 8,
               mask: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray, IVFStats]:
        """Batched search. Returns (scores (Q, k), row ids (Q, k), stats).

        Centroid routing for the whole batch is ONE matmul + one top-k;
        candidate rows for the whole batch come from one fancy-index of
        the padded member table. Per-candidate scoring stays a per-query
        matvec over that query's own candidate rows — the matvec shape
        depends only on the query's probe set, never on the batch size,
        so a query's scores are bit-identical whether it runs alone or
        inside a batch (the engine's batch==sequential guarantee).

        ``mask`` (N,) bool, optional: rows with mask=False (tombstoned
        slots in a sealed segment) are skipped before scoring, so they can
        never rank — the segmented index's deletion-vector path.
        """
        assert self.centroids is not None, "build() first"
        qp, nq = pad_queries(queries)
        q = qp[:nq]
        nprobe = min(nprobe, len(self._lists))
        c_scores = qp @ self.centroids.T                  # (Q, C): routing
        probe = np.argsort(-c_scores[:nq], axis=1,
                           kind="stable")[:, :nprobe]
        out_s = np.full((nq, k), -np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        quantized = self._vq8 is not None
        n_rows = len(self._vq8 if quantized else self._vectors)
        if quantized:
            scanned = self._search_q8(q, probe, mask, k, out_s, out_i)
        else:
            members = self._member_table()
            cand = members[probe].reshape(nq, -1)         # (Q, nprobe*Lmax)
            keep = cand >= 0
            if mask is not None:
                keep &= mask[np.clip(cand, 0, None)]
            scanned = int(np.count_nonzero(keep))
            for qi in range(nq):
                rows = cand[qi][keep[qi]]
                if len(rows) == 0:
                    continue
                scores = self._vectors[rows] @ q[qi]
                top = np.argsort(-scores, kind="stable")[:k]
                out_s[qi, : len(top)] = scores[top]
                out_i[qi, : len(top)] = rows[top]
        stats = IVFStats(len(self._lists), n_rows,
                         scanned / max(nq * n_rows, 1))
        return out_s, out_i, stats

    def _search_q8(self, q: np.ndarray, probe: np.ndarray,
                   mask: np.ndarray | None, k: int,
                   out_s: np.ndarray, out_i: np.ndarray) -> int:
        """Quantized member scan (DESIGN.md §11): ONE integer-GEMM over
        the UNION of the batch's probed partitions (rows gathered at
        1 byte/element), partition-level membership masking, pool
        selection, and ONE exact fp32 rescore of all pools. Integer dot
        products are exact, so union-batching is BIT-identical to
        scanning each query's candidate rows alone — the engine's
        batch==sequential guarantee holds with none of the per-query
        dispatch overhead. Returns the batch's total candidate count
        (same pruning-selectivity stat as the fp32 path)."""
        from ..index.quant import pool_k, rescore_topk
        from ..kernels.qscan import asym_scores_host
        nq = q.shape[0]
        n_rows = len(self._vq8)
        parts_u = np.unique(probe)
        rows_u = np.concatenate([self._lists[p] for p in parts_u]) \
            if len(parts_u) else np.zeros(0, np.int64)
        if mask is not None and len(rows_u):
            rows_u = rows_u[mask[rows_u]]
        if len(rows_u) == 0:
            return 0
        # membership by PARTITION id: row r is a candidate for query qi
        # iff assign[r] is among qi's probed partitions — one (Q, U)
        # boolean gather instead of row-level searchsorted
        pmask = np.zeros((nq, self.centroids.shape[0]), bool)
        pmask[np.repeat(np.arange(nq), probe.shape[1]), probe.ravel()] = True
        member = pmask[:, self._assign[rows_u]]           # (Q, U)
        scanned = int(member.sum())
        approx = asym_scores_host(q * self._vscale[None, :],
                                  self._vq8[rows_u])      # (Q, U)
        approx[~member] = -np.inf
        kp = min(pool_k(k, n_rows, self.rescore_factor), len(rows_u))
        if kp < len(rows_u):
            part = np.argpartition(-approx, kp - 1, axis=1)[:, :kp]
            part_s = np.take_along_axis(approx, part, axis=1)
            # boundary-tie repair: argpartition splits ties at the pool
            # cut arbitrarily, and its choice depends on the batch-
            # dependent layout of rows_u — which would break
            # batch==sequential bit-identity. Whenever the kp-th score
            # ties with unselected entries, re-pick that row's tied
            # slots by ascending row id (layout-independent).
            t = part_s.min(axis=1)
            spans_cut = ((approx == t[:, None]).sum(axis=1)
                         > (part_s == t[:, None]).sum(axis=1))
            for qi in np.nonzero(spans_cut)[0]:
                strict = np.nonzero(approx[qi] > t[qi])[0]
                ties = np.nonzero(approx[qi] == t[qi])[0]
                ties = ties[np.argsort(rows_u[ties], kind="stable")]
                part[qi] = np.concatenate(
                    [strict, ties[:kp - len(strict)]])
                part_s[qi] = approx[qi][part[qi]]
        else:
            part = np.broadcast_to(np.arange(len(rows_u)),
                                   (nq, len(rows_u))).copy()
            part_s = np.take_along_axis(approx, part, axis=1)
        # stable pool order: approx score desc, row id asc
        order = np.lexsort((np.take_along_axis(
            np.broadcast_to(rows_u, approx.shape), part, axis=1),
            -part_s), axis=1)
        part = np.take_along_axis(part, order, axis=1)
        part_s = np.take_along_axis(part_s, order, axis=1)
        pools = np.where(np.isfinite(part_s), rows_u[part], -1)
        s, i = rescore_topk(q, pools, self._f32_fetch, k)
        out_s[:, : s.shape[1]] = s
        out_i[:, : i.shape[1]] = i
        return scanned

    def recall_at_k(self, queries: np.ndarray, k: int = 10,
                    nprobe: int = 8) -> float:
        """Measured recall vs the exact scan (validation/benchmarks)."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        _, approx, _ = self.search(q, k=k, nprobe=nprobe)
        vecs = self._vectors
        if vecs is None:                       # quantized, fp32 on disk
            vecs = self._f32_fetch(np.arange(len(self._vq8)))
        exact_scores = q @ vecs.T
        exact = np.argsort(-exact_scores, axis=1)[:, :k]
        hits = sum(len(set(approx[i]) & set(exact[i]))
                   for i in range(q.shape[0]))
        return hits / (q.shape[0] * k)
