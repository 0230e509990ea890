"""Immutable base segments of the segmented index (DESIGN.md §7.2, §11).

A segment is sealed from the memtable (or produced by a merge) and its
row data never changes afterwards; the only mutable state is the ``alive``
deletion vector (a bool mask) that tombstones rows superseded or deleted
after sealing — the classic LSM/Lance compromise that keeps deletes O(1)
without rewriting the segment. Tombstoned rows are physically purged at
the next compaction.

Segments at or above ``ivf_min_rows`` are IVF-partitioned at seal time
(core/ivf.py): a query scores the centroids (tiny matmul) and exact-scans
only the ``nprobe`` nearest partitions — the sub-linear path. Small
segments fall back to the exact fused top-k kernel; both paths honor the
deletion vector before anything can rank.

QUANTIZED mode (DESIGN.md §11): the resident scan copy is int8 with a
per-dimension scale vector — per-segment data-tight for IVF segments,
the fixed 1/127 scale for small segments so they can be concatenated
into the fused scan block next to the memtable. The fp32 rows move to a
raw ``seg-*.f32.npy`` sidecar read back lazily (mmap + winners-row
cache) ONLY to exactly rescore candidate pools, so resident embedding
bytes drop ~4x while final scores stay exact fp32. Quantization is
persisted (q8 + scale in the npz), so save/load round-trips are
bit-deterministic and load never re-quantizes.

On-disk format: one compressed .npz per segment (numeric columns +
unicode string columns, no pickle), content-addressed by SHA-256 in the
manifest for integrity verification on load; quantized segments add the
fp32 sidecar, content-addressed by a checksum INSIDE the npz.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from ..core.hashing import blob_checksum, file_checksum
from ..core.integrity import CorruptionError
from ..core.ivf import IVFIndex
from ..kernels.common import resolve_device
from ..testing.faults import FAULTS
from .quant import (F32Rows, data_scale, fixed_scale, mmap_f32_fetch,
                    pool_k, quantize_rows, rescore_topk)


def verify_segment_files(root: str, filename: str,
                         checksum: str | None) -> bool:
    """Scrubber hook: re-verify a segment npz (and, for quantized
    segments, its fp32 sidecar) against the manifest checksum without
    constructing the Segment. Returns True when intact or benignly
    absent (compaction races the scrub walk)."""
    path = os.path.join(root, filename)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return True
    if checksum is not None and blob_checksum(data) != checksum:
        return False
    try:
        z = np.load(io.BytesIO(data))
    except Exception:
        return False
    if "q8" in z.files:
        want = str(z["f32_checksum"])
        seg_id = filename[len("seg-"):-len(".npz")]
        f32_path = os.path.join(root, f"seg-{seg_id}.f32.npy")
        try:
            if want and file_checksum(f32_path) != want:
                return False
        except OSError:
            return True
    return True


class Segment:
    def __init__(self, seg_id: str, emb: np.ndarray | None,
                 valid_from: np.ndarray,
                 positions: np.ndarray, chunk_ids: list[str],
                 doc_ids: list[str], texts: list[str],
                 alive: np.ndarray | None = None,
                 ivf_min_rows: int = 1024, seed: int = 0,
                 ivf_state: tuple[np.ndarray, np.ndarray] | None = None,
                 quantized: bool = False,
                 quant_state: tuple[np.ndarray, np.ndarray] | None = None,
                 f32_fetch=None, rescore_factor: int = 4,
                 tenant_ids: np.ndarray | None = None, device=None):
        self.seg_id = seg_id
        # the exact scan runs on this device over a copy of ``emb`` (or
        # of ``q8``, quantized) made at the first exact search and kept
        # for the segment's lifetime
        self.device = resolve_device(device)
        self._emb_dev: torch.Tensor | None = None
        self.valid_from = np.asarray(valid_from, np.int64)
        self.positions = np.asarray(positions, np.int64)
        self.chunk_ids = list(chunk_ids)
        self.doc_ids = list(doc_ids)
        self.texts = list(texts)
        self.quantized = bool(quantized)
        self.rescore_factor = int(rescore_factor)
        self.q8: np.ndarray | None = None
        self.scale: np.ndarray | None = None
        self._f32: F32Rows | None = None
        self._f32_checksum: str | None = None
        if emb is not None:
            self.emb: np.ndarray | None = np.asarray(emb, np.float32)
            n, dim = self.emb.shape
        else:
            assert quant_state is not None and f32_fetch is not None, \
                "emb-less segment needs persisted quant state + f32 source"
            self.emb = None
            n, dim = quant_state[0].shape
        self.dim = dim
        self.alive = (np.ones(n, bool) if alive is None
                      else np.asarray(alive, bool).copy())
        # per-row tenant ids, persisted next to the authority (alive)
        # vector; absent (pre-tenancy artifacts) means default tenant 0
        self.tenant_ids = (np.zeros(n, np.int32) if tenant_ids is None
                           else np.asarray(tenant_ids, np.int32))
        self.ivf_min_rows = ivf_min_rows
        if self.quantized:
            if quant_state is not None:
                self.q8 = np.asarray(quant_state[0], np.int8)
                self.scale = np.asarray(quant_state[1], np.float32)
            else:
                # IVF-sized segments get the tight per-dimension data
                # scale; small segments the fixed 1/127 scale so the
                # fused block can concatenate them behind the memtable.
                self.scale = (data_scale(self.emb) if n >= ivf_min_rows
                              else fixed_scale(dim))
                self.q8 = quantize_rows(self.emb, self.scale)
            if f32_fetch is not None:
                self._f32 = F32Rows(f32_fetch, dim)
        self.ivf: IVFIndex | None = None
        if n >= ivf_min_rows:
            if ivf_state is not None and len(ivf_state[1]) == n:
                # persisted partitioning: no k-means re-run on load
                centroids, assign = ivf_state
                self.ivf = IVFIndex(n_centroids=centroids.shape[0],
                                    seed=seed)
                self.ivf.restore(centroids, self.emb, assign)
            else:
                self.ivf = IVFIndex(n_centroids=max(8, int(np.sqrt(n))),
                                    seed=seed)
                # k-means needs fp32 rows; a quantized segment reopened
                # under a LOWERED ivf_min_rows has none resident — pull
                # them through the sidecar once (build-time only)
                emb_for_build = (self.emb if self.emb is not None
                                 else self.fetch_f32(np.arange(n)))
                self.ivf.build(emb_for_build)
            if self.quantized:
                self.ivf.attach_quantized(self.q8, self.scale,
                                          self.fetch_f32,
                                          rescore_factor=self.rescore_factor)
                if self.emb is None:
                    # rows came from the sidecar (build-time only) —
                    # don't let k-means' input pin a resident fp32 copy
                    self.ivf.release_f32()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self.q8.shape[0] if self.emb is None else self.emb.shape[0]

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    def key(self, row: int) -> tuple[str, int]:
        return (self.doc_ids[row], int(self.positions[row]))

    def kill(self, row: int) -> None:
        """Tombstone one row (delete or shadow-by-newer-insert)."""
        self.alive[row] = False

    def _with_alive(self, alive: np.ndarray) -> "Segment":
        """Adopt a deletion vector (format-coercion path on rebuild)."""
        self.alive = np.asarray(alive, bool).copy()
        return self

    def result_cols(self) -> dict:
        """Per-column gather arrays for the vectorized result build —
        rows are immutable, so these are materialized once per segment
        and the catalog just concatenates them."""
        if getattr(self, "_result_cols", None) is None:
            self._result_cols = {
                "chunk_ids": np.asarray(self.chunk_ids, object),
                "doc_ids": np.asarray(self.doc_ids, object),
                "texts": np.asarray(self.texts, object),
                "positions": self.positions,
                "valid_from": self.valid_from,
                "tenant_ids": self.tenant_ids,
            }
        return self._result_cols

    # -- fp32 access (rescoring / merge / oracle) -----------------------
    def fetch_f32(self, rows: np.ndarray) -> np.ndarray:
        """Exact fp32 rows by segment-local id — from the resident array
        while it is still held, else through the winners-row cache over
        the on-disk sidecar."""
        rows = np.asarray(rows, np.int64)
        if self.emb is not None:
            return self.emb[rows]
        return self._f32.get(rows)

    def release_f32(self) -> bool:
        """Drop the resident fp32 copy (quantized segments only, after
        the sidecar is durably on disk): scans run on int8, rescores go
        through the sidecar. Returns True if anything was released."""
        if not self.quantized or self.emb is None or self._f32 is None:
            return False
        self.emb = None
        if self.ivf is not None:
            self.ivf.release_f32()
        return True

    def emb_nbytes(self) -> int:
        """RESIDENT embedding bytes: what this segment actually pins in
        RAM for scanning + rescoring (the benchmark's 4x claim)."""
        n = 0
        if self.emb is not None:
            n += int(self.emb.nbytes)
        if self.q8 is not None:
            n += int(self.q8.nbytes) + int(self.scale.nbytes)
        if self._f32 is not None:
            n += self._f32.nbytes()
        return n

    # -- search -----------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, nprobe: int = 8,
               visible: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray, int]:
        """Top-k over alive rows. Returns (scores (Q, k), rows (Q, k),
        avg rows scanned per query). IVF routing when partitioned, exact
        scan otherwise; either way tombstoned rows are masked before
        ranking. Quantized segments scan int8 and exactly rescore the
        over-fetched pool in fp32, so returned scores are fp32-exact.

        ``visible`` (N,) bool, optional: the per-query tenant/ACL mask.
        It is AND-ed into the deletion vector BEFORE the kernel ranks —
        the same pre-ranking contract as ``alive``, so a masked row
        yields idx -1 and the fp32 rescore can never resurrect it."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = q.shape[0]
        k_eff = min(k, len(self))
        mask = self.alive if visible is None else (self.alive & visible)
        n_mask = int(mask.sum())
        if self.ivf is not None:
            s, i, stats = self.ivf.search(q, k=k_eff, nprobe=nprobe,
                                          mask=mask)
            return s, i, int(round(stats.fraction_scanned * len(self)))
        from ..core.types import pad_queries
        from ..kernels.topk_search.ops import topk_search, topk_search_q8
        qp, _ = pad_queries(q)
        dev = self.device
        if self._emb_dev is None:
            self._emb_dev = torch.as_tensor(
                self.q8 if self.quantized else self.emb, device=dev)
        qd = torch.as_tensor(np.ascontiguousarray(qp), device=dev)
        mask_d = torch.as_tensor(mask, device=dev)
        if self.quantized:
            kp = pool_k(k_eff, len(self), self.rescore_factor)
            _, pool = topk_search_q8(qd, self._emb_dev, self.scale, mask_d,
                                     kp)
            s, i = rescore_topk(q, pool.cpu().numpy()[:nq], self.fetch_f32,
                                k_eff)
            return s, i, n_mask
        s, i = topk_search(qd, self._emb_dev, mask_d, k_eff)
        return s.cpu().numpy()[:nq], i.cpu().numpy()[:nq], n_mask

    # -- persistence -------------------------------------------------------
    def filename(self) -> str:
        return f"seg-{self.seg_id}.npz"

    def f32_filename(self) -> str:
        return f"seg-{self.seg_id}.f32.npy"

    def _f32_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(self.emb, np.float32))
        return buf.getvalue()

    def to_bytes(self) -> bytes:
        cols = dict(
            valid_from=self.valid_from,
            positions=self.positions, alive=self.alive,
            tenant_ids=self.tenant_ids,
            chunk_ids=np.asarray(self.chunk_ids, dtype=np.str_),
            doc_ids=np.asarray(self.doc_ids, dtype=np.str_),
            texts=np.asarray(self.texts, dtype=np.str_))
        if self.quantized:
            # fp32 rows live in the sidecar; the npz carries the int8
            # scan copy + scale and content-addresses the sidecar
            cols["q8"] = self.q8
            cols["scale"] = self.scale
            cols["f32_checksum"] = np.str_(self._f32_checksum or "")
        else:
            cols["emb"] = self.emb
        if self.ivf is not None:               # partitioning is immutable:
            cols["ivf_centroids"] = self.ivf.centroids   # serialize once,
            cols["ivf_assign"] = self.ivf._assign        # never re-k-means
        buf = io.BytesIO()
        np.savez_compressed(buf, **cols)
        return buf.getvalue()

    def save(self, root: str) -> tuple[str, str]:
        """Write (fsync'd) to ``root``; returns (filename, checksum). The
        segment file lands BEFORE the manifest references it, mirroring
        the cold tier's segment-then-log ordering. Quantized segments
        write the fp32 sidecar FIRST (the npz references its checksum),
        then arm the mmap-backed rescore source so the caller may
        release the resident fp32 copy."""
        if self.quantized and self.emb is not None:
            f32 = self._f32_bytes()
            self._f32_checksum = blob_checksum(f32)
            f32_path = os.path.join(root, self.f32_filename())
            with open(f32_path, "wb") as f:
                f.write(f32)
                f.flush()
                os.fsync(f.fileno())
            FAULTS.mutate("hot:segment:f32", f32_path)
            self._f32 = F32Rows(mmap_f32_fetch(f32_path), self.dim)
        data = self.to_bytes()
        path = os.path.join(root, self.filename())
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        FAULTS.mutate("hot:segment:file", path)
        return self.filename(), blob_checksum(data)

    @classmethod
    def load(cls, root: str, filename: str, checksum: str | None = None,
             ivf_min_rows: int = 1024, seed: int = 0,
             rescore_factor: int = 4, device=None) -> "Segment":
        with open(os.path.join(root, filename), "rb") as f:
            data = f.read()
        if checksum is not None and blob_checksum(data) != checksum:
            raise CorruptionError(
                f"segment checksum mismatch: {filename}",
                artifact="hot_segment", tier="hot",
                path=os.path.join(root, filename))
        z = np.load(io.BytesIO(data))
        seg_id = filename[len("seg-"):-len(".npz")]
        ivf_state = ((z["ivf_centroids"], z["ivf_assign"])
                     if "ivf_centroids" in z.files else None)
        common = dict(alive=z["alive"], ivf_min_rows=ivf_min_rows, seed=seed,
                      rescore_factor=rescore_factor, device=device,
                      # pre-tenancy segments have no tenant column: all
                      # rows belong to the default tenant (id 0)
                      tenant_ids=(z["tenant_ids"]
                                  if "tenant_ids" in z.files else None))
        if "q8" in z.files:                    # quantized on-disk format
            f32_path = os.path.join(root, f"seg-{seg_id}.f32.npy")
            want = str(z["f32_checksum"])
            # streamed: verifies a torn sidecar before its rows can back
            # an exact rescore, without buffering corpus-sized fp32
            if want and file_checksum(f32_path) != want:
                raise CorruptionError(
                    f"segment fp32 sidecar checksum mismatch: {seg_id}",
                    artifact="f32_sidecar", tier="hot", path=f32_path)
            seg = cls(seg_id, None, z["valid_from"], z["positions"],
                      [str(x) for x in z["chunk_ids"]],
                      [str(x) for x in z["doc_ids"]],
                      [str(x) for x in z["texts"]],
                      ivf_state=ivf_state, quantized=True,
                      quant_state=(z["q8"], z["scale"]),
                      f32_fetch=mmap_f32_fetch(f32_path), **common)
            seg._f32_checksum = want or None
            return seg
        return cls(seg_id, z["emb"], z["valid_from"], z["positions"],
                   [str(x) for x in z["chunk_ids"]],
                   [str(x) for x in z["doc_ids"]],
                   [str(x) for x in z["texts"]],
                   ivf_state=ivf_state, **common)
