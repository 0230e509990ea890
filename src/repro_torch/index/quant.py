"""Scalar int8 quantization for the scan fabric (DESIGN.md §11).

Every scan in the system — the fused memtable+small-segment block, IVF
member scans, and the temporal engine's resident full-history arrays —
is memory-bandwidth-bound: it streams every corpus row once per
dispatch. Storing those rows as float32 moves 4x the bytes the distance
computation needs. This module provides the storage half of the
quantized scan fabric:

  - per-dimension SYMMETRIC int8 quantization. Two scale regimes:
      * ``fixed_scale(dim)`` — the constant 1/127 vector. Valid for any
        L2-normalized row (|x_j| <= 1 always) and REQUIRED for mutable
        or concatenated sources (memtable slots, the fused scan block,
        the temporal resident history): rows quantized at different
        times remain directly comparable and can be copied between
        sources verbatim, with zero re-quantization drift.
      * ``data_scale(emb)`` — per-dimension max|col|/127, tighter, used
        for immutable IVF segments where the row set is frozen at seal
        time and the scale vector is persisted alongside the rows.
  - ASYMMETRIC distance: the fp32 query is scaled by the per-dimension
    scale vector once (``fold_scale``), after which the exact
    dequantized dot product is  (q * scale) . q8_row  — the corpus is
    never dequantized to a materialized fp32 copy.
  - exact fp32 RESCORING: the quantized scan over-fetches a candidate
    pool (k' = rescore_factor * k); ``rescore_topk`` re-scores only the
    pool rows with their true fp32 values (fetched through ``F32Rows``,
    a winners-row cache over a disk mmap / lazy source) and returns the
    exact-scored top-k. Quantization error can demote a true top-k row
    only if it falls out of the k' pool — the recall gates in
    tests/benchmarks hold that at recall@10 >= 0.99.

Round-trips are deterministic: quantization is ``np.rint`` (ties to
even) with a clip to [-127, 127], and both the int8 rows and the scale
vector are persisted (segment npz, cold checkpoint sidecars), so
save/load never re-quantizes and dequantize(load(save(q8))) is
bit-identical to dequantize(q8).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

Q8_MAX = 127
_SCALE_FLOOR = 1e-12


def fixed_scale(dim: int) -> np.ndarray:
    """The constant per-dimension scale for L2-normalized rows: every
    component lies in [-1, 1], so 1/127 covers the full int8 range.
    Mutable and concatenated sources MUST use this (see module doc)."""
    return np.full(dim, 1.0 / Q8_MAX, np.float32)


def data_scale(emb: np.ndarray) -> np.ndarray:
    """Per-dimension data-dependent scale: max|col|/127 (floored so an
    all-zero column stays finite). Only valid for an immutable row set."""
    emb = np.asarray(emb, np.float32)
    amax = np.abs(emb).max(axis=0) if emb.shape[0] else \
        np.zeros(emb.shape[1], np.float32)
    return np.maximum(amax / Q8_MAX, _SCALE_FLOOR).astype(np.float32)


def quantize_rows(emb: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """emb (N, d) fp32 -> (N, d) int8 under the given per-dim scale.
    Deterministic: np.rint (round-half-to-even), clipped symmetric."""
    emb = np.asarray(emb, np.float32)
    q = np.rint(emb / scale[None, :])
    return np.clip(q, -Q8_MAX, Q8_MAX).astype(np.int8)


def quantize_int8(emb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize an immutable row block with its own per-dim data scale.
    Returns (q8 (N, d) int8, scale (d,) fp32)."""
    scale = data_scale(emb)
    return quantize_rows(emb, scale), scale


def dequantize(q8: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(N, d) int8 -> fp32 under the per-dim scale (exact: int8 values
    are integers, the product is a single fp32 multiply per element)."""
    return np.asarray(q8, np.float32) * np.asarray(scale, np.float32)[None, :]


def fold_scale(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Fold the corpus scale into the query: (q*scale) . q8 equals the
    exact dequantized dot q . (q8*scale) — the asymmetric-distance
    identity every q8 scan path relies on."""
    q = np.atleast_2d(np.asarray(q, np.float32))
    return q * np.asarray(scale, np.float32)[None, :]


# ---------------------------------------------------------------------------
# fp32 winners-row cache
# ---------------------------------------------------------------------------
class F32Rows:
    """Exact-fp32 winners-row source for rescoring: a thin, instrumented
    front on a fetch function (disk mmap for segments and the temporal
    spill). Only rows that actually win a place in a candidate pool are
    ever read back in fp32, and the OS page cache over the mmap IS the
    winners cache — an explicit per-row dict layer measured SLOWER than
    the page-cache read it would save, so none exists. ``rows_read``
    tracks rescore traffic for stats/benchmarks."""

    def __init__(self, fetch: Callable[[np.ndarray], np.ndarray], dim: int):
        self._fetch = fetch
        self.dim = dim
        self.rows_read = 0

    def get(self, rows: np.ndarray) -> np.ndarray:
        """rows: (m,) unique non-negative ids -> (m, d) fp32 (exact)."""
        rows = np.asarray(rows, np.int64)
        self.rows_read += len(rows)
        return np.asarray(self._fetch(rows), np.float32)

    def nbytes(self) -> int:
        """Resident bytes pinned by this source (page cache excluded —
        the kernel reclaims it under pressure)."""
        return 0


# ---------------------------------------------------------------------------
# exact rescoring of an over-fetched pool
# ---------------------------------------------------------------------------
def pool_k(k: int, n: int, rescore_factor: int) -> int:
    """Candidate-pool size for a final top-k over n rows."""
    return int(min(max(k * max(int(rescore_factor), 1), k), n))


def rescore_topk(q: np.ndarray, pool_idx: np.ndarray,
                 f32_rows: "F32Rows | np.ndarray | Callable",
                 k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact fp32 top-k inside a quantized scan's candidate pool.

    q: (Q, d) fp32 queries; pool_idx: (Q, k') candidate row ids from the
    q8 scan (-1 = empty slot). ``f32_rows`` supplies exact fp32 rows by
    id (an F32Rows cache, a plain (N, d) array, or a fetch callable).
    Returns (scores (Q, k), idx (Q, k)) ordered by exact score
    descending, ties broken by pool order (i.e. the quantized scan's own
    rank — stable). Empty slots come back (-inf, -1).

    Cost: one fetch of the UNIQUE pool rows across the whole batch plus
    one (Q, U) matmul with U <= Q*k' — independent of corpus size.
    """
    q = np.atleast_2d(np.asarray(q, np.float32))
    pool_idx = np.atleast_2d(np.asarray(pool_idx, np.int64))
    nq, kp = pool_idx.shape
    k = int(min(k, kp)) if kp else 0
    if k == 0:
        return (np.full((nq, 0), -np.inf, np.float32),
                np.full((nq, 0), -1, np.int64))
    uniq, inv = np.unique(np.clip(pool_idx, 0, None), return_inverse=True)
    if isinstance(f32_rows, F32Rows):
        rows = f32_rows.get(uniq)
    elif callable(f32_rows):
        rows = np.asarray(f32_rows(uniq), np.float32)
    else:
        rows = np.asarray(f32_rows, np.float32)[uniq]
    # einsum, NOT @: the pool is tiny, and a threaded BLAS gemm here
    # would leave OpenBLAS worker threads spinning right when the next
    # int8 GEMM (torch/oneDNN pool) wants the cores
    exact = np.einsum("qd,ud->qu", q, rows)               # (Q, U)
    s = np.take_along_axis(exact, inv.reshape(nq, kp), axis=1)
    s = np.where(pool_idx >= 0, s, -np.inf).astype(np.float32)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    top_s = np.take_along_axis(s, order, axis=1)
    top_i = np.where(np.isfinite(top_s),
                     np.take_along_axis(pool_idx, order, axis=1), -1)
    return top_s, top_i


# ---------------------------------------------------------------------------
# disk-backed fp32 sources
# ---------------------------------------------------------------------------
def mmap_f32_fetch(path: str) -> Callable[[np.ndarray], np.ndarray]:
    """Row-fetch over an .npy fp32 file: the mmap reads only the pages
    the requested rows live in — the on-disk fp32 copy costs RAM only
    for rows that actually get rescored."""
    mm = np.load(path, mmap_mode="r")

    def fetch(rows: np.ndarray) -> np.ndarray:
        return np.asarray(mm[np.asarray(rows, np.int64)], np.float32)

    return fetch


class AppendOnlyF32File:
    """The temporal resident history's fp32 spill: an append-only raw
    binary of (d,) fp32 rows. The resident arrays keep only int8; exact
    rescore rows are read back through a lazily (re)opened memmap. A
    pure cache — ``reset`` rewrites it whenever the resident columns are
    re-seeded."""

    def __init__(self, path: str, dim: int):
        self.path = path
        self.dim = dim
        self.n = 0
        self._mm: Optional[np.memmap] = None

    def reset(self, emb: np.ndarray) -> None:
        emb = np.ascontiguousarray(emb, np.float32)
        with open(self.path, "wb") as f:
            f.write(emb.tobytes())
        self.n = emb.shape[0]
        self._mm = None

    def append(self, emb: np.ndarray) -> None:
        emb = np.ascontiguousarray(emb, np.float32)
        with open(self.path, "ab") as f:
            f.write(emb.tobytes())
        self.n += emb.shape[0]
        self._mm = None

    def fetch(self, rows: np.ndarray) -> np.ndarray:
        if self._mm is None or self._mm.shape[0] < self.n:
            self._mm = np.memmap(self.path, dtype=np.float32, mode="r",
                                 shape=(self.n, self.dim))
        return np.asarray(self._mm[np.asarray(rows, np.int64)], np.float32)
