"""Host-side int8 asymmetric-scan helpers (the "host" mode of the q8
kernels — DESIGN.md §11).

On TPU the q8 kernels stream int8 corpus blocks through VMEM and
dequantize in-register (kernels/topk_search, kernels/temporal_mask_score
``*_q8`` variants). On CPU hosts the same asymmetric scan is served by
an integer GEMM when torch is available (``torch._int_mm``: s8 x s8 ->
s32, VNNI/fbgemm-backed — the corpus is read at 1 byte/element, the
bandwidth win the whole fabric is about), with a blocked cast+matmul
numpy fallback when it is not. torch is an optional accelerator, never a
dependency: everything degrades to numpy.

The host scan additionally quantizes the SCALED query per row (one
scalar scale per query) so both GEMM operands are int8; the extra query
quantization error only perturbs which rows land in the over-fetched
candidate pool — the exact fp32 rescore (index/quant.rescore_topk)
removes it from the final scores entirely.
"""
from __future__ import annotations

import numpy as np

from .. import obs

try:                                    # pragma: no cover - env dependent
    import torch
    _TORCH = torch
except Exception:                       # pragma: no cover - env dependent
    _TORCH = None

Q8_MAX = 127


def have_int8_host() -> bool:
    """True when the integer-GEMM fast path is available."""
    return _TORCH is not None


def asym_scores_host(qs: np.ndarray, c8: np.ndarray) -> np.ndarray:
    """Approximate asymmetric scores (Q, N) fp32 for scale-folded
    queries ``qs`` (Q, d) against an int8 corpus ``c8`` (N, d).

    torch path: per-query symmetric int8 quantization of qs (scalar
    scale per row), s8 x s8 -> s32 GEMM against the corpus TRANSPOSED
    VIEW (no copy), then one fp32 scale-back per row.
    numpy fallback: corpus blocks cast int8 -> fp32 into a reusable
    cache-resident buffer, then sgemm per block (one 1-byte/elem pass
    over the corpus instead of 4)."""
    # rows/bytes are recorded by the enclosing scan span — this span only
    # times the host GEMM so the tree shows where the scan went. It is
    # host work, so it carries no ``kernel:`` prefix (obs/cost.py counts
    # those as device time).
    with obs.span("ivf_gemm"):
        qs = np.ascontiguousarray(np.atleast_2d(qs), np.float32)
        c8 = np.ascontiguousarray(c8, np.int8)
        nq, d = qs.shape
        n = c8.shape[0]
        if n == 0 or nq == 0:
            return np.zeros((nq, n), np.float32)
        qscale = np.maximum(np.abs(qs).max(axis=1) / Q8_MAX, 1e-12)
        q8q = np.clip(np.rint(qs / qscale[:, None]), -Q8_MAX, Q8_MAX) \
            .astype(np.int8)
        if _TORCH is not None:
            acc = _TORCH._int_mm(_TORCH.from_numpy(q8q),
                                 _TORCH.from_numpy(c8).t())
            return acc.numpy().astype(np.float32) * qscale[:, None] \
                .astype(np.float32)
        out = np.empty((nq, n), np.float32)
        bn = 4096
        buf = np.empty((min(bn, n), d), np.float32)
        for j0 in range(0, n, bn):
            j1 = min(j0 + bn, n)
            b = buf[:j1 - j0]
            b[:] = c8[j0:j1]                   # int8 -> fp32, one pass
            np.matmul(qs, b.T, out=out[:, j0:j1])
        return out


def pool_topk_host(scores: np.ndarray, kp: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Top-kp candidate pool from a (Q, N) score matrix: argpartition
    (O(N)) then a stable descending sort of the pool only. Returns
    (scores (Q, kp) fp32, idx (Q, kp) int64); -inf slots come back -1.
    """
    nq, n = scores.shape
    kp = int(min(kp, n))
    if kp == 0:
        return (np.zeros((nq, 0), np.float32),
                np.zeros((nq, 0), np.int64))
    if kp < n:
        part = np.argpartition(-scores, kp - 1, axis=1)[:, :kp]
    else:
        part = np.broadcast_to(np.arange(n), (nq, n)).copy()
    part_s = np.take_along_axis(scores, part, axis=1)
    # stable by ORIGINAL row id on ties (argpartition order is arbitrary)
    order = np.lexsort((part, -part_s), axis=1)
    idx = np.take_along_axis(part, order, axis=1).astype(np.int64)
    top_s = np.take_along_axis(part_s, order, axis=1).astype(np.float32)
    idx = np.where(np.isfinite(top_s), idx, -1)
    return top_s, idx
