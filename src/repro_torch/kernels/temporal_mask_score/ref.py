"""Pure oracles for validity-masked temporal scoring.

numpy int64 end-to-end (host path): the validity test is exact at
microsecond resolution. ``temporal_window_topk_ref`` is the general
primitive (per-query half-open windows); a point-in-time query at ts is
the window [ts, ts+1).
"""
from __future__ import annotations

import numpy as np


def temporal_window_topk_ref(q: np.ndarray, corpus: np.ndarray,
                             valid_from: np.ndarray, valid_to: np.ndarray,
                             t0s: np.ndarray, t1s: np.ndarray,
                             k: int) -> tuple[np.ndarray, np.ndarray]:
    """q: (Q, D), corpus: (N, D), valid_from/valid_to: (N,) int64,
    t0s/t1s: (Q,) int64 per-query window bounds. A row is a candidate for
    query i iff its validity interval overlaps [t0s[i], t1s[i]):
    valid_from < t1 and t0 < valid_to. Overlap filter applied BEFORE
    ranking (leakage guard)."""
    q = np.asarray(q, np.float32)
    corpus = np.asarray(corpus, np.float32)
    vf = np.asarray(valid_from, np.int64)
    vt = np.asarray(valid_to, np.int64)
    t0s = np.asarray(t0s, np.int64).reshape(-1, 1)
    t1s = np.asarray(t1s, np.int64).reshape(-1, 1)
    valid = (vf[None, :] < t1s) & (t0s < vt[None, :])     # (Q, N)
    scores = q @ corpus.T
    scores = np.where(valid, scores, -np.inf)
    k = min(k, corpus.shape[0])
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(scores, idx, axis=1)
    return top.astype(np.float32), idx.astype(np.int32)


def temporal_window_topk_q8_ref(qs: np.ndarray, c8: np.ndarray,
                                valid_from: np.ndarray, valid_to: np.ndarray,
                                t0s: np.ndarray, t1s: np.ndarray,
                                k: int) -> tuple[np.ndarray, np.ndarray]:
    """Oracle for the quantized temporal scan: ``qs`` is the
    scale-folded fp32 query block, ``c8`` the int8 history — the scores
    are the exact dequantized asymmetric dot products, and the overlap
    filter still precedes ranking (leakage guard unchanged)."""
    return temporal_window_topk_ref(qs, np.asarray(c8, np.float32),
                                    valid_from, valid_to, t0s, t1s, k)


def temporal_topk_ref(q: np.ndarray, corpus: np.ndarray,
                      valid_from: np.ndarray, valid_to: np.ndarray,
                      ts: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Point-in-time oracle: valid_from <= ts < valid_to, i.e. the
    degenerate window [ts, ts+1) shared by every query row."""
    q = np.atleast_2d(np.asarray(q, np.float32))
    ts = int(ts)
    bounds = np.full(q.shape[0], ts, np.int64)
    return temporal_window_topk_ref(q, corpus, valid_from, valid_to,
                                    bounds, bounds + 1, k)
