"""Wrappers of the temporal validity-masked top-k kernels
(csrc/temporal_mask_score.cu).

``temporal_window_topk`` is the general fused primitive: one launch
scores a (Q, d) query block against a device-resident full-history
corpus with a PER-QUERY validity window — no per-timestamp materialized
snapshot copy ever exists. ``temporal_topk`` (point-in-time, one shared
ts) is the degenerate window [ts, ts+1). ``temporal_window_topk_q8`` is
the same scan over an int8 history: the candidate pool of the quantized
temporal tier.
"""
from __future__ import annotations

import threading

import torch

from ... import obs
from .. import build
from ..common import bind, check_tensor, launch_tile_scan
from .plain import (temporal_window_topk_plain,
                    temporal_window_topk_q8_plain)

launches = 0          # CUDA kernel launches of ``temporal_window_topk``
launches_q8 = 0       # CUDA kernel launches of ``temporal_window_topk_q8``
_count_lock = threading.Lock()


def _bind(lib) -> None:
    """Declare the C signatures of both scans of ``lib``."""
    bind(lib, "temporal_window_topk_f32", 6)
    bind(lib, "temporal_window_topk_q8", 6)


def _lib():
    return build.load("temporal_mask_score", _bind)


def _count(nl: int, q8: bool) -> None:
    """Add ``nl`` launches under a lock: the planner's scatter pool and
    the maintenance worker launch from several threads."""
    global launches, launches_q8
    with _count_lock:
        if q8:
            launches_q8 += nl
        else:
            launches += nl


def temporal_window_topk(q, corpus, valid_from, valid_to, t0s, t1s, k: int):
    """Fused window-overlap scoring: filter-before-rank top-k with a
    per-query validity window.

    q: (Q, D) f32; corpus: (N, D) f32; valid_from/valid_to: (N,) int64,
    all on one device; t0s/t1s: (Q,) int64 window bounds, or scalars
    (point query i == window [ts_i, ts_i + 1)), moved to that device.
    Returns (scores (Q, k) f32, idx (Q, k) int32) on the device, k
    clipped to N; rows with no overlapping candidate come back (-inf,
    -1). A CPU corpus runs the plain PyTorch version; a CUDA corpus
    launches the kernel."""
    return _window(q, corpus, None, valid_from, valid_to, t0s, t1s, k)


def temporal_window_topk_q8(q, c8, scale, valid_from, valid_to, t0s, t1s,
                            k: int):
    """Quantized fused window-overlap scoring (DESIGN.md §11): the
    candidate pool of the temporal tier's int8 scan. Callers over-fetch
    (k' = rescore_factor * k) and rescore the pool exactly in fp32.

    q: (Q, D) f32 unscaled queries; c8: (N, D) int8 history; scale: (D,)
    per-dimension quantization scale, moved to c8's device and folded
    into the queries once (q * scale); validity columns and windows as
    ``temporal_window_topk``. The overlap filter runs before ranking on
    every path, so the leakage guard is the fp32 path's."""
    return _window(q, c8, scale, valid_from, valid_to, t0s, t1s, k)


def _window(q, corpus, scale, valid_from, valid_to, t0s, t1s, k: int):
    q8 = scale is not None
    name = "temporal_window_topk_q8" if q8 else "temporal_window_topk"
    corpus = torch.as_tensor(corpus)
    dev = corpus.device
    q = torch.atleast_2d(torch.as_tensor(q))
    vf = torch.as_tensor(valid_from)
    vt = torch.as_tensor(valid_to)
    check_tensor("corpus", corpus, torch.int8 if q8 else torch.float32,
                 2, dev)
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("valid_from", vf, torch.int64, 1, dev)
    check_tensor("valid_to", vt, torch.int64, 1, dev)
    nq, (n, d) = q.shape[0], corpus.shape
    if q8:
        scale = torch.as_tensor(scale, dtype=torch.float32).to(dev)
        check_tensor("scale", scale, torch.float32, 1, dev)
    if (q.shape[1] != d or vf.shape[0] != n or vt.shape[0] != n
            or (q8 and scale.shape[0] != d)):
        raise ValueError(f"shapes q {tuple(q.shape)}, corpus "
                         f"{tuple(corpus.shape)}, valid_from "
                         f"{tuple(vf.shape)}, valid_to "
                         f"{tuple(vt.shape)}"
                         + (f", scale {tuple(scale.shape)}" if q8
                            else "") + " do not match")
    t0 = torch.as_tensor(t0s, dtype=torch.int64).to(dev)
    t1 = torch.as_tensor(t1s, dtype=torch.int64).to(dev)
    t0 = torch.broadcast_to(t0, (nq,)).contiguous()
    t1 = torch.broadcast_to(t1, (nq,)).contiguous()
    k = int(min(k, n))
    if k == 0 or nq == 0:
        # empty history: nothing can ever be valid, whatever the window
        return (torch.zeros((nq, 0), dtype=torch.float32, device=dev),
                torch.zeros((nq, 0), dtype=torch.int32, device=dev))
    qs = q * scale if q8 else q
    with obs.kernel_span(f"kernel:{name}", dev) as sp:
        sp.add("rows", n)
        sp.add("bytes_streamed", n * d * (1 if q8 else 4))
        if dev.type == "cpu":
            if q8:
                return temporal_window_topk_q8_plain(q, corpus, scale, vf,
                                                     vt, t0, t1, k)
            return temporal_window_topk_plain(q, corpus, vf, vt, t0, t1, k)
        if dev.type != "cuda":
            raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
        *out, nl = launch_tile_scan(
            _lib(), ("temporal_window_topk_q8" if q8
                     else "temporal_window_topk_f32"),
            [qs, corpus, vf, vt, t0, t1], nq, n, d, k, sp)
        _count(nl, q8)
        return tuple(out)


def temporal_topk(q, corpus, valid_from, valid_to, ts: int, k: int):
    """Point-in-time temporal scoring (shared ts for the whole block):
    the degenerate window [ts, ts+1) — with integer-microsecond stamps
    the overlap test is exactly valid_from <= ts < valid_to."""
    ts = int(ts)
    return temporal_window_topk(q, corpus, valid_from, valid_to,
                                ts, ts + 1, k)
