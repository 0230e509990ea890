"""Wrappers of the temporal validity-masked top-k kernel
(csrc/temporal_mask_score.cu).

``temporal_window_topk`` is the general fused primitive: one launch
scores a (Q, d) query block against a device-resident full-history
corpus with a PER-QUERY validity window — no per-timestamp materialized
snapshot copy ever exists. ``temporal_topk`` (point-in-time, one shared
ts) is the degenerate window [ts, ts+1).
"""
from __future__ import annotations

import torch

from ... import obs
from .. import build
from ..common import bind, check_tensor, launch_tile_scan
from .plain import temporal_window_topk_plain

KMAX = 64             # largest k the kernel keeps (csrc/topk_tile.cuh)
launches = 0          # CUDA launches of ``temporal_window_topk``


def _lib():
    lib = build.load("temporal_mask_score")
    if lib.temporal_window_topk_f32.argtypes is None:
        bind(lib, "temporal_window_topk_f32", 6)
    return lib


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
    global launches
    with obs.span("kernel:temporal_window_topk") as sp:
        corpus = torch.as_tensor(corpus)
        dev = corpus.device
        q = torch.atleast_2d(torch.as_tensor(q))
        vf = torch.as_tensor(valid_from)
        vt = torch.as_tensor(valid_to)
        check_tensor("corpus", corpus, torch.float32, 2, dev)
        check_tensor("q", q, torch.float32, 2, dev)
        check_tensor("valid_from", vf, torch.int64, 1, dev)
        check_tensor("valid_to", vt, torch.int64, 1, dev)
        nq, (n, d) = q.shape[0], corpus.shape
        if q.shape[1] != d or vf.shape[0] != n or vt.shape[0] != n:
            raise ValueError(f"shapes q {tuple(q.shape)}, corpus "
                             f"{tuple(corpus.shape)}, valid_from "
                             f"{tuple(vf.shape)}, valid_to "
                             f"{tuple(vt.shape)} do not match")
        t0 = torch.as_tensor(t0s, dtype=torch.int64).to(dev)
        t1 = torch.as_tensor(t1s, dtype=torch.int64).to(dev)
        t0 = torch.broadcast_to(t0, (nq,)).contiguous()
        t1 = torch.broadcast_to(t1, (nq,)).contiguous()
        k = int(min(k, n))
        if k == 0 or nq == 0:
            # empty history: nothing can ever be valid, whatever the window
            return (torch.zeros((nq, 0), dtype=torch.float32, device=dev),
                    torch.zeros((nq, 0), dtype=torch.int32, device=dev))
        sp.add("rows", n)
        sp.add("bytes_streamed", n * d * 4)
        if dev.type == "cpu":
            return temporal_window_topk_plain(q, corpus, vf, vt, t0, t1, k)
        if dev.type != "cuda":
            raise ValueError(
                f"temporal_window_topk runs on cpu or cuda, not {dev}")
        if k > KMAX:
            raise ValueError(f"temporal_window_topk: k={k} exceeds the "
                             f"kernel's largest k, {KMAX}")
        out = launch_tile_scan(_lib(), "temporal_window_topk_f32",
                               [q, corpus, vf, vt, t0, t1], nq, n, d, k)
        launches += 1
        if sp is not obs.NOOP_SPAN:            # traced: span = device time
            torch.cuda.current_stream(dev).synchronize()
        return out


def temporal_topk(q, corpus, valid_from, valid_to, ts: int, k: int):
    """Point-in-time temporal scoring (shared ts for the whole block):
    the degenerate window [ts, ts+1) — with integer-microsecond stamps
    the overlap test is exactly valid_from <= ts < valid_to."""
    ts = int(ts)
    return temporal_window_topk(q, corpus, valid_from, valid_to,
                                ts, ts + 1, k)
