"""Wrappers of the fused masked top-k search kernels
(csrc/topk_search.cu): ``topk_search`` over an fp32 corpus and
``topk_search_q8``, the candidate scan of the quantized (int8) fabric."""
from __future__ import annotations

import threading

import torch

from ... import obs
from .. import build
from ..common import bind, check_tensor, launch_tile_scan
from .plain import topk_search_plain, topk_search_q8_plain

launches = 0          # CUDA kernel launches of ``topk_search``
launches_q8 = 0       # CUDA kernel launches of ``topk_search_q8``
_count_lock = threading.Lock()


def _bind(lib) -> None:
    """Declare the C signatures of both scans of ``lib``."""
    bind(lib, "topk_search_f32", 3)
    bind(lib, "topk_search_q8", 3)


def _lib():
    return build.load("topk_search", _bind)


def _count(nl: int, q8: bool) -> None:
    """Add ``nl`` launches under a lock: the planner's scatter pool and
    the maintenance worker launch from several threads."""
    global launches, launches_q8
    with _count_lock:
        if q8:
            launches_q8 += nl
        else:
            launches += nl


def topk_search(q, corpus, mask, k: int):
    """Masked exact top-k similarity search.

    q: (Q, D) or (D,) f32; corpus: (N, D) f32; mask: (N,) bool, all on
    one device. Returns (scores (Q, k) f32, idx (Q, k) int32) on that
    device, k clipped to N; descending, lower row id first on ties, and
    (-inf, -1) at every slot with no active row. A CPU corpus runs the
    plain PyTorch version; a CUDA corpus launches the kernel.
    """
    return _search(q, corpus, None, mask, k)


def topk_search_q8(q, c8, scale, mask, k: int):
    """Masked top-k asymmetric search over an int8 corpus: the candidate
    pool of the quantized scan (DESIGN.md §11). Callers over-fetch
    (k' = rescore_factor * k) and rescore the pool exactly in fp32
    (``index.quant.rescore_topk``).

    q: (Q, D) or (D,) f32 unscaled queries; c8: (N, D) int8; mask: (N,)
    bool, all on one device; scale: (D,) per-dimension quantization
    scale, moved to that device. The scale is folded into the queries
    once (q * scale, one fp32 multiply per element), so every score is
    the exact dequantized dot product q . (c8_row * scale). Returns as
    ``topk_search``."""
    return _search(q, c8, scale, mask, k)


def _search(q, corpus, scale, mask, k: int):
    q8 = scale is not None
    name = "topk_search_q8" if q8 else "topk_search"
    corpus = torch.as_tensor(corpus)
    dev = corpus.device
    q = torch.atleast_2d(torch.as_tensor(q))
    mask = torch.as_tensor(mask)
    check_tensor("corpus", corpus, torch.int8 if q8 else torch.float32,
                 2, dev)
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("mask", mask, torch.bool, 1, dev)
    nq, (n, d) = q.shape[0], corpus.shape
    if q8:
        scale = torch.as_tensor(scale, dtype=torch.float32).to(dev)
        check_tensor("scale", scale, torch.float32, 1, dev)
    if (q.shape[1] != d or mask.shape[0] != n
            or (q8 and scale.shape[0] != d)):
        raise ValueError(f"shapes q {tuple(q.shape)}, corpus "
                         f"{tuple(corpus.shape)}, mask "
                         f"{tuple(mask.shape)}"
                         + (f", scale {tuple(scale.shape)}" if q8
                            else "") + " do not match")
    k = int(min(k, n))
    if k == 0 or nq == 0:
        return (torch.zeros((nq, 0), dtype=torch.float32, device=dev),
                torch.zeros((nq, 0), dtype=torch.int32, device=dev))
    qs = q * scale if q8 else q
    with obs.kernel_span(f"kernel:{name}", dev) as sp:
        sp.add("rows", n)
        sp.add("bytes_streamed", n * d * (1 if q8 else 4))
        if dev.type == "cpu":
            return (topk_search_q8_plain(q, corpus, scale, mask, k) if q8
                    else topk_search_plain(q, corpus, mask, k))
        if dev.type != "cuda":
            raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
        *out, nl = launch_tile_scan(
            _lib(), "topk_search_q8" if q8 else "topk_search_f32",
            [qs, corpus, mask], nq, n, d, k, sp)
        _count(nl, q8)
        return tuple(out)
