"""Wrapper of the fused masked top-k search kernel (csrc/topk_search.cu)."""
from __future__ import annotations

import torch

from ... import obs
from .. import build
from ..common import bind, check_tensor, launch_tile_scan
from .plain import topk_search_plain

KMAX = 64             # largest k the kernel keeps (csrc/topk_tile.cuh)
launches = 0          # CUDA launches of ``topk_search``


def _lib():
    lib = build.load("topk_search")
    if lib.topk_search_f32.argtypes is None:
        bind(lib, "topk_search_f32", 3)
    return lib


def topk_search(q, corpus, mask, k: int):
    """Masked exact top-k similarity search.

    q: (Q, D) or (D,) f32; corpus: (N, D) f32; mask: (N,) bool, all on
    one device. Returns (scores (Q, k) f32, idx (Q, k) int32) on that
    device, k clipped to N; descending, lower row id first on ties, and
    (-inf, -1) at every slot with no active row. A CPU corpus runs the
    plain PyTorch version; a CUDA corpus launches the kernel."""
    global launches
    with obs.span("kernel:topk_search") as sp:
        corpus = torch.as_tensor(corpus)
        dev = corpus.device
        q = torch.atleast_2d(torch.as_tensor(q))
        mask = torch.as_tensor(mask)
        check_tensor("corpus", corpus, torch.float32, 2, dev)
        check_tensor("q", q, torch.float32, 2, dev)
        check_tensor("mask", mask, torch.bool, 1, dev)
        nq, (n, d) = q.shape[0], corpus.shape
        if q.shape[1] != d or mask.shape[0] != n:
            raise ValueError(f"shapes q {tuple(q.shape)}, corpus "
                             f"{tuple(corpus.shape)}, mask "
                             f"{tuple(mask.shape)} do not match")
        k = int(min(k, n))
        if k == 0 or nq == 0:
            return (torch.zeros((nq, 0), dtype=torch.float32, device=dev),
                    torch.zeros((nq, 0), dtype=torch.int32, device=dev))
        sp.add("rows", n)
        sp.add("bytes_streamed", n * d * 4)
        if dev.type == "cpu":
            return topk_search_plain(q, corpus, mask, k)
        if dev.type != "cuda":
            raise ValueError(f"topk_search runs on cpu or cuda, not {dev}")
        if k > KMAX:
            raise ValueError(f"topk_search: k={k} exceeds the kernel's "
                             f"largest k, {KMAX}")
        out = launch_tile_scan(_lib(), "topk_search_f32", [q, corpus, mask],
                               nq, n, d, k)
        launches += 1
        if sp is not obs.NOOP_SPAN:            # traced: span = device time
            torch.cuda.current_stream(dev).synchronize()
        return out
