"""Device policy and the launch helpers the CUDA wrappers share.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises where there is none. A
wrapper picks its path from where its tensors lie, never from an option
or an environment variable: a CPU tensor takes the kernel's plain
PyTorch version, a CUDA tensor launches the hand-written kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from .build import check


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given. No
    CUDA device and no explicit device is an error, not a fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the "
                "card by default; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank
    ``ndim`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def batch_invariant_scores(q: torch.Tensor,
                           corpus: torch.Tensor) -> torch.Tensor:
    """(Q, N) dot scores, one matrix-vector product per query, so that a
    query scores bit-identically alone or inside any batch. A single
    (Q, D) x (D, N) product does not promise that: the CPU BLAS picks its
    blocking from Q, and with it the order of the sums."""
    return torch.stack([torch.mv(corpus, qi) for qi in q])


def bind(lib: ctypes.CDLL, entry: str, n_tensors: int) -> None:
    """Declare the C signatures of a tile-scan library: ``entry`` takes
    ``n_tensors`` input pointers, the two candidate outputs, (Q, N, D, k,
    grid_x) and the stream; ``topk_tile_grid_x`` sizes the grid."""
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * (n_tensors + 2)
                   + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.topk_tile_grid_x.argtypes = [ctypes.c_longlong] * 3
    lib.topk_tile_grid_x.restype = ctypes.c_longlong


def launch_tile_scan(lib: ctypes.CDLL, entry: str, inputs: list,
                     nq: int, n: int, d: int, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch a tile-scan kernel (csrc/topk_tile.cuh) on the current
    stream of the inputs' device and merge its per-block candidates.
    ``inputs`` are the kernel's input tensors in argument order."""
    dev = inputs[0].device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        gx = int(lib.topk_tile_grid_x(n, nq, sms))
        cand_s = torch.empty((gx, nq, k), dtype=torch.float32, device=dev)
        cand_i = torch.empty((gx, nq, k), dtype=torch.int32, device=dev)
        err = getattr(lib, entry)(
            *[t.data_ptr() for t in inputs], cand_s.data_ptr(),
            cand_i.data_ptr(), nq, n, d, k, gx,
            torch.cuda.current_stream(dev).cuda_stream)
        check(lib, err, entry)
        return merge_candidates(cand_s, cand_i, k)


def merge_candidates(cand_s: torch.Tensor, cand_i: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, Q, k) per-block candidate lists -> (Q, k) global top-k.

    Each block's list is ordered by (score desc, row asc) and the blocks
    cover rising row ranges, so a stable descending sort over the
    block-major concatenation keeps the lower row first on ties. Empty
    slots are (-inf, -1)."""
    g, nq, kk = cand_s.shape
    s_all = cand_s.permute(1, 0, 2).reshape(nq, g * kk)
    i_all = cand_i.permute(1, 0, 2).reshape(nq, g * kk)
    top_s, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k].contiguous()
    top_i = torch.gather(i_all, 1, pos[:, :k])
    top_i = torch.where(torch.isfinite(top_s), top_i,
                        torch.full_like(top_i, -1))
    return top_s, top_i


# Raised by every int8 (quantized=True) branch of the port: those scans
# are a later slice of the port, and nothing falls back to another path.
Q8_NOT_PORTED = ("quantized (int8) scans are not ported to repro_torch yet: "
                 "ROADMAP.md, Queue 2 items 3-4 (topk_search_q8, "
                 "temporal_window_topk_q8 and the device rescore)")
