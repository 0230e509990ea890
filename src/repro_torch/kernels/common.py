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

# candidate entries (scores and row ids) one tile-scan launch may write;
# a scan whose (row blocks x queries x list length) exceeds it launches
# over chunks of the queries, down to one query a launch (whose own row
# blocks x list length is the floor)
CAND_BUDGET = 1 << 25


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
    grid_x, q_begin, q_count) and the stream; ``topk_tile_grid_x`` sizes
    the grid and ``topk_tile_list_len`` the candidate lists."""
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * (n_tensors + 2)
                   + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.topk_tile_grid_x.argtypes = [ctypes.c_longlong] * 4
    lib.topk_tile_grid_x.restype = ctypes.c_longlong
    lib.topk_tile_list_len.argtypes = [ctypes.c_longlong]
    lib.topk_tile_list_len.restype = ctypes.c_longlong


def launch_tile_scan(lib: ctypes.CDLL, entry: str, inputs: list,
                     nq: int, n: int, d: int, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Launch a tile-scan kernel (csrc/topk_tile.cuh) on the current
    stream of the inputs' device and merge its per-block candidates.
    ``inputs`` are the kernel's input tensors in argument order. Any
    1 <= k <= N: k <= 128 keeps a register list per query, a larger k
    sorts blocks of rows in shared memory. The queries go in chunks
    that keep each launch's candidates within ``CAND_BUDGET``. Returns
    (scores (Q, k), ids (Q, k), number of kernel launches)."""
    dev = inputs[0].device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        gx = int(lib.topk_tile_grid_x(n, nq, sms, k))
        kk = int(lib.topk_tile_list_len(k))
        # queries a launch, within the budget (one query at the least);
        # whole 32-query tiles where more than one fits
        step = max(1, CAND_BUDGET // (gx * kk))
        if step < nq and step >= 32:
            step = step // 32 * 32
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in inputs]
        outs = []
        for q_begin in range(0, nq, step):
            qc = min(step, nq - q_begin)
            cand_s = torch.empty((gx, qc, kk), dtype=torch.float32,
                                 device=dev)
            cand_i = torch.empty((gx, qc, kk), dtype=torch.int32, device=dev)
            err = getattr(lib, entry)(
                *ptrs, cand_s.data_ptr(), cand_i.data_ptr(), nq, n, d, k,
                gx, q_begin, qc, stream)
            check(lib, err, entry)
            outs.append(merge_candidates(cand_s, cand_i, k))
        if len(outs) == 1:
            return (*outs[0], 1)
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), len(outs))


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
