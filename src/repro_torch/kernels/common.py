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

from .. import obs
from .build import check

# the tile scans' two selection paths (csrc/topk_tile.cuh): a register
# list per query for k <= KMAX, the radix select above it; the select
# orders its k answers in the kernel up to ORDER_MAX, the caller above it
KMAX = 128
ORDER_MAX = 8192
# candidate entries (scores and row ids) one list-path launch may write;
# a scan whose (row blocks x queries x k) exceeds it launches over chunks
# of the queries
CAND_BUDGET = 1 << 25
# bytes of the (queries x N) 32-bit key buffer of one select-path launch;
# one query (N x 4 bytes) is the floor
KEY_BUDGET = 1 << 30
# queries of one select-path launch, at most (a grid dimension), in whole
# 32-query tiles
SELECT_MAX_QUERIES = 65504


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


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; a CPU one
    for ``meta`` (whose tensors hold no values: the dry run's shapes)."""
    gen_dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=gen_dev).manual_seed(seed)


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


def query_chunks(nq: int, per_query: int, budget: int,
                 max_queries: int | None = None) -> list[tuple[int, int]]:
    """Split ``nq`` queries into launches of (q_begin, q_count) whose
    ``per_query`` cost each stays within ``budget``: one query a launch
    at the least (whatever its own cost), whole 32-query tiles where
    more than one fits, and no more than ``max_queries``."""
    step = max(1, budget // max(1, per_query))
    if max_queries is not None:
        step = min(step, max_queries)
    if step < nq and step >= 32:
        step = step // 32 * 32
    return [(b, min(step, nq - b)) for b in range(0, nq, step)]


def scan_chunks(nq: int, n: int, k: int, grid_x: int
                ) -> list[tuple[int, int]]:
    """The launches of one tile scan: the list path's chunks keep their
    candidates (grid_x x queries x k) within ``CAND_BUDGET``, the select
    path's keep their (queries x N) key buffer within ``KEY_BUDGET``."""
    if k > KMAX:
        return query_chunks(nq, 4 * n, KEY_BUDGET, SELECT_MAX_QUERIES)
    return query_chunks(nq, grid_x * k, CAND_BUDGET)


def bind(lib: ctypes.CDLL, entry: str, n_tensors: int) -> None:
    """Declare the C signatures of a tile-scan library: ``entry`` takes
    ``n_tensors`` input pointers, the two outputs, the workspace, (Q, N,
    D, k, grid_x, q_begin, q_count) and the stream; ``topk_tile_grid_x``
    sizes the grid, ``topk_tile_work_bytes`` the select path's workspace
    and ``topk_tile_decode`` writes out the answers the caller sorted."""
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * (n_tensors + 3)
                   + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.topk_tile_grid_x.argtypes = [ctypes.c_longlong] * 3
    lib.topk_tile_grid_x.restype = ctypes.c_longlong
    lib.topk_tile_work_bytes.argtypes = [ctypes.c_longlong] * 3
    lib.topk_tile_work_bytes.restype = ctypes.c_longlong
    lib.topk_tile_decode.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_longlong] * 2
                                     + [ctypes.c_void_p])
    lib.topk_tile_decode.restype = ctypes.c_int


def launch_tile_scan(lib: ctypes.CDLL, entry: str, inputs: list,
                     nq: int, n: int, d: int, k: int, sp=obs.NOOP_SPAN
                     ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Launch a tile-scan library call (csrc/topk_tile.cuh) on the current
    stream of the inputs' device, once a chunk of the queries
    (``scan_chunks``). ``inputs`` are the kernel's input tensors in
    argument order. Any 1 <= k <= N: k <= 128 keeps a register list per
    query and merges the per-block candidates here; a larger k runs the
    radix select, which returns each query's k answers (ordered here with
    one sort of k entries a query only for k > 8192). Each library call
    is a launch of the caller's kernel span ``sp`` (``Span.launch``).
    Returns (scores (Q, k), ids (Q, k), number of library calls)."""
    dev = inputs[0].device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        gx = int(lib.topk_tile_grid_x(n, nq, sms))
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in inputs]
        outs = []
        for q_begin, qc in scan_chunks(nq, n, k, gx):
            if k > KMAX:
                out_s = torch.empty((qc, k), dtype=torch.float32, device=dev)
                out_i = torch.empty((qc, k), dtype=torch.int32, device=dev)
                work = torch.empty(int(lib.topk_tile_work_bytes(qc, n, k)),
                                   dtype=torch.uint8, device=dev)
                with sp.launch():
                    err = getattr(lib, entry)(
                        *ptrs, out_s.data_ptr(), out_i.data_ptr(),
                        work.data_ptr(), nq, n, d, k, gx, q_begin, qc,
                        stream)
                check(lib, err, entry)
                if k > ORDER_MAX:        # the k packed slots lead `work`
                    packed = work[:qc * k * 8].view(torch.int64).view(qc, k)
                    packed = torch.sort(packed, dim=1).values
                    with sp.launch():
                        err = lib.topk_tile_decode(
                            packed.data_ptr(), out_s.data_ptr(),
                            out_i.data_ptr(), qc, k, stream)
                    check(lib, err, "topk_tile_decode")
                outs.append((out_s, out_i))
                continue
            cand_s = torch.empty((gx, qc, k), dtype=torch.float32,
                                 device=dev)
            cand_i = torch.empty((gx, qc, k), dtype=torch.int32, device=dev)
            with sp.launch():
                err = getattr(lib, entry)(
                    *ptrs, cand_s.data_ptr(), cand_i.data_ptr(), None, nq, n,
                    d, k, gx, q_begin, qc, stream)
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
