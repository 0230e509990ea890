"""Wrapper of the split-K decode attention kernel (csrc/flash_decode.cu):
the generator's attention over its KV cache, one new token a step. On the
card one library call computes the split partials and merges them; on
the CPU the plain partials merge with ``merge_partials``.

A cache whose sequence is split over ranks (``launch/sharding``'s decode
layouts: over "model" where the kv heads do not divide it, over the data
axes at long_500k) runs ``flash_decode_sharded``: each rank's partials
over its block (``flash_decode_block``), all-gathered, then
``merge_partials`` in rank order, as repro merges its kernel's partials
outside the kernel."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import (flash_decode_partials_plain, flash_decode_plain,
                    merge_partials)

launches = 0          # partials launches of ``flash_decode`` / its partials
                      # (one a call, one a slice of 65,535 batches above;
                      # counted by the library)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
CPU_SPLIT = 512       # repro's bs, the CPU path's split when none is given
SPLIT_TILE = 16       # cache rows of one ring stage (csrc TILE)
BLOCKS_PER_SM = 2

_sms: dict[int, int] = {}
_fwd = None


def _entry():
    """(library, its ``flash_decode_fwd``), built, loaded and declared
    once."""
    global _fwd
    if _fwd is None:
        lib = build.load("flash_decode")
        fn = lib.flash_decode_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_longlong] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_decode_launches.argtypes = []
        lib.flash_decode_launches.restype = ctypes.c_longlong
        _fwd = (lib, fn)
    return _fwd


def choose_split(kv: int, cache_len: int, sms: int) -> int:
    """Rows a split when the caller gives none: whole ``SPLIT_TILE``-row
    tiles, as few a split as keep ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs for one sequence (KV blocks a split), and as many as
    ``cache_len`` allows below that. The batch does not enter, so a
    request's splits, and its output bits, do not change with its batch."""
    target = max(1, -(-BLOCKS_PER_SM * sms // kv))   # splits a kv head
    tiles = max(1, -(-int(cache_len) // SPLIT_TILE))
    return max(1, tiles // target) * SPLIT_TILE


def _checked(q, k_cache, v_cache, cache_len):
    """Validate the inputs; returns (B, H, KV, S, D, cache_len)."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("flash_decode: q must be 3-d, the caches 4-d")
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != d or kv < 1 or h % kv != 0):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match")
    if (not (q.dtype == k_cache.dtype == v_cache.dtype)
            or q.dtype not in DTYPES):
        raise TypeError(f"flash_decode: q and the caches must share one "
                        f"of {list(DTYPES)}")
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("flash_decode: q and the caches on different "
                         "devices")
    cache_len = s if cache_len is None else int(cache_len)
    if not 0 <= cache_len <= s:
        raise ValueError(f"flash_decode: cache_len {cache_len} outside "
                         f"[0, {s}]")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_decode runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {d} not in {HEAD_DIMS}")
    return b, h, kv, s, d, cache_len


def _launch(q, k_cache, v_cache, out, part, dims, bs, ns) -> int:
    """One library call on the current stream of q's device: the
    partials into ``part`` (m, l, then acc, fp32), merged into ``out``
    unless it is None. Returns the partials launches it made (the
    library's count on this thread: one a slice of 65,535 batches)."""
    b, h, kv, s, d, cache_len = dims
    lib, fn = _entry()
    before = lib.flash_decode_launches()
    idx = q.get_device()
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if out is None else out.data_ptr(), part.data_ptr(),
            DTYPES[q.dtype], b, h, kv, s, d, cache_len, bs, ns, d ** -0.5,
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(idx):
            err = fn(*args)
    check(lib, err, "flash_decode_fwd")
    return lib.flash_decode_launches() - before


def _sm_count(q) -> int:
    idx = q.get_device()
    sms = _sms.get(idx)
    if sms is None:
        sms = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


def _span(sp, dims, es):
    b, h, kv, s, d, cache_len = dims
    sp.add("flops", 4 * b * h * cache_len * d)
    sp.add("bytes", (2 * b * kv * cache_len + 2 * b * h) * d * es)


def _cuda_inputs(q, k_cache, v_cache):
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    if (k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("flash_decode: the caches must start on a 16-byte "
                         "boundary")
    return q, k_cache, v_cache


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: int | None = None,
                 bs: int | None = None) -> torch.Tensor:
    """Single-token decode attention. q: (B, H, D); caches: (B, KV, S,
    D), one dtype (fp32 or bf16) on one device; ``cache_len``: the valid
    cache prefix (an int; None = S). The valid prefix is cut into splits
    of ``bs`` columns (the last may be ragged), whose partials merge by
    log-sum-exp weights. Returns (B, H, D) in q's dtype.

    ``bs=None`` chooses the splits: on the card ``choose_split`` (from
    KV, ``cache_len`` and the SM count, never from B), on the CPU repro's
    512. A CPU tensor runs the plain PyTorch version; a CUDA tensor makes
    one library call that launches the partials kernel and the merge
    kernel (D in 32, 64, 128)."""
    global launches
    dims = _checked(q, k_cache, v_cache, cache_len)
    b, h, kv, s, d, cache_len = dims
    with obs.kernel_span("kernel:flash_decode", q.device) as sp:
        _span(sp, dims, q.element_size())
        if bs is not None:
            bs = max(1, min(int(bs), s))
        if q.device.type == "cpu":
            return flash_decode_plain(q, k_cache, v_cache, cache_len,
                                      min(CPU_SPLIT, s) if bs is None
                                      else bs)
        if bs is None:
            bs = choose_split(kv, cache_len, _sm_count(q))
            ns = max(1, -(-cache_len // bs))     # splits with a valid row
        else:
            ns = -(-s // bs)
        q, k_cache, v_cache = _cuda_inputs(q, k_cache, v_cache)
        out = torch.empty_like(q)
        part = q.new_empty(b * h * ns * (d + 2), dtype=torch.float32)
        with sp.launch():
            made = _launch(q, k_cache, v_cache, out, part, dims, bs, ns)
        launches += made
        return out


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: int | None = None,
                          bs: int = CPU_SPLIT, ns: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The split partials of ``flash_decode`` at an explicit ``bs``:
    fp32 m, l (B, H, ns) and acc (B, H, ns, D) of the splits [j * bs,
    (j + 1) * bs), j < ns, the splits past ``cache_len`` empty (m = -inf,
    l = 0, acc = 0). ``ns`` defaults to ceil(S / bs); fewer splits (at
    least those with a valid column, and at least one) leave out empty
    ones. A CPU tensor runs the plain PyTorch version; a CUDA tensor
    launches the same partials kernel as ``flash_decode``, without the
    merge."""
    global launches
    dims = _checked(q, k_cache, v_cache, cache_len)
    b, h, kv, s, d, cache_len = dims
    with obs.kernel_span("kernel:flash_decode", q.device) as sp:
        _span(sp, dims, q.element_size())
        bs = max(1, min(int(bs), s))
        most = -(-s // bs)
        ns = most if ns is None else int(ns)
        if not max(1, -(-cache_len // bs)) <= ns <= most:
            raise ValueError(f"flash_decode_partials: {ns} splits of {bs} "
                             f"for cache_len {cache_len} of {s}")
        if q.device.type == "cpu":
            return flash_decode_partials_plain(q, k_cache, v_cache,
                                               cache_len, bs, ns=ns)
        q, k_cache, v_cache = _cuda_inputs(q, k_cache, v_cache)
        n = b * h * ns
        part = q.new_empty(n * (d + 2), dtype=torch.float32)
        with sp.launch():
            made = _launch(q, k_cache, v_cache, None, part, dims, bs, ns)
        launches += made
        m, l = part[:n].view(b, h, ns), part[n:2 * n].view(b, h, ns)
        acc = part[2 * n:].view(b, h, ns, d)
        return m, l, acc


def block_splits(kv: int, cache_len: int, s_loc: int, n_blocks: int,
                 q: torch.Tensor) -> list[tuple[int, int, int]]:
    """(valid rows, bs, splits) of each block of a cache whose sequence
    is cut into ``n_blocks`` blocks of ``s_loc`` rows, ``cache_len``
    entries valid in all: a block's valid rows are clamp(cache_len -
    start, 0, s_loc), its split ``flash_decode``'s (on the card
    ``choose_split`` over the block's own valid rows, on the CPU repro's
    512), its splits those with a valid row (one for an empty block).
    Every rank computes the whole list, so each knows the others'."""
    out = []
    for blk in range(n_blocks):
        valid = max(0, min(s_loc, int(cache_len) - blk * s_loc))
        bs = min(CPU_SPLIT, s_loc) if q.device.type == "cpu" else \
            choose_split(kv, valid, _sm_count(q))
        bs = max(1, min(bs, s_loc))
        out.append((valid, bs, max(1, -(-valid // bs))))
    return out


def flash_decode_block(q: torch.Tensor, k_block: torch.Tensor,
                       v_block: torch.Tensor, cache_len: int, block: int,
                       n_blocks: int) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """One rank's part of ``flash_decode_sharded``, no collective: the
    partials (``flash_decode_partials``) of its block ``block`` of
    ``n_blocks``, k_block / v_block (B, KV, S_loc, D) holding the rows
    [block * S_loc, (block + 1) * S_loc) of a cache with ``cache_len``
    valid entries, at the block's split (``block_splits``), padded with
    empty splits (m = -inf, l = 0, acc = 0) to the largest split count
    of the blocks, so that the blocks' partials concatenate. A block
    with no valid row launches the kernel on 0 rows: all empty."""
    kv, s_loc = k_block.shape[1], k_block.shape[2]
    plan = block_splits(kv, cache_len, s_loc, n_blocks, q)
    valid, bs, ns = plan[block]
    m, l, acc = flash_decode_partials(q, k_block, v_block, valid, bs, ns)
    pad = max(n for _, _, n in plan) - ns
    if pad:
        b, h = m.shape[:2]
        m = torch.cat([m, m.new_full((b, h, pad), float("-inf"))], 2)
        l = torch.cat([l, l.new_zeros((b, h, pad))], 2)
        acc = torch.cat([acc, acc.new_zeros((b, h, pad, acc.shape[3]))], 2)
    return m, l, acc


def flash_decode_sharded(q: torch.Tensor, k_block: torch.Tensor,
                         v_block: torch.Tensor, cache_len: int, block: int,
                         n_blocks: int, gather) -> torch.Tensor:
    """Decode attention over a cache whose sequence is split into
    ``n_blocks`` blocks over ranks, this rank holding block ``block``
    (k_block / v_block (B, KV, S_loc, D)): its partials
    (``flash_decode_block``), ``gather(t)`` of each (m, l, acc) along
    dimension 2 in block order (an all-gather over the axes that split
    the sequence), then ``merge_partials``. Returns (B, H, D) in q's
    dtype. One block calls ``flash_decode`` unchanged."""
    if n_blocks == 1:
        return flash_decode(q, k_block, v_block, cache_len=cache_len)
    m, l, acc = flash_decode_block(q, k_block, v_block, cache_len, block,
                                   n_blocks)
    return merge_partials(gather(m), gather(l), gather(acc)).to(q.dtype)
