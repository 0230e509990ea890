"""Wrapper of the split-K decode attention kernel (csrc/flash_decode.cu):
the generator's attention over its KV cache, one new token a step. The
partials' merge (``merge_partials``) is torch ops on every device, as
repro computes it outside its Pallas kernel."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import flash_decode_partials_plain, merge_partials

launches = 0          # CUDA kernel launches of ``flash_decode``

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def _lib():
    lib = build.load("flash_decode")
    if lib.flash_decode_partials.argtypes is None:
        lib.flash_decode_partials.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_longlong] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_decode_partials.restype = ctypes.c_int
    return lib


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: int | None = None,
                 bs: int = 512) -> torch.Tensor:
    """Single-token decode attention. q: (B, H, D); caches: (B, KV, S,
    D), one dtype (fp32 or bf16) on one device; ``cache_len``: the valid
    cache prefix (an int; None = S). The cache is cut into splits of
    ``bs`` columns (the last may be ragged); each split's partials come
    from ``flash_decode_partials`` and merge here. Returns (B, H, D) in
    q's dtype."""
    m, l, acc = flash_decode_partials(q, k_cache, v_cache, cache_len, bs)
    return merge_partials(m, l, acc).to(q.dtype)


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: int | None = None,
                          bs: int = 512
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The split partials of ``flash_decode``: fp32 m, l (B, H, ns) and
    acc (B, H, ns, D), ns = ceil(S / bs). A CPU tensor runs the plain
    PyTorch version; a CUDA tensor launches the kernel (D in 32, 64,
    128)."""
    global launches
    with obs.span("kernel:flash_decode") as sp:
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
        bs = max(1, min(int(bs), s))
        ns = -(-s // bs)
        sp.add("flops", 4 * b * h * cache_len * d)
        sp.add("bytes", (2 * b * kv * cache_len + 2 * b * h) * d
               * q.element_size())
        if dev.type == "cpu":
            return flash_decode_partials_plain(q, k_cache, v_cache,
                                               cache_len, bs)
        if dev.type != "cuda":
            raise ValueError(f"flash_decode runs on cpu or cuda, not {dev}")
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_decode: head dim {d} not in {HEAD_DIMS}")
        q = q.contiguous()
        k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
        m = torch.empty((b, h, ns), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((b, h, ns, d), dtype=torch.float32, device=dev)
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.flash_decode_partials(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(), DTYPES[q.dtype],
                b, h, kv, s, d, cache_len, bs, d ** -0.5,
                torch.cuda.current_stream(dev).cuda_stream)
        check(lib, err, "flash_decode_partials")
        launches += 1
        if sp is not obs.NOOP_SPAN:            # traced: span = device time
            torch.cuda.current_stream(dev).synchronize()
        return m, l, acc
