"""Wrapper of the flash attention kernel (csrc/flash_attention.cu): the
attention of the embedder's encoder and of the generator's prefill."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import flash_attention_plain

launches = 0          # CUDA kernel launches of ``flash_attention``

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
_fwd = None


def _entry():
    """(library, its ``flash_attention_fwd``), built, loaded and declared
    once."""
    global _fwd
    if _fwd is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = (lib, fn)
    return _fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward. q: (B, H, Sq, D); k, v: (B, KV, Skv, D), one
    dtype (fp32 or bf16) on one device, H % KV == 0. Returns (B, H, Sq,
    D) in q's dtype: softmax(q k^T / sqrt(D)) v in fp32, causal aligned
    to the last Sq key positions, 0 at a row with no visible key. A CPU
    tensor runs the plain PyTorch version; a CUDA tensor launches the
    kernel (D in 32, 64, 128): bf16 at D 64 and 128 on the tensor cores
    (wgmma), fp32 and bf16 at D 32 on the CUDA cores."""
    global launches
    with obs.span("kernel:flash_attention") as sp:
        if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
            raise ValueError("flash_attention: q, k, v must be 4-d")
        b, h, sq, d = q.shape
        kv, skv = k.shape[1], k.shape[2]
        if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
                or kv < 1 or h % kv != 0):
            raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, v {tuple(v.shape)} do "
                             f"not match")
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
            raise TypeError(f"flash_attention: q, k, v must share one of "
                            f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        dev = q.device
        if k.device != dev or v.device != dev:
            raise ValueError("flash_attention: q, k, v on different devices")
        pairs = b * h * sq * skv // (2 if causal else 1)
        sp.add("flops", 4 * pairs * d)
        sp.add("bytes", (2 * b * h * sq + 2 * b * kv * skv) * d
               * q.element_size())
        if dev.type == "cpu":
            return flash_attention_plain(q, k, v, causal)
        if dev.type != "cuda":
            raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {d} not in "
                             f"{HEAD_DIMS}")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = torch.empty_like(q)
        lib, fn = _entry()
        idx = q.get_device()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                DTYPES[q.dtype], b, h, kv, sq, skv, d, int(causal), d ** -0.5,
                torch._C._cuda_getCurrentRawStream(idx))
        if idx == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(idx):
                err = fn(*args)
        check(lib, err, "flash_attention_fwd")
        launches += 1
        if sp is not obs.NOOP_SPAN:            # traced: span = device time
            torch.cuda.current_stream(dev).synchronize()
        return o
