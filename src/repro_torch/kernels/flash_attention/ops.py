"""Wrappers of the flash attention kernels (csrc/flash_attention.cu): the
attention of the embedder's encoder, of the generator's prefill and of the
train path, forward and backward."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import flash_attention_bwd_plain, flash_attention_plain

# Launch counts, as the library counts them where it launches (one a call,
# one a slice of 65,535 batches above): forward kernels, and backward passes
# of three kernels each; of each, those of the tensor-core bodies
launches = 0          # forward kernels
tf32_launches = 0     # of those, fp32 in 3xTF32 (``fa_tf32_kernel``)
bwd_launches = 0      # backward passes
bwd_tc_launches = 0   # of those, bf16 on wgmma (``bwd_tc``)
bwd_tf32_launches = 0  # of those, fp32 in 3xTF32 (``bwd_tf32``)

# the library's body numbers (csrc/flash_attention.cu, enum Body)
FWD_BODIES = {"wgmma": 0, "tf32": 1, "cuda cores": 2}
BWD_BODIES = {"wgmma": 3, "tf32": 4, "cuda cores": 5}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
_entries = None


def _lib():
    """(library, ``flash_attention_fwd``, ``flash_attention_bwd``,
    ``flash_attention_launches``, ``flash_attention_bwd_scratch_floats``),
    built, loaded and declared once."""
    global _entries
    if _entries is None:
        lib = build.load("flash_attention")
        fwd = lib.flash_attention_fwd
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                        + [ctypes.c_longlong] * 6
                        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.flash_attention_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int]
                        + [ctypes.c_longlong] * 6
                        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        counts = lib.flash_attention_launches
        counts.argtypes = [ctypes.c_int]
        counts.restype = ctypes.c_longlong
        scratch = lib.flash_attention_bwd_scratch_floats
        scratch.argtypes = [ctypes.c_longlong] * 3
        scratch.restype = ctypes.c_longlong
        _entries = (lib, fwd, bwd, counts, scratch)
    return _entries


def _bodies(counts, bodies: dict) -> dict:
    """The library's launch count of each body on this thread."""
    return {name: counts(i) for name, i in bodies.items()}


def _made(counts, bodies: dict, before: dict) -> dict:
    """Launches of each body since ``before``."""
    return {name: counts(i) - before[name] for name, i in bodies.items()}


def _call(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``dev``."""
    idx = dev.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(b, h, sq, d, kv, skv), or raise on shapes, dtypes or devices the
    kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be 4-d")
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or kv < 1 or h % kv != 0):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do "
                         f"not match")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"{what}: q, k, v must share one of "
                        f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"{what}: q, k, v on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    return b, h, sq, d, kv, skv


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, want_lse: bool):
    """(o, lse or None): the kernel for CUDA tensors (contiguous inputs),
    the plain version for CPU tensors."""
    global launches, tf32_launches
    b, h, sq, d, kv, skv = _check("flash_attention", q, k, v)
    pairs = b * h * sq * skv // (2 if causal else 1)
    with obs.kernel_span("kernel:flash_attention", q.device) as sp:
        sp.add("flops", 4 * pairs * d)
        sp.add("bytes", (2 * b * h * sq + 2 * b * kv * skv) * d
               * q.element_size())
        if q.device.type == "cpu":
            if want_lse:
                return flash_attention_plain(q, k, v, causal,
                                             return_lse=True)
            return flash_attention_plain(q, k, v, causal), None
        o = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32,
                          device=q.device) if want_lse else None
        lib, fwd, _, counts, _ = _lib()
        before = _bodies(counts, FWD_BODIES)
        with sp.launch():
            err = _call(q.device, fwd, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), o.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        DTYPES[q.dtype], b, h, kv, sq, skv, d, int(causal),
                        d ** -0.5)
        check(lib, err, "flash_attention_fwd")
        made = _made(counts, FWD_BODIES, before)
        launches += sum(made.values())
        tf32_launches += made["tf32"]
        return o, lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (with its row logsumexp) and the backward
    kernel, for autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _forward(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward. q: (B, H, Sq, D); k, v: (B, KV, Skv, D), one
    dtype (fp32 or bf16) on one device, H % KV == 0. Returns (B, H, Sq,
    D) in q's dtype: softmax(q k^T / sqrt(D)) v in fp32, causal aligned
    to the last Sq key positions, 0 at a row with no visible key. A CPU
    tensor runs the plain PyTorch version; a CUDA tensor launches the
    kernel (D in 32, 64, 128; any B): bf16 at D 64 and 128 on the tensor
    cores (wgmma), fp32 at D 32 and 64 on the tensor cores in 3xTF32,
    bf16 at D 32 and fp32 at D 128 on the CUDA cores. Differentiable:
    where autograd records and an input requires grad, the forward also
    keeps each row's logsumexp and the backward is
    ``flash_attention_bwd`` (a kernel on the card); the output is the
    same, bit for bit."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                    want_lse=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` and each row's logsumexp of its scaled logits
    ((B, H, Sq) fp32, -inf for a row with no visible key): what the
    backward reads."""
    return _forward(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                    want_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention`` against ``do`` (its
    output's cotangent), from the forward's o and lse, in q's dtype with
    fp32 sums. A CPU tensor runs ``flash_attention_bwd_plain``; a CUDA
    tensor launches the backward kernel (three launches in one call, no
    atomics: a rerun gives the same bits; any B): bf16 at D 64 and 128 on
    the tensor cores (``wgmma``, P and dS each as two bf16 terms), fp32 at
    D 32 on the tensor cores in 3xTF32 (every operand as two tf32 terms),
    bf16 at D 32 and fp32 at D 64 and 128 on the CUDA cores."""
    global bwd_launches, bwd_tc_launches, bwd_tf32_launches
    b, h, sq, d, kv, skv = _check("flash_attention_bwd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    pairs = b * h * sq * skv // (2 if causal else 1)
    with obs.kernel_span("kernel:flash_attention_bwd", q.device) as sp:
        sp.add("bytes", (4 * b * h * sq + 4 * b * kv * skv) * d
               * q.element_size())
        if q.device.type == "cpu":
            sp.add("flops", 10 * pairs * d)     # the plain five products
            return flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
        lib, _, bwd, counts, scratch_floats = _lib()
        do = do.to(q.dtype)
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
        lse = lse.float().contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        scratch = torch.empty(scratch_floats(b, h, sq), dtype=torch.float32,
                              device=q.device)
        before = _bodies(counts, BWD_BODIES)
        with sp.launch():
            err = _call(q.device, bwd, *(t.data_ptr() for t in (
                q, k, v, o, do, lse, scratch, dq, dk, dv)), DTYPES[q.dtype],
                b, h, kv, sq, skv, d, int(causal), d ** -0.5)
        check(lib, err, "flash_attention_bwd")
        made = _made(counts, BWD_BODIES, before)
        # what the body executed: bf16 wgmma splits P and dS (three of the
        # five products doubled), 3xTF32 takes three products for each of
        # seven (S and dP in both kernels), the CUDA cores recompute S, dP
        sp.add("flops", (20 if made["wgmma"] else 42 if made["tf32"]
                         else 14) * pairs * d)
        bwd_launches += sum(made.values())
        bwd_tc_launches += made["wgmma"]
        bwd_tf32_launches += made["tf32"]
        return dq, dk, dv
