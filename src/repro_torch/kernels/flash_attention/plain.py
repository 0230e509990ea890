"""Plain PyTorch version of the flash attention kernel: the CPU path of
``ops.flash_attention`` and the yardstick the CUDA kernel is held to."""
from __future__ import annotations

import torch


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """The function of repro's Pallas ``flash_attention_fwd`` in one pass:
    q (B, H, Sq, D), k/v (B, KV, Skv, D) -> (B, H, Sq, D) in q's dtype.
    fp32 throughout; query head h reads kv head h // (H // KV) (grouped,
    no repeat); causal column c is visible from row r iff
    r + (Skv - Sq) >= c; a row with no visible column gives 0."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, kv, g, sq, d)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k.float())
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        cols = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(rows >= cols), float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m_safe))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    out = out / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, h, sq, d).to(q.dtype)
