"""Plain-torch oracle: multi-head attention with GQA + optional causal
mask (the counterpart of repro's ``kernels/flash_attention/ref.py``).
A fully masked row comes out NaN here, as in repro's oracle; the kernel
and its plain version return 0 there."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, Sq, D); k, v: (B, KV, Skv, D) with H % KV == 0.
    Returns (B, H, Sq, D), same dtype as q. fp32 softmax internally."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        skv = k.shape[2]
        # queries are the LAST sq positions of the kv sequence
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = qpos >= torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
