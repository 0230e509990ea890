"""Plain-torch oracle for single-token decode attention over a KV cache
(the counterpart of repro's ``kernels/flash_decode/ref.py``): query
heads grouped per kv head, no repeat of the cache."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k_cache, v_cache, cache_len=None,
                         scale: float | None = None):
    """q: (B, H, D) one new token; k_cache/v_cache: (B, KV, S, D);
    cache_len: (B,) int valid prefix length (None = full). Returns
    (B, H, D)."""
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.float() * scale).reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    if cache_len is not None:
        cache_len = torch.as_tensor(cache_len, device=q.device)
        mask = (torch.arange(s, device=q.device)[None, None, None, :]
                < cache_len[:, None, None, None])
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
