"""Plain PyTorch version of the split-K decode kernel: the CPU path of
``ops.flash_decode`` and the yardstick the CUDA kernel is held to."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_decode_partials_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, cache_len: int,
                                bs: int = 512, scale: float | None = None,
                                ns: int | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The function of repro's Pallas ``flash_decode_partials``, for any
    S: q (B, H, D), caches (B, KV, S, D) -> fp32 partials m, l (B, H,
    ns) and acc (B, H, ns, D) of the splits [j * bs, (j + 1) * bs), j <
    ns (default ceil(S / bs); fewer leave out splits past
    ``cache_len``). Columns at or past ``cache_len`` (and past S, in a
    ragged last split) are masked; a split with no valid column has m =
    -inf, l = 0, acc = 0."""
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    ns = -(-s // bs) if ns is None else ns
    scale = scale if scale is not None else d ** -0.5
    rows = min(s, ns * bs)
    pad = (0, 0, 0, ns * bs - rows)
    kf = F.pad(k_cache[:, :, :rows].float(), pad).reshape(b, kv, ns, bs, d)
    vf = F.pad(v_cache[:, :, :rows].float(), pad).reshape(b, kv, ns, bs, d)
    qg = (q.float() * scale).reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,bknsd->bkgns", qg, kf)
    cols = torch.arange(ns * bs, device=q.device).reshape(ns, bs)
    logits = logits.masked_fill(~(cols < min(int(cache_len), s)),
                                float("-inf"))
    m = logits.amax(-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(torch.isneginf(logits), 0.0,
                    torch.exp(logits - m_safe[..., None]))
    l = p.sum(-1)
    acc = torch.einsum("bkgns,bknsd->bkgnd", p, vf)
    return (m.reshape(b, h, ns), l.reshape(b, h, ns),
            acc.reshape(b, h, ns, d))


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """Numerically stable merge of split-softmax partials (repro's
    ``merge_partials``). m, l: (..., ns); acc: (..., ns, D) -> (..., D)
    fp32. Each split's acc is the unnormalised p @ v, so it is rescaled
    by w = exp(m - max m) and divided by the merged sum of w * l."""
    m_glob = m.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m_glob), 0.0, m_glob)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_glob = (w * l).sum(-1)
    num = torch.einsum("...s,...sd->...d", w, acc)
    den = torch.where(l_glob == 0.0, 1.0, l_glob)
    return num / den[..., None]


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cache_len: int,
                       bs: int = 512) -> torch.Tensor:
    """Partials, then their merge: (B, H, D) in q's dtype."""
    m, l, acc = flash_decode_partials_plain(q, k_cache, v_cache, cache_len,
                                            bs)
    return merge_partials(m, l, acc).to(q.dtype)
