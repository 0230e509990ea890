"""Plain PyTorch version of the validity-masked temporal top-k: the CPU
path of ``ops.temporal_window_topk`` and the yardstick the CUDA kernel
is held to."""
from __future__ import annotations

import torch

from ..common import batch_invariant_scores


def temporal_window_topk_plain(q: torch.Tensor, corpus: torch.Tensor,
                               valid_from: torch.Tensor,
                               valid_to: torch.Tensor, t0s: torch.Tensor,
                               t1s: torch.Tensor, k: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (Q, D) f32, corpus (N, D) f32, valid_from/valid_to (N,) int64,
    t0s/t1s (Q,) int64. Row r is a candidate for query i iff
    valid_from[r] < t1s[i] and t0s[i] < valid_to[r]; the overlap filter
    is applied BEFORE ranking (leakage guard). Returns (scores (Q, k)
    f32, idx (Q, k) int32), ties to the lower row id, (-inf, -1) where
    no candidate is left."""
    valid = ((valid_from[None, :] < t1s[:, None])
             & (t0s[:, None] < valid_to[None, :]))
    scores = batch_invariant_scores(q, corpus)
    scores = scores.masked_fill(~valid, float("-inf"))
    top_s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k].contiguous()
    top_i = pos[:, :k].to(torch.int32)
    top_i = torch.where(torch.isfinite(top_s), top_i,
                        torch.full_like(top_i, -1))
    return top_s, top_i
