"""Plain PyTorch versions of the masked top-k search: the CPU path of
``ops.topk_search`` / ``ops.topk_search_q8`` and the yardsticks the CUDA
kernels are held to."""
from __future__ import annotations

import torch

from ..common import batch_invariant_scores


def topk_search_plain(q: torch.Tensor, corpus: torch.Tensor,
                      mask: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (Q, D) f32, corpus (N, D) f32, mask (N,) bool -> (scores (Q, k)
    f32 descending, idx (Q, k) int32). Masked rows score -inf; ties go
    to the lower row id (stable sort); a slot with no valid row is
    (-inf, -1)."""
    scores = batch_invariant_scores(q, corpus)
    scores = scores.masked_fill(~mask[None, :], float("-inf"))
    top_s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k].contiguous()
    top_i = pos[:, :k].to(torch.int32)
    top_i = torch.where(torch.isfinite(top_s), top_i,
                        torch.full_like(top_i, -1))
    return top_s, top_i


def topk_search_q8_plain(q: torch.Tensor, c8: torch.Tensor,
                         scale: torch.Tensor, mask: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 scan: q (Q, D) f32 unscaled, c8 (N, D) int8, scale (D,)
    f32, mask (N,) bool. Scores the scale-folded queries (q * scale)
    against the int8 rows widened to f32 (exact), then as
    ``topk_search_plain``."""
    return topk_search_plain(q * scale, c8.float(), mask, k)
