"""Plain PyTorch versions of the embedding-bag kernel: the CPU paths of
``ops.embedding_bag`` and ``ops.embedding_bag_grouped`` and the
yardsticks the CUDA kernel is held to."""
from __future__ import annotations

import torch


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        combiner: str = "sum") -> torch.Tensor:
    """The function of repro's ``embedding_bag_ref``: table (V, D) f32 or
    bf16; indices (B, L) int, every negative id padding; weights (B, L)
    f32 (None = ones). Returns (B, D) in the table's dtype:

        out[b] = sum_j w[b, j] * table[idx[b, j]]  over idx[b, j] >= 0

    summed in fp32 in slot order j = 0..L-1 (the Pallas body's order),
    divided by max(sum of those w, 1e-9) for ``combiner="mean"``, and
    rounded once to the table's dtype. Padding adds nothing and does not
    count toward the sum of w; an all-padding bag gives 0. A bag with an
    id >= V is NaN (repro's ``jnp.take`` fills out-of-range rows with
    NaN); no row is read out of range."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', not "
                         f"{combiner!r}")
    b, bag = indices.shape
    v, d = table.shape
    if weights is None:
        weights = torch.ones((b, bag), dtype=torch.float32,
                             device=indices.device)
    valid = indices >= 0
    oob = indices >= v
    safe = torch.where(valid & ~oob, indices, 0).long()
    w = torch.where(valid, weights.float(), 0.0)
    acc = torch.zeros((b, d), dtype=torch.float32, device=table.device)
    wsum = torch.zeros((b, 1), dtype=torch.float32, device=table.device)
    for j in range(bag):
        term = w[:, j, None] * table[safe[:, j]].float()
        acc = torch.where(valid[:, j, None], acc + term, acc)
        wsum = wsum + w[:, j, None]
    if combiner == "mean":
        acc = acc / torch.clamp(wsum, min=1e-9)
    acc = torch.where(oob.any(1, keepdim=True), float("nan"), acc)
    return acc.to(table.dtype)


def embedding_bag_grouped_plain(tables, indices: torch.Tensor,
                                weights: torch.Tensor | None = None,
                                combiner: str = "sum",
                                out: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """``embedding_bag_plain`` of each field: tables a sequence of F
    (V_f, D) tables of one dtype; indices and weights (B, F, L). Writes
    field f's bags into out[:, f] ((B, F, D), allocated when None) and
    returns ``out``."""
    b, f, _ = indices.shape
    if out is None:
        out = torch.empty((b, f, tables[0].shape[1]),
                          dtype=tables[0].dtype, device=indices.device)
    for i, table in enumerate(tables):
        out[:, i] = embedding_bag_plain(
            table, indices[:, i], None if weights is None else weights[:, i],
            combiner)
    return out
