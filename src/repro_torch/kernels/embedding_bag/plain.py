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
    count toward the sum of w; an all-padding bag gives 0. An id >= V
    adds a row of NaN to the sum, as repro's ``jnp.take`` fills
    out-of-range rows with NaN: its bag is NaN, and so is autograd's
    gradient of its weights (``sum``: at that slot; ``mean``: at every
    slot but padding, through the division). No row is read out of
    range."""
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
        row = torch.where(oob[:, j, None], float("nan"),
                          table[safe[:, j]].float())
        acc = torch.where(valid[:, j, None], acc + w[:, j, None] * row, acc)
        wsum = wsum + w[:, j, None]
    if combiner == "mean":
        acc = acc / torch.clamp(wsum, min=1e-9)
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


# ---------------------------------------------------------------------------
# backward: the dense table gradient
# ---------------------------------------------------------------------------
CHUNK = 256           # slots one reduction step sums in order (csrc BWD_CHUNK)


def bag_segments(sizes, indices: torch.Tensor,
                 weights: torch.Tensor | None, combiner: str,
                 chunk: int = CHUNK) -> dict:
    """Index preparation of the bag backward over a group of tables of
    ``sizes`` rows: which slots add to which row, in what order.

    Field f's row r is row ``key = offset[f] + r`` of the group's stacked
    gradient (the F tables' rows back to back). Every slot (b, f, l) whose
    id is in [0, V_f) adds ``coef * g[b, f]`` to its key's row, with
    ``coef`` its weight (1 without weights; over max(bag's weight sum,
    1e-9) for ``mean``); padding and ids >= V_f add nothing. A stable sort
    of the keys puts each row's slots in slot order (b, then l). Each
    row's run is cut into chunks of at most ``chunk`` slots. Returns, on
    the ids' device:
      slot (N,) int32       the flat (b, f, l) index of each sorted slot;
      coef (N,) f32 or None its coefficient (None: all 1);
      start, count (C,) int32, key (C,) int64   each chunk's first sorted
                            slot, length and row;
      part (C,) int32       -1 for a row of one chunk (written directly),
                            else the chunk's row in a scratch of partials;
      multi_first, multi_count (M,) int32, multi_key (M,) int64   each
                            row of more than one chunk: its first partial
                            and count;
      rows: the group's total row count.
    The sort and the cuts are index work; the sums are the kernel's (or
    ``embedding_bag_backward_plain``'s), in this order."""
    dev = indices.device
    b, f, bag = indices.shape
    v = torch.tensor(list(sizes), dtype=torch.int64, device=dev)
    offset = torch.cumsum(v, 0) - v
    ids = indices.long()
    valid = (ids >= 0) & (ids < v[None, :, None])
    rows = int(sum(sizes))
    key = torch.where(valid, ids + offset[None, :, None], rows).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    n = int(valid.sum())
    sorted_key, order = sorted_key[:n], order[:n]
    coef = None
    if weights is not None or combiner == "mean":
        w = torch.ones((b, f, bag), dtype=torch.float32, device=dev) \
            if weights is None else weights.float()
        w = torch.where(ids >= 0, w, 0.0)
        if combiner == "mean":
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        coef = w.reshape(-1)[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_start = first.nonzero()[:, 0]
    seg_len = torch.diff(seg_start, append=torch.tensor([n], device=dev))
    n_chunks = (seg_len + chunk - 1) // chunk
    total = int(n_chunks.sum())
    seg_of = torch.repeat_interleave(torch.arange(len(seg_start),
                                                  device=dev), n_chunks)
    chunk_first = torch.cumsum(n_chunks, 0) - n_chunks
    within = torch.arange(total, device=dev) - chunk_first[seg_of]
    start = seg_start[seg_of] + within * chunk
    count = torch.clamp(seg_len[seg_of] - within * chunk, max=chunk)
    multi = n_chunks > 1
    in_multi = multi[seg_of]
    part = torch.where(in_multi, torch.cumsum(in_multi.long(), 0) - 1, -1)
    m_first = part[chunk_first[multi]]
    return {"slot": order.to(torch.int32), "coef": coef,
            "start": start.to(torch.int32), "count": count.to(torch.int32),
            "key": sorted_key[start], "part": part.to(torch.int32),
            "multi_first": m_first.to(torch.int32),
            "multi_count": n_chunks[multi].to(torch.int32),
            "multi_key": sorted_key[seg_start[multi]], "rows": rows,
            "parts": int(in_multi.sum())}


def embedding_bag_backward_plain(sizes, dtype: torch.dtype,
                                 indices: torch.Tensor,
                                 weights: torch.Tensor | None,
                                 combiner: str, grad: torch.Tensor,
                                 seg: dict | None = None) -> torch.Tensor:
    """The bag backward in plain PyTorch, in the kernel's order: grad (B,
    F, D) is the cotangent of the group's bags; returns the (sum(sizes),
    D) stacked table gradient in ``dtype`` (field f's rows from
    offset[f]). Each chunk of a row's slots sums coef * g[b, f] in fp32
    in slot order, from 0, one rounded product and one rounded add a
    slot; a row of several chunks then sums its chunks' partials in
    order, from 0; the row is rounded once to ``dtype``. Rows no slot
    reaches are 0: jnp.take's VJP as XLA computes it for repro's
    reference."""
    seg = seg if seg is not None else bag_segments(sizes, indices, weights,
                                                   combiner)
    b, f, bag = indices.shape
    d = grad.shape[-1]
    dev = grad.device
    slot = seg["slot"].long()
    g = grad.float()[slot // (f * bag), (slot // bag) % f]      # (N, D)
    if seg["coef"] is not None:
        g = seg["coef"][:, None] * g
    start, count = seg["start"].long(), seg["count"]
    acc = torch.zeros((len(start), d), dtype=torch.float32, device=dev)
    for j in range(int(count.max()) if len(count) else 0):
        live = count > j
        acc[live] = acc[live] + g[start[live] + j]
    out = torch.zeros((seg["rows"], d), dtype=torch.float32, device=dev)
    single = seg["part"] < 0
    out[seg["key"][single]] = acc[single]
    parts = acc[~single]
    first, mcount = seg["multi_first"].long(), seg["multi_count"]
    tot = torch.zeros((len(first), d), dtype=torch.float32, device=dev)
    for j in range(int(mcount.max()) if len(mcount) else 0):
        live = mcount > j
        tot[live] = tot[live] + parts[first[live] + j]
    out[seg["multi_key"]] = tot
    return out.to(dtype)


def embedding_bag_weights_grad_plain(tables, indices: torch.Tensor,
                                     weights: torch.Tensor, combiner: str,
                                     grad: torch.Tensor) -> torch.Tensor:
    """d(bags)/d(weights) against ``grad``, by autograd through
    ``embedding_bag_grouped_plain`` with the tables held fixed (DLRM does
    not train weights; repro computes this row dot outside any
    kernel)."""
    with torch.enable_grad():
        w = weights.detach().float().requires_grad_(True)
        out = embedding_bag_grouped_plain([t.detach() for t in tables],
                                          indices, w, combiner)
        return torch.autograd.grad(out, w, grad.to(out.dtype))[0]
