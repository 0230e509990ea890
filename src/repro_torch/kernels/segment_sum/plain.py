"""Plain PyTorch version of the gather-segment-sum kernel: the CPU path of
``ops.gather_segment_sum``, the yardstick the CUDA kernel is held to, and
the index work (``EdgePlan``) both of them sum by.

    out[d, :] = sum over edges e with dst[e] = d of x[src[e], :] * w[e, :]

repro computes this with XLA, as ``jax.ops.segment_sum(jnp.take(x, src,
axis=0) * w, dst, n_out)`` (SchNet's message passing and its readout),
whose scatter-add has no fixed order on an accelerator. Here every output
row is summed in a fixed order: its edges sorted stably (ascending edge
id), cut into chunks of at most ``CHUNK`` edges; each chunk sums its
terms from 0, one rounded product and one rounded add an edge; a row of
several chunks then sums its chunks' partials in order, from 0. The
kernel sums the same terms in the same order, so the two agree bit for
bit, and two runs do too."""
from __future__ import annotations

import functools

import torch

CHUNK = 256           # edges one reduction step sums in order


def take_rows(x: torch.Tensor, idx: torch.Tensor,
              fill: float = float("nan")) -> torch.Tensor:
    """Rows ``x[idx]`` with ``fill`` where idx < 0 (the plans mark an
    out-of-range row with -1): ``jnp.take``'s NaN rows for a bad ``src``,
    a zero cotangent for a dropped ``dst``."""
    bad = idx < 0
    rows = x.index_select(0, torch.where(bad, 0, idx).long())
    return rows.masked_fill(bad[:, None], fill)


def _order(key: torch.Tensor, keep: torch.Tensor, gather: torch.Tensor,
           rows: int, n_x: int) -> dict:
    """The summation order of one direction: the kept edges sorted stably
    by ``key`` (the output row, < ``rows``), each row's run cut into
    chunks of at most ``CHUNK``; ``gather`` indexes an x of ``n_x`` rows.
    Returns, on the edges' device:
      edge (S,) int32       the edge of each sorted slot (its row of w);
      gather (S,) int32     the row of x each slot reads (-1: a NaN row);
      start, count, key (C,) int32   each chunk's first slot, length and
                            output row;
      part (C,) int32       -1 for a row of one chunk (written directly),
                            else the chunk's row in a scratch of partials;
      mfirst, mcount, mkey (M,) int32   each row of more than one chunk:
                            its first partial, their count, the row;
      parts: the number of partials;
      gap: the longest run of output rows no chunk reaches (``rows``
                            when no edge is kept);
      longest: the most slots of a chunk (0 when no edge is kept);
      n_x, n_out, n_edges: the rows of x and of the output, and the
                            edges (rows of w) it was made for."""
    dev = key.device
    k = torch.where(keep, key, rows)
    sorted_key, edge = torch.sort(k, stable=True)
    n = int(keep.sum())
    sorted_key, edge = sorted_key[:n], edge[:n]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_start = first.nonzero()[:, 0]
    seg_len = torch.diff(seg_start, append=torch.tensor([n], device=dev))
    n_chunks = (seg_len + CHUNK - 1) // CHUNK
    total = int(n_chunks.sum())
    seg_of = torch.repeat_interleave(
        torch.arange(len(seg_start), device=dev), n_chunks,
        output_size=total)
    chunk_first = torch.cumsum(n_chunks, 0) - n_chunks
    within = torch.arange(total, device=dev) - chunk_first[seg_of]
    start = seg_start[seg_of] + within * CHUNK
    count = torch.clamp(seg_len[seg_of] - within * CHUNK, max=CHUNK)
    keys = torch.cat([torch.tensor([-1], device=dev), sorted_key[seg_start],
                      torch.tensor([rows], device=dev)])
    gap, longest = torch.stack([
        (torch.diff(keys) - 1).max(),
        torch.cat([seg_len, seg_len.new_zeros(1)]).max().clamp(
            max=CHUNK)]).tolist()
    multi = n_chunks > 1
    in_multi = multi[seg_of]
    part = torch.where(in_multi, torch.cumsum(in_multi.long(), 0) - 1, -1)
    i32 = torch.int32
    return {"edge": edge.to(i32), "gather": gather[edge].to(i32),
            "start": start.to(i32), "count": count.to(i32),
            "key": sorted_key[start].to(i32), "part": part.to(i32),
            "mfirst": part[chunk_first[multi]].to(i32),
            "mcount": n_chunks[multi].to(i32),
            "mkey": sorted_key[seg_start[multi]].to(i32),
            "parts": int(in_multi.sum()), "gap": gap, "longest": longest,
            "n_x": n_x, "n_out": rows,
            "n_edges": key.shape[0]}


class EdgePlan:
    """The index work of one edge list, made once (a batch's edges) and
    reused by every sum over it and by its backward.

    src, dst: (E,) int edge endpoints; x has ``n_src`` rows, the output
    ``n_out``. As ``jnp.take``, a src in [-n_src, -1] reads row
    src + n_src and any other src outside [0, n_src) a row of NaN; as
    ``jax.ops.segment_sum``, a dst outside [0, n_out) (negatives
    included) is dropped. Holds:
      src, dst (E,) int32   the normalised endpoints, -1 where out of
                            range (src) or dropped (dst);
      fwd                   the forward's order (``_order``): the edges
                            of a kept dst by dst, gathering x[src];
      bwd                   the gradients: the edges of a kept dst and
                            an in-range src by src, gathering the
                            cotangent's row dst;
      skip                  the edges bwd leaves out: their gradient of
                            w is a NaN row (src out of range) or
                            x[src] * 0 (dst dropped).
    """

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n_src: int,
                 n_out: int):
        if src.dim() != 1 or src.shape != dst.shape:
            raise ValueError(f"EdgePlan: src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} must be (E,)")
        if src.shape[0] >= 2 ** 31 or n_src >= 2 ** 31 or n_out >= 2 ** 31:
            raise ValueError("EdgePlan: 2^31 edges or rows or more")
        self.n_src, self.n_out = n_src, n_out
        src, dst = src.long(), dst.long()
        src = torch.where(src < 0, src + n_src, src)
        src_ok = (src >= 0) & (src < n_src)
        dst_ok = (dst >= 0) & (dst < n_out)
        self.src = torch.where(src_ok, src, -1).to(torch.int32)
        self.dst = torch.where(dst_ok, dst, -1).to(torch.int32)
        self.fwd = _order(dst, dst_ok, self.src, n_out, n_src)
        self.bwd = _order(src, src_ok & dst_ok, self.dst, n_src, n_out)

    @functools.cached_property
    def skip(self) -> torch.Tensor:
        """The edges ``bwd`` leaves out, ascending (K,) int32, made at
        first use (only the gradient of w reads them)."""
        return ((self.src < 0) | (self.dst < 0)).nonzero()[:, 0].to(
            torch.int32)


def segment_sum_plain(x: torch.Tensor, w: torch.Tensor | None,
                      order: dict) -> torch.Tensor:
    """The sums of one ``_order`` in plain PyTorch, in the kernel's order:
    x (n_x, D) fp32, w (n_edges, D) fp32 or None (ones). Each chunk sums
    x[gather] * w[edge] over its slots, from 0, one rounded product and
    one rounded add a slot; a row of several chunks sums its partials in
    order, from 0. Returns (n_out, D) fp32, 0 where no slot lands."""
    d = x.shape[1]
    dev = x.device
    start, count = order["start"].long(), order["count"]
    gather, edge = order["gather"].long(), order["edge"].long()
    acc = torch.zeros((len(start), d), dtype=torch.float32, device=dev)
    for j in range(int(count.max()) if len(count) else 0):
        live = count > j
        slot = start[live] + j
        term = take_rows(x, gather[slot])
        if w is not None:
            term = term * w[edge[slot]]
        acc[live] = acc[live] + term
    out = torch.zeros((order["n_out"], d), dtype=torch.float32, device=dev)
    single = order["part"] < 0
    out[order["key"][single].long()] = acc[single]
    parts = acc[~single]
    first, mcount = order["mfirst"].long(), order["mcount"]
    tot = torch.zeros((len(first), d), dtype=torch.float32, device=dev)
    for j in range(int(mcount.max()) if len(mcount) else 0):
        live = mcount > j
        tot[live] = tot[live] + parts[first[live] + j]
    out[order["mkey"].long()] = tot
    return out


def weight_grad(x: torch.Tensor, g: torch.Tensor, plan: EdgePlan
                ) -> torch.Tensor:
    """d out / d w against the cotangent ``g`` (n_out, D): dw[e] =
    x[src[e]] * g[dst[e]], a NaN row for an out-of-range src, 0 for a
    dropped dst (NaN where both), as ``jax.vjp`` gives: two gathers and
    one product, which the backward kernel computes row by row."""
    return take_rows(x, plan.src) * take_rows(g, plan.dst, 0.0)


def segment_sum_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                          w: torch.Tensor | None, plan: EdgePlan,
                          dx: bool = True, dw: bool = True) -> tuple:
    """Both gradients of ``segment_sum(x, w, plan.fwd)`` against the
    cotangent ``g`` (n_out, D), as the backward kernel computes them:
    (dx, dw), dx = ``segment_sum_plain(g, w, plan.bwd)`` (summed in the
    kernel's order) and dw = ``weight_grad(x, g, plan)``; None where not
    asked for, and dw None without w."""
    return (segment_sum_plain(g, w, plan.bwd) if dx else None,
            weight_grad(x, g, plan) if dw and w is not None else None)


def gather_segment_sum_plain(x: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, n_out: int,
                             w: torch.Tensor | None = None) -> torch.Tensor:
    """``gather_segment_sum``'s forward in plain PyTorch, plan included."""
    return segment_sum_plain(x, w, EdgePlan(src, dst, x.shape[0],
                                            n_out).fwd)
