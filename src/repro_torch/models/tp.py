"""Megatron tensor parallelism of the LM family (serving and training):
one rank's bodies, with no communication.

Under repro's ``launch/sharding.lm_param_specs`` a model rank (index m
of n on "model") holds column blocks of ``wq`` / ``wk`` / ``wv`` (and
their biases), of the MLP's ``win``, of the shared experts'
``shared_w_in`` and of ``lm_head``; row blocks of ``wo``, ``wout``,
``shared_w_out`` and of the embedding. Each function here computes one
rank's value before its collective, in the style of
``models/moe.moe_local``, so that the same function runs under a process
group (``models/transformer``'s forward, prefill and decode on a
``tp_mesh``, each collective a ``launch/collectives`` call) and in a replay of a mesh's
ranks one after another on one card (``chip_smoke.py`` phase 13, each
collective done by hand):

  - ``embed_local``: the rank's vocab rows, zeros for the others (summed
    over "model": one row plus zeros);
  - ``qkv_local``: the rank's projection columns, biases added;
  - ``attention_heads``: the whole heads its attention needs out of those
    columns, or out of all of them once gathered over "model"
    (``HeadPlan.gather_q`` / ``gather_kv``), RoPE at the global positions;
  - ``attn_out_local``: its ``wo`` rows on the attention output: a
    partial (summed over "model");
  - ``mlp_local``: ``win`` column-parallel, the activation, ``wout``
    row-parallel: a partial;
  - ``logits_local``: its vocab columns of the head (gathered over
    "model" to serve);
  - ``vocab_parallel_cross_entropy``: a train cell's loss on those
    columns, never gathered: three reductions over "model" (the row max,
    the sum of exponentials, the gold logit), passed in as callables.

Heads cut in the middle. ``sanitize`` keeps a split of a fused head
dimension that cuts a head in two (Mistral-NeMo's and Nemotron-4's
``wk`` / ``wv`` on 16 model ranks: 64 columns, half a kv head;
Qwen1.5-32B's ``wq`` on 16: 2.5 heads). A rank's attention computes the
heads its ``wo`` rows touch (widened to whole kv groups where they span
more than one: ``HeadPlan``);
where its projection columns do not hold them, the columns are
all-gathered over "model" first, as GSPMD would. A decode cache split by
sequence over "model" holds every head of its rows, so there each rank
computes every head over its block and the partials merge across ranks
(``kernels/flash_decode/ops.flash_decode_sharded``).

A gated ``win`` is ``[gate | up]`` (repro's ``mlp_block`` splits it in
two halves). Cut contiguously over "model", rank 0 of 4 would hold only
gate columns. ``serving_blocks`` therefore gives each rank the gate and
up columns that match its ``wout`` rows, ``[gate_r | up_r]``
(``gated_block``), when it cuts the params (a serving or a train cell's;
a train cell's optimizer state lies in that layout too); ``mlp_local`` is then
repro's ``mlp_block`` on the rank's blocks. A rank's bytes are those of
the contiguous cut. The shared experts' ``shared_w_in`` is cut the same
way.
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import apply_rope, mlp_block, pick

GATED = ("swiglu", "geglu")


def _block(total: int, local: int, idx: int, n: int, what: str) -> tuple:
    """(lo, hi) of the block a rank at ``idx`` of ``n`` holds of a
    ``total``-wide dimension of which it holds ``local``: the whole where
    local == total, else block ``idx``."""
    if local == total:
        return 0, total
    if local * n != total:
        raise ValueError(f"{what}: {local} of {total} is not a block of "
                         f"{n} ranks")
    return idx * local, (idx + 1) * local


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """What one model rank's attention reads and computes, all as (lo,
    hi) ranges of the global dimension:

      q_cols / kv_cols: the columns of ``wq`` / ``wk`` (= ``wv``) it holds;
      wo_rows: the rows of ``wo`` it holds;
      heads: the query heads its attention computes (those its wo rows
        touch, widened to whole kv groups where they span more than one);
      kv_heads: the kv heads whose keys and values it computes (the
        cache's kv heads on the rank at decode; those ``heads`` read at
        prefill);
      read_kv: the kv heads ``heads`` read, within ``kv_heads``;
      gather_q / gather_kv: whether the q (kv) columns must be
        all-gathered over "model" first (they do not hold ``heads``'s /
        ``kv_heads``'s columns)."""
    q_cols: tuple
    kv_cols: tuple
    wo_rows: tuple
    heads: tuple
    kv_heads: tuple
    read_kv: tuple
    gather_q: bool
    gather_kv: bool

    def q_source(self, d_head: int, n_heads: int) -> tuple:
        """The column range of the q tensor ``attention_heads`` gets."""
        return (0, n_heads * d_head) if self.gather_q else self.q_cols

    def kv_source(self, d_head: int, n_kv: int) -> tuple:
        return (0, n_kv * d_head) if self.gather_kv else self.kv_cols


def head_plan(cfg, attn, m_idx: int, n_model: int,
              cache_kv: int | None = None,
              seq_over_model: bool = False) -> HeadPlan:
    """The ``HeadPlan`` of model rank ``m_idx`` of ``n_model`` from the
    shapes of its attention blocks ``attn`` (``wq``, ``wk``, ``wo``).
    ``cache_kv``: the kv heads of the rank's decode cache (None at
    prefill); ``seq_over_model``: the cache's sequence is split over
    "model" (every rank then computes every head over its block)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    g = h // kv
    q_cols = _block(h * dh, attn["wq"].shape[-1], m_idx, n_model, "wq")
    kv_cols = _block(kv * dh, attn["wk"].shape[-1], m_idx, n_model, "wk")
    wo_rows = _block(h * dh, attn["wo"].shape[-2], m_idx, n_model, "wo")
    if n_model > 1 and wo_rows == (0, h * dh):
        raise ValueError(f"{cfg.name}: wo is whole on each of {n_model} "
                         f"model ranks; its partials would be summed "
                         f"{n_model} times")
    # the heads that the wo rows touch, and the kv groups they belong to
    wo_heads = (wo_rows[0] // dh, -(-wo_rows[1] // dh))
    lo, hi = wo_heads[0] // g, -(-wo_heads[1] // g)
    if cache_kv is not None and cache_kv < kv:       # cache split by heads
        kv_heads = _block(kv, cache_kv, m_idx, n_model, "cache kv heads")
        if not (kv_heads[0] <= lo and hi <= kv_heads[1]):
            raise ValueError(f"{cfg.name}: wo rows {wo_rows} read kv heads "
                             f"outside the cache's {kv_heads}")
        read_kv = kv_heads
        heads = (kv_heads[0] * g, kv_heads[1] * g)
    elif cache_kv is not None and seq_over_model:     # every head, a block
        kv_heads = read_kv = (0, kv)
        heads = (0, h)
    else:
        kv_heads = (0, kv) if cache_kv is not None else (lo, hi)
        read_kv = (lo, hi)
        # within one kv group any run of heads reads it; across groups
        # the attention kernels need whole groups
        heads = wo_heads if hi - lo == 1 else (lo * g, hi * g)
    need_q = (heads[0] * dh, heads[1] * dh)
    need_kv = (kv_heads[0] * dh, kv_heads[1] * dh)
    return HeadPlan(q_cols, kv_cols, wo_rows, heads, kv_heads, read_kv,
                    not (q_cols[0] <= need_q[0] and need_q[1] <= q_cols[1]),
                    not (kv_cols[0] <= need_kv[0]
                         and need_kv[1] <= kv_cols[1]))


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------
def embed_local(table: torch.Tensor, tokens: torch.Tensor, m_idx: int,
                n_model: int, vocab: int) -> torch.Tensor:
    """The rank's part of the embedding of ``tokens`` (B, S): the rows
    of the ids in its vocab block ``table`` (V_loc, D), or (V_loc,) for a
    table of scalars (the FM's and Wide&Deep's linear weights), zeros for
    the others, so that the sum over "model" is the whole table's rows. An
    id in [-V, -1] reads row id + V and any other id outside [0, V) gives
    a row of NaN on the rank that holds the last rows (repro's
    ``jnp.take``; ``recsys.lookup``'s rule), zeros on the others. A table
    that is whole on every rank (a vocab that does not divide) is read
    by model rank 0 alone."""
    v_loc = table.shape[0]
    lo, hi = _block(vocab, v_loc, m_idx, n_model, "vocab")
    if v_loc == vocab and m_idx:
        lo = hi = vocab                       # rank 0 reads the whole table
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + vocab, ids)
    local = ids - lo
    mine = (local >= 0) & (local < hi - lo)
    rows = table[local.clamp(0, v_loc - 1)]
    trail = [1] * (table.dim() - 1)          # a 1-d table's rows are scalars
    rows = rows.masked_fill(~mine.reshape(*mine.shape, *trail), 0.0)
    if hi == vocab and lo < hi:
        bad = (ids < 0) | (ids >= vocab)
        rows = rows.masked_fill(bad.reshape(*bad.shape, *trail),
                                float("nan"))
    return rows


def qkv_local(attn, x: torch.Tensor) -> tuple:
    """The rank's projection columns of x (B, S, D): (q, k, v) of its
    ``wq`` / ``wk`` / ``wv`` blocks, each plus its bias block where the
    layer has biases (repro's ``attention_qkv`` before the head split)."""
    q = torch.matmul(x, attn["wq"])
    k = torch.matmul(x, attn["wk"])
    v = torch.matmul(x, attn["wv"])
    if "bq" in attn:
        q, k, v = q + attn["bq"], k + attn["bk"], v + attn["bv"]
    return q, k, v


def _heads(cols: torch.Tensor, src: tuple, heads: tuple, d_head: int,
           positions, theta: float, rope: bool) -> torch.Tensor:
    b, s = cols.shape[:2]
    lo = heads[0] * d_head - src[0]
    t = cols[..., lo:lo + (heads[1] - heads[0]) * d_head]
    t = t.reshape(b, s, heads[1] - heads[0], d_head)
    if rope:
        t = apply_rope(t, positions, theta)
    return t.transpose(1, 2)


def attention_heads(q, k, v, plan: HeadPlan, cfg, positions) -> tuple:
    """q (B, Hn, S, Dh) of ``plan.heads`` and k, v (B, KVn, S, Dh) of
    ``plan.kv_heads`` from the columns ``q`` / ``k`` / ``v`` (B, S, *):
    the rank's own (``qkv_local``), or all of them where the plan
    gathers; RoPE at ``positions``, the global ones."""
    dh, theta = cfg.d_head, cfg.rope_theta
    qs, ks = plan.q_source(dh, cfg.n_heads), plan.kv_source(dh, cfg.n_kv)
    return (_heads(q, qs, plan.heads, dh, positions, theta, True),
            _heads(k, ks, plan.kv_heads, dh, positions, theta, True),
            _heads(v, ks, plan.kv_heads, dh, positions, theta, False))


def attn_out_local(o: torch.Tensor, wo: torch.Tensor, plan: HeadPlan,
                   d_head: int) -> torch.Tensor:
    """The rank's partial of the attention output: o (B, S, Hn * Dh),
    the attention of ``plan.heads``, cut to its ``wo`` rows, times them."""
    lo = plan.wo_rows[0] - plan.heads[0] * d_head
    return torch.matmul(o[..., lo:lo + wo.shape[0]], wo)


def mlp_local(mlp, x: torch.Tensor, act: str) -> torch.Tensor:
    """The rank's partial of the MLP: repro's ``mlp_block`` on its
    blocks, ``win``'s columns (``[gate_r | up_r]`` when gated,
    ``gated_block``) then ``wout``'s matching rows."""
    return mlp_block(mlp, x, act)


def logits_local(hidden: torch.Tensor, lm_head: torch.Tensor
                 ) -> torch.Tensor:
    """The rank's vocab columns of the logits."""
    return torch.matmul(hidden, lm_head)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 lo: int, reduce_sum, reduce_max,
                                 ignore_id: int = -1) -> torch.Tensor:
    """``layers.cross_entropy_loss`` of the whole logits from one rank's
    vocab columns [lo, lo + V_loc): ``logits`` (B, S, V_loc) as the head
    gives them (the model dtype), taken to fp32 as the unsharded loss
    takes them; labels (B, S), ``ignore_id`` ignored. ``reduce_max`` /
    ``reduce_sum`` reduce a tensor over "model" (the max gets no
    gradient; the sum's backward sums the ranks' cotangents,
    ``launch/collectives``): the row max, then the sum of exp(logit -
    max), then the gold logit, which only the rank whose block holds the
    label contributes. The (B, S, V) logits are never gathered."""
    x = logits.float()
    m = reduce_max(x.detach().amax(-1))
    sumexp = reduce_sum(torch.exp(x - m[..., None]).sum(-1))
    local = labels.long() - lo
    mine = (local >= 0) & (local < x.shape[-1])
    gold = pick(x, -1, local.clamp(0, x.shape[-1] - 1)[..., None])
    gold = reduce_sum(torch.where(mine, gold[..., 0], 0.0))
    mask = (labels != ignore_id).float()
    return ((torch.log(sumexp) + m - gold) * mask).sum() / \
        torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# cutting the params
# ---------------------------------------------------------------------------
def gated_leaf(path: str, act: str) -> bool:
    """A leaf whose last dimension is ``[gate | up]``."""
    return act in GATED and (path.endswith("['mlp']['win']") or
                             path.endswith("['moe']['shared_w_in']"))


def gated_block(leaf: torch.Tensor, idx: int, n: int) -> torch.Tensor:
    """Block ``idx`` of ``n`` of a ``[gate | up]`` leaf's last dimension
    (2F) as ``[gate_idx | up_idx]``: the gate and up columns [idx * F / n,
    (idx + 1) * F / n) of each half, whose product meets the matching
    rows of the down projection. At n = 1 the leaf itself."""
    f = leaf.shape[-1] // 2
    if n == 1:
        return leaf
    if f % n:
        raise ValueError(f"gated width {f} over {n} ranks")
    w = f // n
    return torch.cat([leaf[..., idx * w:(idx + 1) * w],
                      leaf[..., f + idx * w:f + (idx + 1) * w]], -1)


def serving_blocks(tree, spec_tree, mesh, act: str, coord=None,
                   copy: bool = True):
    """The rank at ``coord`` (default: this rank of ``mesh``)'s blocks
    of a cell's params ``tree`` (a train tree; a serving or a train
    cell's) under
    ``spec_tree`` (``launch/sharding.distribute_tree``'s), each gated
    leaf's block as ``gated_block`` cuts it."""
    from ..launch.sharding import _axes, distribute_tree, local_slice
    from ..train.tree import leaves, tree_map_with_path

    if coord is None:
        from ..launch.mesh import coordinate
        coord = coordinate(mesh)
    flat = dict(leaves(spec_tree))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def block(path, leaf):
        spec = flat[path]
        last = _axes(spec[-1]) if len(spec) else ()
        if not gated_leaf(path, act) or not last:
            return distribute_tree(leaf, spec, mesh, coord, copy)
        idx, n = 0, 1
        for a in last:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        lead = local_slice(tuple(leaf.shape), spec, mesh, coord)[:-1]
        out = gated_block(leaf[lead], idx, n)
        return out.clone(memory_format=torch.contiguous_format) if copy \
            else out

    return tree_map_with_path(block, tree)
