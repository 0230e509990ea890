"""RecSys model family (PyTorch): FM, DLRM, Wide&Deep, BERT4Rec, serving
and training.

All four share the sparse substrate: huge embedding tables plus
kernels/embedding_bag (gather + weighted segment reduce), which DLRM
calls once a forward over its 26 tables. The ``retrieval_cand`` serving
shape (1 query x 1e6 candidates) is scored by the same fused top-k
kernel as the LiveVectorLake hot tier (``score_candidates`` ->
kernels/topk_search).

Parameters are the ``ParamModule``s of models/transformer.py (frozen,
indexed by name like repro's dict pytrees) for serving, or repro's dict
tree of leaf tensors for training (``bridge.train_tree``); an MLP is an
``MLP`` module or a dict of ``w{i}``/``b{i}``, weights (d_in, d_out) as in
repro (``x @ w + b``, ``mlp_apply``). Init
functions take a seed and a device (None = the card) and make every
table in place on it: ``normal_`` into the allocated table, then an
in-place scale, so a 12.8 GB table needs no scaled temporary. JAX's PRNG
cannot be reproduced: to compute repro's function, carry its params
across with ``models/bridge.recsys_params_from_repro``.

``lookup`` (FM, Wide&Deep) matches repro's ``jnp.take``: an id in
[-V, -1] wraps to id + V, and any id still outside [0, V) gives a NaN
row, on the CPU and on the card alike, with no host sync; in the
backward such an id adds to no row, as ``jnp.take``'s VJP. It is plain
PyTorch: repro has no kernel there. DLRM's bags follow repro exactly
(kernels/embedding_bag: NaN for an id >= V, which adds to no row in the
backward kernel).

The losses (``bce_loss``, ``fm_loss``, ``dlrm_loss``, ``widedeep_loss``,
``bert4rec_loss``) are repro's: ``launch/steps`` trains them.

On a mesh (``mesh=``, one rank's blocks under repro's
``recsys_param_specs``): a table the rule row-shards over "model" is
read by ``lookup_rows`` (the rank's rows, zeros for the others, summed
over "model"; the NaN rule on the rank of the last rows), DLRM's bags by
``RowShardedBag``; an MLP weight the rule splits by columns runs
column-parallel in ``mlp_apply`` (the rank's columns and its slice of the
bias, the activation, then an all-gather of the features over "model").
BERT4Rec's transformer runs ``models/transformer``'s tensor parallelism
(a ``TPConfig``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..kernels.common import resolve_device, seeded_generator
from ..kernels.embedding_bag.ops import embedding_bag_grouped
from ..kernels.segment_sum import take
from ..kernels.topk_search.ops import topk_search
from .layers import dense_init
from .transformer import (ParamModule, TransformerConfig, forward,
                          forward_pooled, head_logits, lm_loss)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def mlp_apply(p, x: torch.Tensor, final_act: bool = False,
              mesh=None) -> torch.Tensor:
    """Dense layers ``x @ w{i} + b{i}`` of ``p`` (an ``MLP`` or a dict),
    ReLU after every layer but the last (and after the last too with
    ``final_act``). On a ``mesh``, a weight narrower than its bias (the
    rank's column block, ``P(None, "model")``) takes the rank's slice of
    the (whole) bias, and its output is all-gathered over "model" after
    the activation."""
    n = p.n if isinstance(p, MLP) else len(p) // 2
    for i in range(n):
        w, b = p[f"w{i}"], p[f"b{i}"]
        split = mesh is not None and w.shape[-1] < b.shape[-1]
        if split:
            from ..launch.mesh import coordinate
            lo = coordinate(mesh)["model"] * w.shape[-1]
            b = b[lo:lo + w.shape[-1]]
        x = x @ w + b
        if i < n - 1 or final_act:
            x = torch.relu(x)
        if split:
            from ..launch.collectives import all_gather
            x = all_gather(x, mesh, "model", dim=-1)
    return x


class MLP(ParamModule):
    """``mlp_apply``'s dense layers as a module."""

    def __init__(self, tensors: dict):
        super().__init__(tensors)
        self.n = len(tensors) // 2

    def forward(self, x: torch.Tensor, final_act: bool = False
                ) -> torch.Tensor:
        return mlp_apply(self, x, final_act)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy of logits against 0/1 labels, fp32, in
    the overflow-safe form max(l, 0) - l*y + log1p(exp(-|l|))."""
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def mlp_params(gen: torch.Generator, dims: Sequence[int], dtype,
               device) -> dict:
    """{"w{i}": (dims[i], dims[i+1]), "b{i}": zeros} for an ``MLP``."""
    t = {f"w{i}": dense_init(gen, dims[i], dims[i + 1], dtype, device=device)
         for i in range(len(dims) - 1)}
    t.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype,
                                   device=device)
              for i in range(len(dims) - 1)})
    return t


def table_init(gen: torch.Generator, shape: tuple, scale: float, dtype,
               device) -> torch.Tensor:
    """N(0, 1) * ``scale``, made in place (no temporary of the table's
    size)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    t.normal_(generator=gen)
    return t.mul_(scale)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-id-per-field lookup (multi-hot goes via kernels/embedding_bag).

    As ``jnp.take``: an id in [-V, -1] reads row id + V, and any other id
    outside [0, V) gives a row of NaN. ``kernels/segment_sum.take``: the
    gather reads clamped ids and the NaN rows are written after it, so no
    id is checked on the host, and the gradient adds each id's rows with
    ``gather_segment_sum`` in a fixed order (no atomics: a step repeats
    bit for bit on the card)."""
    return take(table, ids)


def lookup_rows(table: torch.Tensor, ids: torch.Tensor, vocab: int,
                mesh=None) -> torch.Tensor:
    """``lookup`` of a table of ``vocab`` rows of which this rank of
    ``mesh`` holds ``table``: its row block over "model" (the others'
    rows zeros, the sum over "model" the one-card rows bit for bit, NaN
    included: ``models/tp.embed_local``), or the whole table (no mesh,
    or a vocab the axis does not divide)."""
    if mesh is None or table.shape[0] == vocab:
        return lookup(table, ids)
    from ..launch.collectives import all_reduce_sum
    from ..launch.mesh import axis_size, coordinate
    from .tp import embed_local

    return all_reduce_sum(embed_local(table, ids, coordinate(mesh)["model"],
                                      axis_size(mesh, "model"), vocab),
                          mesh, "model")


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def _generator(seed: int, device) -> tuple[torch.Generator, torch.device]:
    device = resolve_device(device)
    return seeded_generator(seed, device), device


# ---------------------------------------------------------------------------
# Factorization Machine  [Rendle, ICDM'10]
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def n_params(self) -> int:
        return 1 + self.total_vocab * (1 + self.embed_dim)


def fm_module(t: dict) -> ParamModule:
    """{"w0": (), "w": (V,), "v": (V, k)} -> the FM's module."""
    return ParamModule({k: t[k] for k in ("w0", "w", "v")})


@torch.no_grad()
def fm_init(cfg: FMConfig, seed: int = 0, device=None) -> ParamModule:
    gen, device = _generator(seed, device)
    return fm_module({
        "w0": torch.zeros((), dtype=cfg.dtype, device=device),
        "w": table_init(gen, (cfg.total_vocab,), 0.01, cfg.dtype, device),
        "v": table_init(gen, (cfg.total_vocab, cfg.embed_dim), 0.01,
                        cfg.dtype, device),
    })


def fm_forward(params, cfg: FMConfig, ids: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """ids: (B, F) global ids (field f offset f*vocab). The O(nk)
    sum-square trick: pairwise = 0.5 * ((sum v)^2 - sum v^2)."""
    v_all = cfg.total_vocab
    linear = lookup_rows(params["w"], ids, v_all, mesh).sum(-1)   # (B,)
    v = lookup_rows(params["v"], ids, v_all, mesh)            # (B, F, k)
    sum_v = v.sum(1)
    pairwise = 0.5 * (sum_v.square() - v.square().sum(1)).sum(-1)
    return params["w0"] + linear + pairwise


def fm_loss(params, cfg: FMConfig, batch: dict, mesh=None) -> torch.Tensor:
    return bce_loss(fm_forward(params, cfg, batch["ids"], mesh),
                    batch["labels"])


def fm_user_embedding(params, cfg: FMConfig, ids: torch.Tensor
                      ) -> torch.Tensor:
    """Retrieval tower: normalized mean of field factors."""
    return _unit(lookup(params["v"], ids).mean(1))


# ---------------------------------------------------------------------------
# DLRM  [arXiv:1906.00091], MLPerf config (Criteo 1TB)
# ---------------------------------------------------------------------------
# MLPerf DLRM benchmark embedding-table row counts (Criteo Terabyte).
MLPERF_TABLE_SIZES = (
    45833188, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457,
    11316796, 40094537, 452104, 12606, 104, 35)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: tuple = (13, 512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    table_sizes: tuple = MLPERF_TABLE_SIZES
    multi_hot: int = 1            # ids per field (bag width)
    dtype: torch.dtype = torch.float32

    @property
    def padded_table_sizes(self) -> tuple:
        """Row counts padded to multiples of 256 (repro shards the tables
        evenly over any <= 256-way model axis); ids stay < the true
        vocab."""
        return tuple(-(-v // 256) * 256 for v in self.table_sizes)

    @property
    def d_interact(self) -> int:
        """Width of the top MLP's input: x_bot plus the upper triangle of
        the (n_sparse + 1)^2 dot products."""
        n_f = self.n_sparse + 1
        return n_f * (n_f - 1) // 2 + self.embed_dim

    def n_params(self) -> int:
        emb = sum(self.table_sizes) * self.embed_dim
        bot = sum(a * b + b for a, b in zip(self.bot_mlp, self.bot_mlp[1:]))
        dims = (self.d_interact,) + self.top_mlp
        top = sum(a * b + b for a, b in zip(dims, dims[1:]))
        return emb + bot + top


def dlrm_module(t: dict) -> ParamModule:
    """{"tables": {"table_i": (V_i, D)}, "bot": {...}, "top": {...}} ->
    the DLRM's module."""
    return ParamModule(tables=ParamModule(t["tables"]), bot=MLP(t["bot"]),
                       top=MLP(t["top"]))


@torch.no_grad()
def dlrm_init(cfg: DLRMConfig, seed: int = 0, device=None) -> ParamModule:
    """Seeded weights at ``cfg``'s widths on ``device``; table i is
    N(0, 1) * V_i^-0.25 over its padded rows, as in repro."""
    gen, device = _generator(seed, device)
    return dlrm_module({
        "bot": mlp_params(gen, cfg.bot_mlp, cfg.dtype, device),
        "top": mlp_params(gen, (cfg.d_interact,) + cfg.top_mlp, cfg.dtype,
                          device),
        "tables": {f"table_{i}": table_init(gen, (v, cfg.embed_dim),
                                            v ** -0.25, cfg.dtype, device)
                   for i, v in enumerate(cfg.padded_table_sizes)},
    })


def dlrm_forward(params, cfg: DLRMConfig, dense: torch.Tensor,
                 sparse_ids: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 bag: Callable = embedding_bag_grouped,
                 mesh=None) -> torch.Tensor:
    """dense: (B, 13); sparse_ids: (B, 26, L) multi-hot (L = 1 one-hot);
    weights: (B, 26, L) or None. One ``bag`` call over the 26 tables
    (the kernel's grouped wrapper; a check may pass its plain version;
    ``RowShardedBag`` on a mesh) writes the bags into the feature stack
    after x_bot, with no copy of the ids or the features; ``mesh`` runs
    the MLPs' column blocks (``mlp_apply``). Returns (B,) logits."""
    x_bot = mlp_apply(params["bot"], dense.to(cfg.dtype),
                      final_act=True, mesh=mesh)                # (B, 128)
    feats = x_bot.new_empty((x_bot.shape[0], cfg.n_sparse + 1,
                             cfg.embed_dim))                     # (B, 27, k)
    feats[:, 0] = x_bot
    tables = params["tables"]
    bag([tables[f"table_{i}"] for i in range(cfg.n_sparse)], sparse_ids,
        weights, "sum", out=feats[:, 1:])
    # dot interaction: upper triangle of pairwise dots, row-major (the
    # order of jnp.triu_indices)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    n_f = feats.shape[1]
    iu, ju = torch.triu_indices(n_f, n_f, offset=1, device=feats.device)
    top_in = torch.cat([x_bot, inter[:, iu, ju]], dim=-1)       # (B, 479)
    return mlp_apply(params["top"], top_in, mesh=mesh)[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, batch: dict,
              bag: Callable = embedding_bag_grouped,
              mesh=None) -> torch.Tensor:
    logits = dlrm_forward(params, cfg, batch["dense"], batch["sparse_ids"],
                          batch.get("weights"), bag=bag, mesh=mesh)
    return bce_loss(logits, batch["labels"])


def dlrm_user_embedding(params, cfg: DLRMConfig, dense: torch.Tensor,
                        sparse_ids: torch.Tensor) -> torch.Tensor:
    return _unit(mlp_apply(params["bot"], dense.to(cfg.dtype),
                           final_act=True))


# ---------------------------------------------------------------------------
# DLRM with row-sharded tables (recsys_param_specs over a mesh's "model")
# ---------------------------------------------------------------------------
def dlrm_table_rows(cfg: DLRMConfig, mesh, shard: int) -> list:
    """[lo, hi) of each table's padded rows that model index ``shard`` of
    ``mesh`` holds: the rows ``launch/sharding.recsys_param_specs``
    gives it (tables of >= 4096 rows split evenly over "model"; the
    padded sizes are multiples of 256), the whole table for the others
    (replicated)."""
    from ..configs.base import Spec
    from ..launch.sharding import local_slice, recsys_param_specs

    shapes = {f"table_{i}": Spec((v, cfg.embed_dim), cfg.dtype)
              for i, v in enumerate(cfg.padded_table_sizes)}
    specs = recsys_param_specs({"tables": shapes}, mesh)["tables"]
    coord = {a: 0 for a in mesh.mesh_dim_names}
    coord["model"] = shard
    rows = []
    for i in range(cfg.n_sparse):
        name = f"table_{i}"
        sl = local_slice(shapes[name].shape, specs[name], mesh, coord)[0]
        rows.append((sl.start, sl.stop))
    return rows


class RowShardedBag:
    """DLRM's ``bag`` on one rank of a mesh whose "model" axis row-shards
    the tables: the rank holds rows [lo, hi) of each row-sharded table
    (``dlrm_table_rows``) and the small tables whole. ``local`` maps each
    id into the rank's rows (another rank's id becomes padding, -1; an id
    at or past the padded size stays out of range on the last model rank
    alone, so its bag is NaN exactly where one card makes it NaN) and runs
    ONE ``embedding_bag_grouped`` launch over the rank's blocks;
    ``__call__`` then sums the row-sharded fields over "model" (the
    replicated fields are whole on every rank). At L = 1 each sharded
    bag is one rank's row plus zeros: the sum is the one-card bag bit for
    bit, NaN included. The tables' gradient reaches each rank's own rows
    only, through ``embedding_bag_grouped_bwd`` on the local ids."""

    def __init__(self, cfg: DLRMConfig, mesh, shard: Optional[int] = None):
        from ..launch.mesh import axis_size, coordinate

        self.mesh = mesh
        if shard is None:
            shard = coordinate(mesh)["model"]
        self.rows = dlrm_table_rows(cfg, mesh, shard)
        last = shard == axis_size(mesh, "model") - 1
        full = cfg.padded_table_sizes
        self.sharded = [i for i, (lo, hi) in enumerate(self.rows)
                        if hi - lo < full[i]]
        big = torch.iinfo(torch.int64).max
        self._bounds = ([lo for lo, _ in self.rows],
                        [big if (last or hi == full[i]) else hi
                         for i, (_, hi) in enumerate(self.rows)],
                        self.sharded)
        self._on = {}                # device -> the bounds as tensors there

    def _tensors(self, device: torch.device) -> tuple:
        """(lo, hi, sharded fields) on ``device``, copied there once."""
        if device not in self._on:
            lo, hi, sh = (torch.tensor(x, device=device)
                          for x in self._bounds)
            self._on[device] = (lo[None, :, None], hi[None, :, None], sh)
        return self._on[device]

    def local_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, F, L) as indices into this rank's blocks (int32)."""
        lo, hi, _ = self._tensors(ids.device)
        ids = ids.long()
        return torch.where((ids >= lo) & (ids < hi), ids - lo,
                           -1).to(torch.int32)

    def local(self, tables, ids, weights=None, combiner: str = "sum",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This rank's bags: one grouped launch over its blocks."""
        return embedding_bag_grouped(tables, self.local_ids(ids), weights,
                                     combiner, out=out)

    def __call__(self, tables, ids, weights=None, combiner: str = "sum",
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..launch.collectives import all_reduce_sum

        res = self.local(tables, ids, weights, combiner, out)
        if self.sharded:
            idx = self._tensors(res.device)[2]
            res.index_copy_(1, idx, all_reduce_sum(
                res.index_select(1, idx), self.mesh, "model"))
        return res


def _table_seed(seed: int, table: int, shard: int) -> int:
    return seed + 1 + 1009 * (64 * table + shard)


@torch.no_grad()
def dlrm_shard_init(cfg: DLRMConfig, mesh, shard: int, seed: int = 0,
                    device=None) -> dict:
    """Model index ``shard``'s DLRM params on ``mesh`` as a train tree:
    the MLPs as ``dlrm_init`` makes them, and rows [lo, hi) of each
    row-sharded table (the small tables whole), N(0, 1) * V^-0.25 over
    the padded V, each from a generator of its own (seed, table, shard)
    (a replicated table's of shard 0): no rank's rows need another's, so
    one card can make the shards of 91.1 GB of tables one at a time."""
    gen, device = _generator(seed, device)
    params = {"bot": mlp_params(gen, cfg.bot_mlp, cfg.dtype, device),
              "top": mlp_params(gen, (cfg.d_interact,) + cfg.top_mlp,
                                cfg.dtype, device), "tables": {}}
    rows = dlrm_table_rows(cfg, mesh, shard)
    for i, (v, (lo, hi)) in enumerate(zip(cfg.padded_table_sizes, rows)):
        tgen, _ = _generator(_table_seed(seed, i, shard if hi - lo < v
                                         else 0), device)
        params["tables"][f"table_{i}"] = table_init(
            tgen, (hi - lo, cfg.embed_dim), v ** -0.25, cfg.dtype, device)
    return params


# ---------------------------------------------------------------------------
# Wide & Deep  [arXiv:1606.07792]
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    mlp: tuple = (1024, 512, 256)
    vocab_per_field: int = 1_000_000
    dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def n_params(self) -> int:
        deep_in = self.n_sparse * self.embed_dim
        dims = (deep_in,) + self.mlp + (1,)
        deep = sum(a * b + b for a, b in zip(dims, dims[1:]))
        return self.total_vocab * (1 + self.embed_dim) + deep


def widedeep_module(t: dict) -> ParamModule:
    """{"wide_w": (V,), "wide_b": (), "embed": (V, k), "deep": {...}} ->
    the Wide&Deep's module."""
    return ParamModule({k: t[k] for k in ("wide_w", "wide_b", "embed")},
                       deep=MLP(t["deep"]))


@torch.no_grad()
def widedeep_init(cfg: WideDeepConfig, seed: int = 0,
                  device=None) -> ParamModule:
    gen, device = _generator(seed, device)
    deep_in = cfg.n_sparse * cfg.embed_dim
    return widedeep_module({
        "wide_w": table_init(gen, (cfg.total_vocab,), 0.01, cfg.dtype,
                             device),
        "wide_b": torch.zeros((), dtype=cfg.dtype, device=device),
        "embed": table_init(gen, (cfg.total_vocab, cfg.embed_dim), 0.01,
                            cfg.dtype, device),
        "deep": mlp_params(gen, (deep_in,) + cfg.mlp + (1,), cfg.dtype,
                           device),
    })


def widedeep_forward(params, cfg: WideDeepConfig, ids: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """ids: (B, F) global ids. wide linear + deep MLP over concat embeds."""
    v_all = cfg.total_vocab
    wide = lookup_rows(params["wide_w"], ids, v_all, mesh).sum(-1) + \
        params["wide_b"]
    emb = lookup_rows(params["embed"], ids, v_all, mesh)      # (B, F, k)
    deep = mlp_apply(params["deep"], emb.reshape(ids.shape[0], -1),
                     mesh=mesh)[:, 0]
    return wide + deep


def widedeep_loss(params, cfg: WideDeepConfig, batch: dict,
                  mesh=None) -> torch.Tensor:
    return bce_loss(widedeep_forward(params, cfg, batch["ids"], mesh),
                    batch["labels"])


def widedeep_user_embedding(params, cfg: WideDeepConfig, ids: torch.Tensor
                            ) -> torch.Tensor:
    return _unit(lookup(params["embed"], ids).mean(1))


# ---------------------------------------------------------------------------
# BERT4Rec  [arXiv:1904.06690]
# ---------------------------------------------------------------------------
def bert4rec_config(n_items: int = 30_000, dtype=torch.float32,
                    name: str = "bert4rec") -> TransformerConfig:
    """Bidirectional sequential recommender = encoder transformer over the
    item vocabulary. vocab = n_items + PAD + MASK, padded to a multiple
    of 512 as in repro."""
    vocab = -(-(n_items + 2) // 512) * 512
    return TransformerConfig(
        name=name, vocab=vocab,
        d_model=64, n_layers=2, n_heads=2, n_kv=2, d_head=32, d_ff=256,
        act="gelu", causal=False, dtype=dtype, remat=False)


def bert4rec_forward(params, cfg: TransformerConfig, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """Serve: the item logits of the last position, (B, vocab)."""
    hidden, _ = forward(params, tokens, cfg)
    return head_logits(params, hidden[:, -1:], cfg)[:, 0]


def bert4rec_loss(params, cfg: TransformerConfig, batch: dict
                  ) -> torch.Tensor:
    """Cloze loss: batch {tokens (B, S) with MASK ids, labels (B, S) = the
    item id at masked positions, -1 elsewhere}."""
    hidden, _ = forward(params, batch["tokens"], cfg)
    return lm_loss(params, hidden, batch["labels"], cfg)


def bert4rec_user_embedding(params, cfg: TransformerConfig,
                            tokens: torch.Tensor) -> torch.Tensor:
    return forward_pooled(params, tokens, cfg)


# ---------------------------------------------------------------------------
# retrieval scoring (shared): 1 query x N candidates, the LiveVectorLake
# hot-tier kernel applied to recsys retrieval
# ---------------------------------------------------------------------------
def score_candidates(user_vec: torch.Tensor, cand_table: torch.Tensor,
                     k: int = 100, n_blocks: int = 512,
                     mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """user_vec: (B, d); cand_table: (N, d). Returns the masked top-k
    (scores (B, k), ids (B, k)), descending, lower id first on ties.

    repro splits this in two branches: ``topk_search`` when
    ``n_blocks <= 1 or n < n_blocks * k``, else a two-stage
    ``lax.top_k`` over ``n_blocks`` row blocks that exists only so that
    GSPMD keeps stage 1 shard-local. On one card both compute the same
    top-k, so every call goes to the ported ``topk_search``; ``n_blocks``
    stays in the signature for callers of either."""
    n = cand_table.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=cand_table.device)
    return topk_search(user_vec.float(), cand_table.float(), mask, k)
