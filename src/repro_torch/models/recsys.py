"""RecSys model family, serving (PyTorch): FM, DLRM, Wide&Deep, BERT4Rec.

All four share the sparse substrate: huge embedding tables plus
kernels/embedding_bag (gather + weighted segment reduce), which DLRM
calls once a sparse field. The ``retrieval_cand`` serving shape (1 query
x 1e6 candidates) is scored by the same fused top-k kernel as the
LiveVectorLake hot tier (``score_candidates`` -> kernels/topk_search).

Parameters are the ``ParamModule``s of models/transformer.py (frozen,
indexed by name like repro's dict pytrees); an MLP is an ``MLP`` module
whose weights stay (d_in, d_out) as in repro (``x @ w + b``). Init
functions take a seed and a device (None = the card) and make every
table in place on it: ``normal_`` into the allocated table, then an
in-place scale, so a 12.8 GB table needs no scaled temporary. JAX's PRNG
cannot be reproduced: to compute repro's function, carry its params
across with ``models/bridge.recsys_params_from_repro``.

``lookup`` (FM, Wide&Deep) matches repro's ``jnp.take``: an id in
[-V, -1] wraps to id + V, and any id still outside [0, V) gives a NaN
row, on the CPU and on the card alike, with no host sync. DLRM's bags
follow repro exactly (kernels/embedding_bag: NaN for an id >= V).

Not ported yet (ROADMAP Queue 1 item 12): the losses (``bce_loss``,
``*_loss``) and training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..kernels.common import resolve_device
from ..kernels.embedding_bag.ops import embedding_bag
from ..kernels.topk_search.ops import topk_search
from .layers import dense_init
from .transformer import (ParamModule, TransformerConfig, forward,
                          forward_pooled, logits_fn)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
class MLP(ParamModule):
    """Dense layers ``x @ w{i} + b{i}``, ReLU after every layer but the
    last (and after the last too with ``final_act``)."""

    def __init__(self, tensors: dict):
        super().__init__(tensors)
        self.n = len(tensors) // 2

    def forward(self, x: torch.Tensor, final_act: bool = False
                ) -> torch.Tensor:
        for i in range(self.n):
            x = x @ self[f"w{i}"] + self[f"b{i}"]
            if i < self.n - 1 or final_act:
                x = torch.relu(x)
        return x


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
    outside [0, V) gives a row of NaN. The gather reads clamped ids and
    the NaN rows are written after it, so no id is checked on the host."""
    v = table.shape[0]
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + v, flat)
    bad = (flat < 0) | (flat >= v)
    rows = torch.index_select(table, 0, flat.clamp(0, v - 1))
    rows = rows.masked_fill(bad.reshape(-1, *[1] * (table.dim() - 1)),
                            float("nan"))
    return rows.reshape(*ids.shape, *table.shape[1:])


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def _generator(seed: int, device) -> tuple[torch.Generator, torch.device]:
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(seed), device


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


def fm_forward(params, cfg: FMConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids: (B, F) global ids (field f offset f*vocab). The O(nk)
    sum-square trick: pairwise = 0.5 * ((sum v)^2 - sum v^2)."""
    linear = lookup(params["w"], ids).sum(-1)                 # (B,)
    v = lookup(params["v"], ids)                              # (B, F, k)
    sum_v = v.sum(1)
    pairwise = 0.5 * (sum_v.square() - v.square().sum(1)).sum(-1)
    return params["w0"] + linear + pairwise


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
                 bag: Callable = embedding_bag) -> torch.Tensor:
    """dense: (B, 13); sparse_ids: (B, 26, L) multi-hot (L = 1 one-hot);
    weights: (B, 26, L) or None. One ``bag`` call a field (the kernel's
    wrapper; a check may pass its plain version). Returns (B,) logits."""
    x_bot = params["bot"](dense.to(cfg.dtype), final_act=True)  # (B, 128)
    embs = [bag(params["tables"][f"table_{i}"], sparse_ids[:, i],
                None if weights is None else weights[:, i], "sum")
            for i in range(cfg.n_sparse)]
    feats = torch.stack([x_bot] + embs, dim=1)                   # (B, 27, k)
    # dot interaction: upper triangle of pairwise dots, row-major (the
    # order of jnp.triu_indices)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    n_f = feats.shape[1]
    iu, ju = torch.triu_indices(n_f, n_f, offset=1, device=feats.device)
    top_in = torch.cat([x_bot, inter[:, iu, ju]], dim=-1)       # (B, 479)
    return params["top"](top_in)[:, 0]


def dlrm_user_embedding(params, cfg: DLRMConfig, dense: torch.Tensor,
                        sparse_ids: torch.Tensor) -> torch.Tensor:
    return _unit(params["bot"](dense.to(cfg.dtype), final_act=True))


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


def widedeep_forward(params, cfg: WideDeepConfig, ids: torch.Tensor
                     ) -> torch.Tensor:
    """ids: (B, F) global ids. wide linear + deep MLP over concat embeds."""
    wide = lookup(params["wide_w"], ids).sum(-1) + params["wide_b"]
    emb = lookup(params["embed"], ids)                        # (B, F, k)
    deep = params["deep"](emb.reshape(ids.shape[0], -1))[:, 0]
    return wide + deep


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
        act="gelu", causal=False, dtype=dtype)


def bert4rec_forward(params, cfg: TransformerConfig, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """Serve: the item logits of the last position, (B, vocab)."""
    hidden, _ = forward(params, tokens, cfg)
    return logits_fn(params, hidden[:, -1:])[:, 0]


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
