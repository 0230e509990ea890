"""Decoder/encoder transformer family (PyTorch): serving and training.

One parametric implementation covers the five LM architectures (dense
GQA: Mistral-NeMo, Nemotron-4, Qwen1.5; MoE: Kimi-K2, Qwen2-MoE), the
MiniLM-class embedder (``causal=False``, mean-pooled) and BERT4Rec's
bidirectional backbone. The functions below take the params with the
config, as repro's take its param pytree, in either of two forms:

  - serving: ``ParamModule``s holding frozen parameters, each layer its
    own module in a ``ModuleList`` (``init_params``; models/bridge.py
    carries repro's tree across);
  - training: repro's own layout, a dict of leaf tensors with every
    layer's params stacked on a leading (L, ...) axis (``stack_layers``),
    so that the optimizer, the gradient compression and the checkpoint
    see repro's leaves. ``forward`` takes per-layer views of the stacks
    with one ``unbind(0)`` a leaf (indexing each layer instead would make
    autograd build a zero gradient of the whole stack for every layer).

The loop over layers is a Python loop in both; ``cfg.remat`` wraps each
layer in ``torch.utils.checkpoint`` (non-reentrant) when autograd records,
so the backward recomputes the layer's forward, its attention kernel
included. Attention goes through kernels/flash_attention (encoder,
prefill, training; its backward is a kernel too) and
kernels/flash_decode (decode): the hand-written kernels for CUDA tensors,
their plain versions for CPU tensors. The KV cache is allocated once at
``cache_size`` by ``prefill`` and written in place by ``decode_step``
(repro's functions return a new cache each step). MoE layers run
models/moe.py's ``moe_block``: the capacity path in ``forward`` and
``prefill``, the dropless path in ``decode_step``, as in repro. With
``moe_mesh`` set (``launch/steps.build_cell(..., mesh=)``), each rank's
MoE layers run ``moe_block_sharded`` on its tokens and its experts
(``_moe_dispatch``). With a ``TPConfig`` (any cell on a mesh),
``forward``, ``prefill`` and ``decode_step`` run one rank of Megatron
tensor parallelism over "model" on the rank's blocks (``models/tp``'s
bodies, each collective a ``launch/collectives`` call): the embedding
summed, the attention's and the MLP's row-parallel partials summed; the
logits gathered to serve, and a train cell's loss vocab-parallel
(``lm_loss``: never gathered); the decode cache split by kv heads or by
sequence (``tp_seq_axes``), the latter merged across ranks by
``flash_decode_sharded``. Under ``cfg.remat`` a layer's recompute in the
backward replays its collectives, in the same order on every rank.

Not ported: repro's ``unroll_layers`` (XLA cost-analysis probes) and
``attn_impl`` (its choice among JAX attention paths) options, which have
no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.common import resolve_device, seeded_generator
from ..kernels.flash_decode.ops import flash_decode, flash_decode_sharded
from . import tp
from .layers import (AttentionConfig, attention_block, attention_impl,
                     attention_params, attention_qkv, dense_init,
                     cross_entropy_loss, embed_init, mlp_block, mlp_params,
                     rmsnorm)
from .moe import (MoEConfig, moe_block, moe_block_sharded, moe_block_tp,
                  moe_params, sharded_moe_applicable)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    act: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    moe: Optional[MoEConfig] = None
    remat: bool = True                  # recompute each layer in backward
    dtype: torch.dtype = torch.float32  # parameter / activation dtype
    # the mesh of the expert-parallel MoE path (launch/steps.build_cell
    # sets it on each rank; None = moe_block on one card)
    moe_mesh: Any = None

    @property
    def attn(self) -> AttentionConfig:
        return AttentionConfig(self.d_model, self.n_heads, self.n_kv,
                               self.d_head, self.qkv_bias, self.rope_theta,
                               self.causal)

    def n_params(self) -> int:
        """Total parameter count (for roofline MODEL_FLOPS)."""
        d, dh = self.d_model, self.d_head
        attn = d * dh * (self.n_heads + 2 * self.n_kv) + self.n_heads * dh * d
        gated = self.act in ("swiglu", "geglu")
        if self.moe:
            f = self.moe.d_ff
            ffn = self.moe.n_experts * (d * f * (2 if gated else 1) + f * d)
            ffn += d * self.moe.n_experts          # router
            if self.moe.n_shared:
                fs = self.moe.n_shared * f
                ffn += d * fs * (2 if gated else 1) + fs * d
        else:
            ffn = d * self.d_ff * (2 if gated else 1) + self.d_ff * d
        per_layer = attn + ffn + 2 * d
        return (self.n_layers * per_layer + 2 * self.vocab * d + d)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        gated = 2 if self.act in ("swiglu", "geglu") else 1
        f = self.moe.d_ff
        per_tok_ffn = self.moe.top_k * (d * f * gated + f * d) \
            + d * self.moe.n_experts
        if self.moe.n_shared:
            fs = self.moe.n_shared * f
            per_tok_ffn += d * fs * gated + fs * d
        dh = self.d_head
        attn = d * dh * (self.n_heads + 2 * self.n_kv) + self.n_heads * dh * d
        return self.n_layers * (attn + per_tok_ffn + 2 * d) \
            + 2 * self.vocab * d + d


@dataclasses.dataclass(frozen=True)
class TPConfig(TransformerConfig):
    """A ``TransformerConfig`` on one rank of a cell's mesh
    (``launch/steps.build_cell`` makes it; the arch configs stay repro's
    fields): ``tp_mesh``, the mesh of its tensor parallelism, and ``tp_seq_axes``, the mesh axes that split a
    decode cache's sequence, in order (``launch/sharding.lm_batch_specs``)."""
    tp_mesh: Any = None
    tp_seq_axes: tuple = ()

    @classmethod
    def of(cls, cfg: TransformerConfig, mesh, seq_axes: tuple = ()
           ) -> "TPConfig":
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TransformerConfig)},
                   tp_mesh=mesh, tp_seq_axes=tuple(seq_axes))


    def base(self) -> TransformerConfig:
        """The arch's config: without the meshes."""
        return TransformerConfig(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(TransformerConfig)
            if f.name != "moe_mesh"})


def _tp_mesh(cfg):
    return getattr(cfg, "tp_mesh", None)


class ParamModule(nn.Module):
    """Named tensors as frozen parameters, plus named submodules, read as
    ``p["name"]`` like repro's dict pytrees. Serving only: the train path
    takes plain dicts of leaf tensors (``stack_layers``)."""

    def __init__(self, tensors: Optional[dict] = None, **modules):
        super().__init__()
        for name, t in (tensors or {}).items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))
        for name, m in modules.items():
            self.add_module(name, m)

    def __getitem__(self, name: str):
        return getattr(self, name)


def layer_module(tensors: dict) -> ParamModule:
    """One layer from {"ln1", "ln2", "attn": {...}, and "mlp": {...} or
    "moe": {...}}."""
    ffn = "moe" if "moe" in tensors else "mlp"
    return ParamModule({"ln1": tensors["ln1"], "ln2": tensors["ln2"]},
                       attn=ParamModule(tensors["attn"]),
                       **{ffn: ParamModule(tensors[ffn])})


def model_module(embed: torch.Tensor, layers: list, final_ln: torch.Tensor,
                 lm_head: torch.Tensor) -> ParamModule:
    return ParamModule({"embed": embed, "final_ln": final_ln,
                        "lm_head": lm_head},
                       layers=nn.ModuleList(layers))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_params(gen: torch.Generator, cfg: TransformerConfig,
                  device) -> dict:
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
        "attn": attention_params(gen, cfg.attn, cfg.dtype, device),
    }
    if cfg.moe:
        p["moe"] = moe_params(gen, cfg.d_model, cfg.moe, cfg.dtype, device)
    else:
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act,
                              cfg.dtype, device)
    return p


@torch.no_grad()
def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> ParamModule:
    """Seeded random weights at ``cfg``'s widths, made on ``device`` (None
    = the card) from one ``torch.Generator`` there. JAX's PRNG cannot be
    reproduced: to compute repro's function, carry its params across with
    models/bridge.py."""
    device = resolve_device(device)
    gen = seeded_generator(seed, device)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype, device)
    layers = [layer_module(_layer_params(gen, cfg, device))
              for _ in range(cfg.n_layers)]
    lm_head = dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype,
                         device=device)
    return model_module(embed, layers,
                        torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                   device=device), lm_head)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _moe_dispatch(lp, h, cfg: TransformerConfig, dropless: bool = False):
    """repro's choice of MoE path: ``moe_block_sharded`` where
    ``cfg.moe_mesh`` allows it, else ``moe_block``. h is this rank's
    tokens: ``build_cell`` split the global batch and checked it against
    the mesh before it set ``moe_mesh``."""
    if sharded_moe_applicable(cfg.moe, cfg.moe_mesh, cfg.d_model):
        return moe_block_sharded(lp["moe"], h, cfg.moe, cfg.moe_mesh,
                                 dropless=dropless)
    if _tp_mesh(cfg) is not None:    # a serving cell whose batch is not split
        return moe_block_tp(lp["moe"], h, cfg.moe, cfg.tp_mesh,
                            dropless=dropless)
    return moe_block(lp["moe"], h, cfg.moe, dropless=dropless)


def _ffn(lp, h, cfg: TransformerConfig, dropless: bool = False):
    """The layer's feed-forward block of h: (out, aux_loss)."""
    if cfg.moe:
        return _moe_dispatch(lp, h, cfg, dropless=dropless)
    if _tp_mesh(cfg) is not None:
        from ..launch.collectives import all_reduce_sum
        out = all_reduce_sum(tp.mlp_local(lp["mlp"], h, cfg.act),
                             cfg.tp_mesh, "model")
    else:
        out = mlp_block(lp["mlp"], h, cfg.act)
    return out, torch.zeros((), dtype=torch.float32, device=h.device)


def _layer_fn(lp, x, cfg: TransformerConfig, positions):
    x = x + attention_block(lp["attn"], rmsnorm(x, lp["ln1"]), cfg.attn,
                            positions=positions)
    f, aux = _ffn(lp, rmsnorm(x, lp["ln2"]), cfg)
    return x + f, aux


def layer_list(layers) -> list:
    """The layers' params one by one: a ``ModuleList`` as it is; a
    stacked dict (repro's layout) as per-layer dicts of views, one
    ``unbind(0)`` a leaf."""
    if not isinstance(layers, dict):
        return layers

    def unbind(node):
        if isinstance(node, dict):
            return {k: unbind(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    views = unbind(layers)
    n = len(layers["ln1"])
    return [pick(views, i) for i in range(n)]


def stack_layers(params) -> dict:
    """A serving tree (``init_params``, ``params_from_repro``) as repro's
    layout: a dict of new leaf tensors, every layer's params stacked on a
    leading axis. The copy is the caller's to keep; the modules can go."""
    layers = list(params["layers"])

    def group(mods, sub=None):
        first = mods[0] if sub is None else mods[0][sub]
        out = {}
        for name, _ in first.named_parameters(recurse=False):
            out[name] = torch.stack([(m if sub is None else m[sub])[name]
                                     .detach() for m in mods])
        return out

    ffn = "moe" if hasattr(layers[0], "moe") else "mlp"
    stacked = group(layers)                   # ln1, ln2
    stacked["attn"] = group(layers, "attn")
    stacked[ffn] = group(layers, ffn)
    return {"embed": params["embed"].detach().clone(),
            "final_ln": params["final_ln"].detach().clone(),
            "lm_head": params["lm_head"].detach().clone(),
            "layers": stacked}


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (hidden (B, S, D), aux_loss). aux_loss sums
    the MoE layers' load-balance losses (0 for a dense model). With
    ``cfg.remat`` and autograd recording, each layer is checkpointed. On
    a ``TPConfig``'s mesh, this rank's forward (``_forward_tp``)."""
    if _tp_mesh(cfg) is not None:
        return _forward_tp(params, tokens, cfg, positions)
    x = params["embed"][tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list(params["layers"]):
        if remat:
            x, aux = checkpoint(_layer_fn, lp, x, cfg, positions,
                                use_reentrant=False)
        else:
            x, aux = _layer_fn(lp, x, cfg, positions)
        aux_total = aux_total + aux
    return rmsnorm(x, params["final_ln"]), aux_total


def logits_fn(params, hidden: torch.Tensor) -> torch.Tensor:
    return torch.matmul(hidden, params["lm_head"])


def head_logits(params, hidden: torch.Tensor, cfg: TransformerConfig
                ) -> torch.Tensor:
    """The head's logits of ``hidden``: on a ``TPConfig``'s mesh the
    rank's vocab columns gathered over "model"."""
    if _tp_mesh(cfg) is not None:
        return _Rank(cfg).logits(params, hidden, cfg)
    return logits_fn(params, hidden)


def lm_loss(params, hidden: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """``cross_entropy_loss`` of the head's logits of ``hidden`` against
    ``labels`` (-1 ignored). The logits come out of the head in the
    model's dtype (bf16 for the LM archs, as repro's bf16 einsum rounds
    them) before the fp32 loss. On a ``TPConfig``'s mesh whose "model"
    axis splits ``lm_head``'s vocab, the rank's columns go into
    ``tp.vocab_parallel_cross_entropy`` (a max and two sums over
    "model"); a whole head is the one-card loss, bit for bit."""
    if _tp_mesh(cfg) is None or params["lm_head"].shape[-1] == cfg.vocab:
        return cross_entropy_loss(logits_fn(params, hidden), labels)
    from ..launch.collectives import all_reduce_max
    rank = _Rank(cfg)
    local = tp.logits_local(hidden, params["lm_head"])
    lo = rank.m * local.shape[-1]
    return tp.vocab_parallel_cross_entropy(
        local, labels, lo, rank.sum,
        lambda t: all_reduce_max(t, rank.mesh, "model"))


def loss_fn(params, batch: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored, ``lm_loss``) plus the MoE aux
    loss."""
    hidden, aux = forward(params, batch["tokens"], cfg)
    return lm_loss(params, hidden, batch["labels"], cfg) + aux


def forward_pooled(params, tokens: torch.Tensor, cfg: TransformerConfig,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-pooled L2-normalized sequence embedding (embedder path). PAD
    positions are attended to by the encoder (no key mask, as in repro)
    and left out only of the mean."""
    hidden, _ = forward(params, tokens, cfg)
    if mask is None:
        mask = (tokens > 0).to(hidden.dtype)
    pooled = (hidden * mask[..., None]).sum(1) / \
        torch.clamp(mask.sum(1)[..., None], min=1.0)
    norm = torch.linalg.vector_norm(pooled.float(), dim=-1, keepdim=True)
    return (pooled.float() / torch.clamp(norm, min=1e-9)).to(hidden.dtype)


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------
def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache_size: int) -> tuple[torch.Tensor, dict, int]:
    """Process the full prompt; return (last-position logits (B, V),
    cache {k, v: (L, B, KV, cache_size, Dh)}, cache_len). The cache holds
    the prompt's keys and values in [0, S) and zeros after."""
    b, s = tokens.shape
    if s > cache_size:
        raise ValueError(f"prefill: {s} tokens exceed cache_size "
                         f"{cache_size}")
    if _tp_mesh(cfg) is not None:
        return _prefill_tp(params, tokens, cfg, cache_size)
    x = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    shape = (cfg.n_layers, b, cfg.n_kv, cache_size, cfg.d_head)
    ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(layer_list(params["layers"])):
        q, k, v = attention_qkv(lp["attn"], rmsnorm(x, lp["ln1"]), cfg.attn,
                                positions)
        ck[i, :, :, :s] = k
        cv[i, :, :, :s] = v
        o = attention_impl(q, k, v, cfg.causal)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
        x = x + torch.matmul(o, lp["attn"]["wo"])
        x = x + _ffn(lp, rmsnorm(x, lp["ln2"]), cfg)[0]
    hidden = rmsnorm(x[:, -1:], params["final_ln"])
    return logits_fn(params, hidden)[:, 0], {"k": ck, "v": cv}, s


def decode_step(params, tokens: torch.Tensor, cache: dict, cache_len: int,
                cfg: TransformerConfig) -> tuple[torch.Tensor, dict, int]:
    """One-token decode. tokens (B, 1); cache k/v (L, B, KV, S, Dh);
    cache_len = number of valid entries. Writes the new token's keys and
    values at ``cache_len`` IN PLACE and returns (logits (B, V), the same
    cache, cache_len + 1). MoE layers route dropless: exact routing for
    serving (t is tiny at decode)."""
    cache_len = int(cache_len)
    if _tp_mesh(cfg) is not None:
        return _decode_tp(params, tokens, cache, cache_len, cfg)
    size = cache["k"].shape[3]
    if not 0 <= cache_len < size:
        raise ValueError(f"decode_step: cache_len {cache_len} outside the "
                         f"cache's {size} entries")
    b = tokens.shape[0]
    x = params["embed"][tokens]                                # (B, 1, D)
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(layer_list(params["layers"])):
        q, k_new, v_new = attention_qkv(lp["attn"], rmsnorm(x, lp["ln1"]),
                                        cfg.attn, positions)
        ck, cv = cache["k"][i], cache["v"][i]                  # views
        ck[:, :, cache_len:cache_len + 1] = k_new
        cv[:, :, cache_len:cache_len + 1] = v_new
        o = flash_decode(q[:, :, 0], ck, cv, cache_len=cache_len + 1)
        o = o.reshape(b, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
        x = x + torch.matmul(o, lp["attn"]["wo"])
        x = x + _ffn(lp, rmsnorm(x, lp["ln2"]), cfg, dropless=True)[0]
    hidden = rmsnorm(x, params["final_ln"])
    return logits_fn(params, hidden)[:, 0], cache, cache_len + 1


# ---------------------------------------------------------------------------
# serving on a mesh: one rank of tensor parallelism (models/tp)
# ---------------------------------------------------------------------------
class _Rank:
    """This rank's place on ``cfg.tp_mesh``: its model index and count,
    and its block of a decode cache's sequence (``cfg.tp_seq_axes``)."""

    def __init__(self, cfg: TransformerConfig):
        from ..launch.mesh import coordinate

        mesh = self.mesh = cfg.tp_mesh
        coord = coordinate(mesh)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.m, self.n = coord["model"], sizes["model"]
        self.axes = tuple(cfg.tp_seq_axes)
        self.block, self.n_blocks = 0, 1
        for a in self.axes:
            self.block = self.block * sizes[a] + coord[a]
            self.n_blocks *= sizes[a]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        from ..launch.collectives import all_reduce_sum
        return all_reduce_sum(t, self.mesh, "model")

    def gather(self, t: torch.Tensor, axes="model", dim: int = -1):
        from ..launch.collectives import all_gather
        return all_gather(t, self.mesh, axes, dim=dim)

    def embed(self, params, tokens, cfg: TransformerConfig):
        return self.sum(tp.embed_local(params["embed"], tokens, self.m,
                                       self.n, cfg.vocab))

    def attention_inputs(self, attn, h, cfg: TransformerConfig,
                         plan: tp.HeadPlan, positions):
        q, k, v = tp.qkv_local(attn, h)
        if plan.gather_q:
            q = self.gather(q)
        if plan.gather_kv:
            k, v = self.gather(k), self.gather(v)
        return tp.attention_heads(q, k, v, plan, cfg, positions)

    def logits(self, params, hidden, cfg: TransformerConfig):
        out = tp.logits_local(hidden, params["lm_head"])
        return self.gather(out) if out.shape[-1] < cfg.vocab else out


def _layer_tp(lp, x, cfg: TransformerConfig, positions, rank: _Rank,
              plan: tp.HeadPlan):
    """``_layer_fn`` on this rank of ``cfg.tp_mesh``: the attention of
    ``plan.heads`` on the rank's projection columns (gathered where the
    plan says), its ``wo`` partial summed over "model", then the
    feed-forward block (its partials summed in ``_ffn``)."""
    b, s, _ = x.shape
    q, k, v = rank.attention_inputs(lp["attn"], rmsnorm(x, lp["ln1"]), cfg,
                                    plan, positions)
    o = attention_impl(q, k, v, cfg.causal)
    o = o.transpose(1, 2).reshape(b, s, -1)
    x = x + rank.sum(tp.attn_out_local(o, lp["attn"]["wo"], plan,
                                       cfg.d_head))
    f, aux = _ffn(lp, rmsnorm(x, lp["ln2"]), cfg)
    return x + f, aux


def _forward_tp(params, tokens: torch.Tensor, cfg: TransformerConfig,
                positions: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward`` on this rank of ``cfg.tp_mesh``: tokens (B, S) the
    rank's data-parallel block, params its blocks; the hidden states
    come out whole (replicated over "model"). Each layer is checkpointed
    as ``forward`` does it."""
    rank = _Rank(cfg)
    x = rank.embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
    layers = layer_list(params["layers"])
    plan = tp.head_plan(cfg, layers[0]["attn"], rank.m, rank.n)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        if remat:
            x, aux = checkpoint(_layer_tp, lp, x, cfg, positions, rank,
                                plan, use_reentrant=False)
        else:
            x, aux = _layer_tp(lp, x, cfg, positions, rank, plan)
        aux_total = aux_total + aux
    return rmsnorm(x, params["final_ln"]), aux_total


def _prefill_tp(params, tokens: torch.Tensor, cfg: TransformerConfig,
                cache_size: int) -> tuple[torch.Tensor, dict, int]:
    """``prefill`` on this rank of ``cfg.tp_mesh``: tokens (B, S) the
    rank's data-parallel block, params its blocks. Returns the logits
    (B, V), gathered over "model", and the cache of the kv heads its
    attention read (``HeadPlan.kv_heads``)."""
    rank = _Rank(cfg)
    b, s = tokens.shape
    x = rank.embed(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    layers = layer_list(params["layers"])
    plan = tp.head_plan(cfg, layers[0]["attn"], rank.m, rank.n)
    kvn = plan.kv_heads[1] - plan.kv_heads[0]
    shape = (cfg.n_layers, b, kvn, cache_size, cfg.d_head)
    ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(layers):
        q, k, v = rank.attention_inputs(lp["attn"], rmsnorm(x, lp["ln1"]),
                                        cfg, plan, positions)
        ck[i, :, :, :s] = k
        cv[i, :, :, :s] = v
        o = attention_impl(q, k, v, cfg.causal)
        o = o.transpose(1, 2).reshape(b, s, -1)
        x = x + rank.sum(tp.attn_out_local(o, lp["attn"]["wo"], plan,
                                           cfg.d_head))
        x = x + _ffn(lp, rmsnorm(x, lp["ln2"]), cfg)[0]
    hidden = rmsnorm(x[:, -1:], params["final_ln"])
    return rank.logits(params, hidden, cfg)[:, 0], {"k": ck, "v": cv}, s


def _decode_tp(params, tokens: torch.Tensor, cache: dict, cache_len: int,
               cfg: TransformerConfig) -> tuple[torch.Tensor, dict, int]:
    """``decode_step`` on this rank of ``cfg.tp_mesh``: tokens (B, 1) and
    the cache k/v (L, B, KV_loc, S_loc, Dh) the rank's blocks
    (``launch/sharding.lm_batch_specs``: kv heads over "model", or the
    sequence over ``cfg.tp_seq_axes``). Only the ranks whose block holds
    position ``cache_len`` write the new token's keys and values; each
    rank attends over its block's valid rows and the partials merge
    across the blocks (``flash_decode_sharded``). Returns the logits (B,
    V), gathered over "model", the same cache, cache_len + 1."""
    rank = _Rank(cfg)
    s_loc = cache["k"].shape[3]
    start = rank.block * s_loc
    if not 0 <= cache_len < s_loc * rank.n_blocks:
        raise ValueError(f"decode_step: cache_len {cache_len} outside the "
                         f"cache's {s_loc * rank.n_blocks} entries")
    b = tokens.shape[0]
    x = rank.embed(params, tokens, cfg)                         # (B, 1, D)
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    layers = layer_list(params["layers"])
    plan = tp.head_plan(cfg, layers[0]["attn"], rank.m, rank.n,
                        cache["k"].shape[2], "model" in rank.axes)
    r0, r1 = (h - plan.kv_heads[0] for h in plan.read_kv)
    at = cache_len - start                  # the new row, in this block

    def gather(t):
        return rank.gather(t, rank.axes, dim=2)

    for i, lp in enumerate(layers):
        q, k_new, v_new = rank.attention_inputs(
            lp["attn"], rmsnorm(x, lp["ln1"]), cfg, plan, positions)
        ck, cv = cache["k"][i], cache["v"][i]                  # views
        if 0 <= at < s_loc:
            ck[:, :, at:at + 1] = k_new
            cv[:, :, at:at + 1] = v_new
        if (r0, r1) != (0, ck.shape[1]):
            ck, cv = ck[:, r0:r1], cv[:, r0:r1]
        o = flash_decode_sharded(q[:, :, 0], ck, cv, cache_len + 1,
                                 rank.block, rank.n_blocks, gather)
        o = o.reshape(b, 1, -1).to(x.dtype)
        x = x + rank.sum(tp.attn_out_local(o, lp["attn"]["wo"], plan,
                                           cfg.d_head))
        x = x + _ffn(lp, rmsnorm(x, lp["ln2"]), cfg, dropless=True)[0]
    hidden = rmsnorm(x, params["final_ln"])
    return rank.logits(params, hidden, cfg)[:, 0], cache, cache_len + 1
