"""Mixture-of-Experts layer: sort-based capacity dispatch + grouped GEMM
(PyTorch), repro's ``models/moe.py``.

Tokens are routed top-k, then DISPATCHED by sorting token-expert
assignments — every shape follows from the input's, so nothing reads a
value back to the host:

  1. router softmax -> top-k (weights, expert ids) per token
  2. flatten (T*k) assignments, argsort by expert id
  3. position-in-expert from the sorted ids; assignments beyond the
     per-expert capacity C are DROPPED (GShard-style, capacity_factor
     bounds the buffer)
  4. scatter into an (E, C, D) buffer -> batched expert GEMM
  5. gather back, weight by router prob, sum over k; plus optional
     always-on shared experts (DeepSeek/Qwen-MoE style)

Load-balance auxiliary loss (Switch): E * sum_e f_e * P_e.

Where the port must choose what repro leaves to XLA, it chooses repro's
CPU answer:
  - top-k is a stable descending sort of the probabilities: equal
    probabilities rank the lower expert id first, as ``lax.top_k`` does
    (``torch.topk`` promises no order for ties on CUDA);
  - the dispatch argsort is stable, as ``jnp.argsort`` is, so the same
    assignments drop;
  - the combine gathers each token's k weighted outputs back to (T, k,
    D) and sums them in ascending expert id, in x's dtype, from zero:
    the order of repro's scatter-add, without atomics (``index_add_`` on
    CUDA would make a token's bf16 output depend on the run).
Every product over the token axis (router, experts, shared experts) runs
in blocks of ``ROWS`` rows, the last one zero padded, so that each block
is a product of one shape whatever the batch: a token's row comes out
with the same bits alone or inside any batch, and in any run (DESIGN.md
§8.3). The router and the shared experts are one batched GEMM over the
blocks (the weight broadcast, not copied); the expert buffer is laid out
block-major, (C / ROWS, E, ROWS, D), so each block is one contiguous
batched GEMM over the experts.

Expert parallelism over a mesh (``moe_block_sharded``): each rank runs
``moe_local``, the same dispatch restricted to its own experts, on its
own tokens; the collectives sit at the block's boundary
(``launch/collectives``): the experts' d_model blocks are all-gathered
over "data", the partial outputs summed over "model", the aux loss
averaged over the data-parallel axes. In a serving cell the shared
experts are column- and row-parallel over "model" too (``models/tp``):
each rank adds its shared partial to its routed one before the sum.
Where the data axes do not divide the batch (long_500k's one sequence),
``moe_block_tp`` runs every rank's experts on the replicated tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import activation, dense_init, pick


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    n_shared: int = 0              # always-on shared experts
    capacity_factor: float = 1.25
    act: str = "swiglu"
    router_aux_weight: float = 0.01


EXPERT_PAD = 16      # pad expert count to the model-axis extent so the
#                      expert dim always shards (qwen2-moe: 60 -> 64;
#                      dead experts are never routed — the router only
#                      emits logits for the REAL experts)

ROWS = 128           # rows of one GEMM block over the token axis


def padded_experts(e: int) -> int:
    return -(-e // EXPERT_PAD) * EXPERT_PAD


def moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig,
               dtype=torch.float32, device=None) -> dict:
    """Seeded weights: the router in fp32, the experts stacked on a
    padded (E_pad, ...) axis in ``dtype``, made expert by expert with no
    fp32 temporary of the stack (Kimi-K2's layer is 33.8 GB in bf16)."""
    e, f = cfg.n_experts, cfg.d_ff
    e_pad = padded_experts(e)
    gated = cfg.act in ("swiglu", "geglu")
    mult = 2 if gated else 1
    p = {"router": dense_init(gen, d_model, e, torch.float32,
                              device=device)}
    for name, shape, std in (("w_in", (d_model, f * mult), d_model ** -0.5),
                             ("w_out", (f, d_model), f ** -0.5)):
        w = torch.empty((e_pad,) + shape, dtype=dtype, device=device)
        for i in range(e_pad if w.device.type != "meta" else 0):
            w[i].normal_(0.0, std, generator=gen)     # meta: shapes only
        p[name] = w
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared_w_in"] = dense_init(gen, d_model, fs * mult, dtype,
                                      device=device)
        p["shared_w_out"] = dense_init(gen, fs, d_model, dtype,
                                       scale=fs ** -0.5, device=device)
    return p


def _by_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, D) @ w (D, F) as one batched GEMM over blocks of ``ROWS``
    rows, zero padded to at least two blocks: every block is the same
    product whatever N. At least two, because cuBLAS on the H100 takes a
    split-K kernel for one lone fp32 block and another kernel for any
    count from 2 to 256 (measured; ``chip_smoke.py`` phase 9 checks every
    count)."""
    n, d = x.shape
    nb = max(2, -(-n // ROWS))
    x = F.pad(x, (0, 0, 0, nb * ROWS - n))
    out = torch.bmm(x.reshape(nb, ROWS, d), w.expand(nb, *w.shape))
    return out.view(nb * ROWS, -1)[:n]


def _gated(z: torch.Tensor, act: str) -> torch.Tensor:
    gate, up = torch.chunk(z, 2, dim=-1)
    inner = F.silu(gate) if act == "swiglu" else activation("gelu")(gate)
    return inner * up


def _expert_ffn(h, w_in, w_out, act: str):
    """h: (E, C, D); returns (E, C, D)."""
    z = torch.bmm(h, w_in)
    if act in ("swiglu", "geglu"):
        z = _gated(z, act)
    elif act == "sq_relu":
        z = activation("sq_relu")(z)
    else:
        z = activation("gelu")(z)
    return torch.bmm(z, w_out)


def _shared_ffn(p, xf: torch.Tensor, act: str):
    """The always-on shared experts over xf (T, D), in row blocks. A
    non-gated ``act`` runs gelu here, sq_relu included, as repro does."""
    z = _by_rows(xf, p["shared_w_in"])
    z = _gated(z, act) if act in ("swiglu", "geglu") \
        else activation("gelu")(z)
    return _by_rows(z, p["shared_w_out"])


def _top_k(probs: torch.Tensor, k: int):
    """(weights, ids) of each row's k largest, descending, the lower id
    first among equals (``lax.top_k``'s order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _route(p, xf: torch.Tensor, cfg: MoEConfig):
    """Router of xf (T, D): (probs (T, E), normalized top-k weights (T,
    k), expert ids (T, k)). The k weights are summed left to right, one
    add at a time, so a row's sum does not depend on the batch."""
    logits = _by_rows(xf.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, cfg.top_k)
    total = top_w[:, 0]
    for j in range(1, cfg.top_k):
        total = total + top_w[:, j]
    return probs, top_w / torch.clamp(total, min=1e-9)[:, None], top_e


def capacity(t: int, cfg: MoEConfig, dropless: bool = False) -> int:
    """Rows an expert takes: t*k when dropless (the worst case), else
    ceil(t*k/E) * capacity_factor, then rounded up to a multiple of 8."""
    k, e = cfg.top_k, cfg.n_experts
    if dropless:
        return t * k
    cap = int(max(1, -(-t * k // e) * cfg.capacity_factor))
    return int(-(-cap // 8) * 8)


def _plan(top_e: torch.Tensor, n_exp: int, cap: int,
          lo: Optional[int] = None):
    """The dispatch of the (T*k) assignments in token-major order to the
    n_exp experts, or with ``lo`` to experts [lo, lo + n_exp) alone (the
    others', another rank's, go with the dropped ones, in the trash
    group n_exp): (their source tokens in expert order ``tok``,
    ``order``, each sorted assignment's ``keep`` and buffer row ``slot``;
    dropped ones point at the trash row after the last block)."""
    t, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    if lo is not None:
        flat_e = torch.where((flat_e >= lo) & (flat_e < lo + n_exp),
                             flat_e - lo, n_exp)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_exp + 1,
                                                       device=dev))
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos < cap
    if lo is not None:
        keep &= sorted_e < n_exp
    nb = -(-cap // ROWS)
    slot = torch.where(keep, (pos // ROWS) * (n_exp * ROWS)
                       + sorted_e * ROWS + pos % ROWS, nb * n_exp * ROWS)
    return order // k, order, keep, slot


def _aux(probs: torch.Tensor, top_e: torch.Tensor, cfg: MoEConfig):
    """Switch aux loss: fraction routed vs mean prob, per expert (a count
    of ones in fp32 is exact, whatever order the adds run in)."""
    t, e = probs.shape[0], cfg.n_experts
    frac = torch.zeros(e, dtype=torch.float32,
                       device=probs.device).scatter_add_(
        0, top_e[:, 0], torch.ones(t, dtype=torch.float32,
                                   device=probs.device))
    return e * torch.mean(frac / t * probs.mean(0)) * cfg.router_aux_weight


def _dispatch(xf: torch.Tensor, top_w, top_e, w_in, w_out, act: str,
              cap: int, lo: Optional[int] = None) -> torch.Tensor:
    """The (T, D) sum of each token's weighted outputs of the E experts
    that ``w_in`` / ``w_out`` (E, ...) hold (with ``lo``: experts [lo,
    lo + E) of the router's): scatter into the block-major (C / ROWS, E,
    ROWS, D) buffer, the expert GEMMs a block, then the combine: each
    token's k outputs in ascending expert id (another rank's or a dropped
    one adds a zero), summed in x's dtype from zero."""
    t, d = xf.shape
    k = top_e.shape[1]
    n_exp = w_in.shape[0]
    nb = -(-cap // ROWS)
    tok, order, keep, slot = _plan(top_e, n_exp, cap, lo)
    dtype = xf.dtype
    buf = torch.zeros((nb * n_exp * ROWS + 1, d), dtype=dtype,
                      device=xf.device)
    buf[slot] = xf[tok]               # dropped rows land on the trash row
    ebuf = buf[:-1].view(nb, n_exp, ROWS, d)
    y = torch.cat([_expert_ffn(ebuf[j], w_in, w_out, act)
                   for j in range(nb)]).view(-1, d)

    # ---- combine: each token's k outputs, in ascending expert id -----
    by_id = torch.argsort(top_e, dim=-1)               # distinct ids
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=xf.device)
    at = inv.view(t, k).gather(1, by_id).reshape(-1)   # sorted positions
    kept = keep[at]
    gathered = y[torch.where(kept, slot[at], 0)] * kept[:, None]
    w = pick(top_w, 1, by_id).reshape(-1, 1)
    contrib = (gathered.float() * w).to(dtype).view(t, k, d)
    out = torch.zeros((t, d), dtype=dtype, device=xf.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_block(p, x: torch.Tensor, cfg: MoEConfig,
              dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    dropless=True sizes capacity at the worst case (t*k): exact routing
    with zero drops — the decode/serving path, where t is tiny and exact
    teacher-forcing consistency matters. Prefill uses the bounded
    capacity_factor buffer (GShard drops)."""
    b, s, d = x.shape
    out, aux = _routed(x, p["router"], p["w_in"], p["w_out"], cfg,
                       dropless)
    if cfg.n_shared:
        out = out + _shared_ffn(p, x.reshape(b * s, d),
                                cfg.act).reshape(b, s, d)
    return out, aux


def _routed(x: torch.Tensor, router, w_in, w_out, cfg: MoEConfig,
            dropless: bool, lo: Optional[int] = None):
    """The routed experts' part of the block on x (B, S, D): (out, aux).
    The shared experts read x through a reshape of their own, in
    ``moe_block`` and ``moe_block_sharded`` alike, so that autograd adds
    x's gradient terms in the same order on both paths."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs, top_w, top_e = _route({"router": router}, xf, cfg)
    aux = _aux(probs, top_e, cfg)
    out = _dispatch(xf, top_w, top_e, w_in, w_out, cfg.act,
                    capacity(t, cfg, dropless), lo)
    return out.reshape(b, s, d), aux


def moe_local(x_loc: torch.Tensor, router: torch.Tensor,
              w_in: torch.Tensor, w_out: torch.Tensor, m_idx: int,
              e_loc: int, cfg: MoEConfig, dropless: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's body of ``moe_block_sharded`` (repro's shard_map
    ``body``), on local tensors and no collective: x_loc (B, S, D) the
    rank's tokens, router (D, E), w_in / w_out the e_loc experts of
    model index ``m_idx`` (experts [m_idx * e_loc, (m_idx + 1) * e_loc)),
    whole in d_model. It routes its own tokens, takes the capacity from
    its own token count (as repro's body), and dispatches only to its own
    experts, by ``moe_block``'s rule (stable sorts, ties to the lower
    expert id, GEMMs in ``ROWS``-row blocks). Returns (partial (B, S, D):
    the weighted outputs of its experts, zero elsewhere; aux_local: the
    aux loss of its tokens)."""
    return _routed(x_loc, router, w_in, w_out, cfg, dropless,
                   lo=m_idx * e_loc)


def moe_block_sharded(p, x: torch.Tensor, cfg: MoEConfig, mesh,
                      dropless: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on one rank of ``mesh`` (a ``DeviceMesh``
    with "data" and "model" axes), repro's ``moe_block_sharded``: x (B,
    S, D) is this rank's tokens (its data-parallel block), p["w_in"] /
    p["w_out"] its (E_pad / model, D / data, ...) blocks of the experts
    (``launch/sharding.distribute_tree`` under ``lm_param_specs``), the
    router whole, the shared experts whole (a train cell) or a "model"
    block (a serving cell, ``models/tp``). The experts' d_model blocks
    are all-gathered over "data", ``moe_local`` runs this rank's experts
    on its tokens, the partials are summed over "model" and the aux loss
    averaged over the data-parallel axes; whole shared experts are added
    after the sum as repro adds them, a block's partial before it
    (``_sum_with_shared``). Returns (out (B, S, D), aux)."""
    from ..launch import collectives as col
    from ..launch.mesh import coordinate, dp_axes

    e_loc = p["w_in"].shape[0]
    w_in = col.all_gather(p["w_in"], mesh, "data", dim=1)
    w_out = col.all_gather(p["w_out"], mesh, "data", dim=1)
    partial, aux = moe_local(x, p["router"], w_in, w_out,
                             coordinate(mesh)["model"], e_loc, cfg, dropless)
    out = _sum_with_shared(p, x, partial, cfg, mesh)
    return out, col.all_reduce_mean(aux, mesh, dp_axes(mesh))


def _shared_is_block(p, cfg: MoEConfig) -> bool:
    """Whether p holds a model rank's block of the shared experts (a
    serving cell's layout) rather than the whole of them."""
    return bool(cfg.n_shared) and \
        p["shared_w_out"].shape[0] < cfg.n_shared * cfg.d_ff


def _sum_with_shared(p, x: torch.Tensor, partial: torch.Tensor,
                     cfg: MoEConfig, mesh) -> torch.Tensor:
    """The routed partial summed over "model", plus the shared experts:
    a rank's block of them (``shared_w_in``'s columns as
    ``models/tp.gated_block`` cuts them, ``shared_w_out``'s matching
    rows) adds its partial before the sum; whole ones add after it."""
    from ..launch import collectives as col

    b, s, d = x.shape
    if not cfg.n_shared:
        return col.all_reduce_sum(partial, mesh, "model")
    shared = _shared_ffn(p, x.reshape(b * s, d), cfg.act).reshape(b, s, d)
    if _shared_is_block(p, cfg):
        return col.all_reduce_sum(partial + shared, mesh, "model")
    return col.all_reduce_sum(partial, mesh, "model") + shared


def moe_block_tp(p, x: torch.Tensor, cfg: MoEConfig, mesh,
                 dropless: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE block of a serving cell whose data axes do not divide the
    batch (long_500k's one sequence, where ``sharded_moe_applicable``
    says no), on one rank of ``mesh``: x (B, S, D) is every token
    (replicated), the experts at their spec (this rank's E_pad / model
    experts, their d_model blocks over "data", all-gathered here), the
    shared experts a "model" block. ``moe_local`` runs the rank's
    experts on all the tokens, routed and sized as ``moe_block`` does
    on them, and the partials (shared included) are summed over
    "model". Returns (out, aux), aux that of all the tokens."""
    from ..launch import collectives as col
    from ..launch.mesh import axis_size, coordinate

    e_loc, e_pad = p["w_in"].shape[0], padded_experts(cfg.n_experts)
    if e_loc * axis_size(mesh, "model") != e_pad:
        raise ValueError(f"moe_block_tp: {e_loc} experts a rank are not a "
                         f"block of {e_pad} over "
                         f"{axis_size(mesh, 'model')} model ranks")
    w_in, w_out = p["w_in"], p["w_out"]
    if w_in.shape[1] < x.shape[-1]:
        w_in = col.all_gather(w_in, mesh, "data", dim=1)
        w_out = col.all_gather(w_out, mesh, "data", dim=1)
    partial, aux = moe_local(x, p["router"], w_in, w_out,
                             coordinate(mesh)["model"], e_loc, cfg, dropless)
    return _sum_with_shared(p, x, partial, cfg, mesh), aux


def sharded_moe_applicable(cfg: MoEConfig, mesh, d_model: int,
                           batch: Optional[int] = None) -> bool:
    """repro's rule: a mesh with "data" and "model" axes whose model
    extent divides the padded experts and whose data extent divides
    d_model (and, given the global ``batch``, whose data-parallel extent
    divides it). Reads only the mesh's names and shape."""
    from ..launch.mesh import axis_size, dp_axes

    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    if (mesh is None or "model" not in names or "data" not in names
            or padded_experts(cfg.n_experts) % axis_size(mesh, "model")
            or d_model % axis_size(mesh, "data")):
        return False
    if batch is not None:
        if batch % axis_size(mesh, dp_axes(mesh)) != 0:
            return False               # e.g. long_500k batch=1
    return True


def dropped_pairs(p, x: torch.Tensor, cfg: MoEConfig,
                  dropless: bool = False) -> torch.Tensor:
    """The (token, expert) assignments ``moe_block`` drops for x (B, S,
    D), as an (n, 2) int64 tensor sorted by token, then expert. Reads
    back to the host: a test and report helper, not on the path."""
    t = x.shape[0] * x.shape[1]
    _, _, top_e = _route(p, x.reshape(t, -1), cfg)
    e_pad = p["w_in"].shape[0]
    return _drops(top_e, e_pad, capacity(t, cfg, dropless))


def local_dropped_pairs(x_loc: torch.Tensor, router: torch.Tensor,
                        m_idx: int, e_loc: int, e_pad: int, cfg: MoEConfig,
                        dropless: bool = False) -> torch.Tensor:
    """The (token, expert) assignments to its own experts that
    ``moe_local`` drops for x_loc, as ``dropped_pairs`` gives them."""
    t = x_loc.shape[0] * x_loc.shape[1]
    _, _, top_e = _route({"router": router}, x_loc.reshape(t, -1), cfg)
    return _drops(top_e, e_pad, capacity(t, cfg, dropless),
                  (m_idx * e_loc, e_loc))


def _drops(top_e: torch.Tensor, e_pad: int, cap: int, local=None):
    lo, n_exp = local if local is not None else (None, e_pad)
    tok, order, keep, _ = _plan(top_e, n_exp, cap, lo)
    flat_e = top_e.reshape(-1)[order]
    mine = torch.ones_like(keep) if lo is None else \
        (flat_e >= lo) & (flat_e < lo + n_exp)
    pairs = torch.stack([tok, flat_e], 1)[mine & ~keep]
    return pairs[torch.argsort(pairs[:, 0] * e_pad + pairs[:, 1])]


def moe_block_dense_ref(p, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """O(E) dense oracle (every expert computes every token) — test-only
    reference for the dispatch path, no capacity drops."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, cfg.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    e_pad = p["w_in"].shape[0]
    all_out = _expert_ffn(xf.expand(e_pad, *xf.shape), p["w_in"],
                          p["w_out"], cfg.act)                 # (E, T, D)
    gate = torch.zeros((xf.shape[0], e_pad), dtype=torch.float32,
                       device=x.device).scatter_add_(1, top_e, top_w)
    out = torch.einsum("te,etd->td", gate, all_out.float())
    if cfg.n_shared:
        out = out + _shared_ffn(p, xf, cfg.act)
    return out.reshape(b, s, d).to(x.dtype)

