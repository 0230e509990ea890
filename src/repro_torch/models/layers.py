"""Shared NN layer library (PyTorch).

Conventions (those of repro's ``models/layers.py``):
  - params are dicts of tensors, or the ``ParamModule``s of
    models/transformer.py, indexed by name (``p["wq"]``);
  - every initializer takes an explicit ``torch.Generator`` and dtype;
  - attention goes through kernels/flash_attention: the hand-written
    kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.

Training pieces: ``cross_entropy_loss`` (the LM and BERT4Rec loss),
``grad_cast`` (an identity here: see its docstring) and
``chunked_attention``, repro's online-softmax scan in plain PyTorch, kept
for the tests that hold the attention kernel's plain backward to it; no
path of the port runs it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale=None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    # back to x's dtype BEFORE the gamma multiply, as repro does
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(d_head: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) int. Split halves (the
    first Dh/2 features rotate against the second), not interleaved."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)            # (Dh/2,)
    angles = positions[..., None].float() * freqs                # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation; torch's is erf
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "gelu":
        return _gelu_tanh
    if name == "silu":
        return F.silu
    if name == "relu":
        return F.relu
    if name == "sq_relu":            # squared ReLU (Primer; Nemotron-4)
        return lambda x: F.relu(x).square()
    if name == "ssp":                # shifted softplus (SchNet)
        return lambda x: F.softplus(x) - math.log(2.0)
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# attention (GQA) block
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True


def attention_params(gen: torch.Generator, cfg: AttentionConfig,
                     dtype=torch.float32, device=None) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    p = {
        "wq": dense_init(gen, d, h * dh, dtype, device=device),
        "wk": dense_init(gen, d, kv * dh, dtype, device=device),
        "wv": dense_init(gen, d, kv * dh, dtype, device=device),
        "wo": dense_init(gen, h * dh, d, dtype, scale=(h * dh) ** -0.5,
                         device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dtype, device=device)
    return p


def attention_qkv(p, x: torch.Tensor, cfg: AttentionConfig,
                  positions: torch.Tensor):
    """Project + rope. x: (B, S, D) -> q (B, H, S, Dh), k/v (B, KV, S,
    Dh)."""
    b, s, _ = x.shape
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # layout (B, H, S, Dh) for the attention kernels
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """The attention of a block: the flash kernel for CUDA tensors, its
    plain PyTorch version for CPU tensors. repro's ``impl`` modes (flash,
    chunked, ref) have no counterpart: the tensors' device decides."""
    return flash_attention(q, k, v, causal=causal)


def attention_block(p, x: torch.Tensor, cfg: AttentionConfig,
                    positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full self-attention over x (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = attention_impl(q, k, v, cfg.causal)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return torch.matmul(o, p["wo"])


# ---------------------------------------------------------------------------
# dense MLP block
# ---------------------------------------------------------------------------
def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str,
               dtype=torch.float32, device=None) -> dict:
    gated = act in ("swiglu", "geglu")
    return {
        "win": dense_init(gen, d_model, d_ff * (2 if gated else 1), dtype,
                          device=device),
        "wout": dense_init(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5,
                           device=device),
    }


def mlp_block(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = torch.matmul(x, p["win"])
    if act in ("swiglu", "geglu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        inner = F.silu(gate) if act == "swiglu" else _gelu_tanh(gate)
        h = inner * up
    else:
        h = activation(act)(h)
    return torch.matmul(h, p["wout"])


# ---------------------------------------------------------------------------
# training pieces
# ---------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """repro's memory-efficient attention: a loop over KV chunks with an
    online softmax carry (m, l, acc), fp32, GQA by grouping the query
    heads (no repeat of K/V). Differentiable by autograd. q: (B, H, Sq,
    Dh); k, v: (B, KV, Skv, Dh). Returns (B, H, Sq, Dh) in q's dtype."""
    b, h, sq, dh = q.shape
    kv, skv = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else dh ** -0.5
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"chunked_attention: {skv} keys are not whole "
                         f"chunks of {chunk}")
    q_off = skv - sq                      # causal: q rows are last sq pos
    qf = (q.float() * scale).reshape(b, kv, group, sq, dh)
    m = torch.full((b, kv, group, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, kv, group, sq), device=q.device)
    acc = torch.zeros((b, kv, group, sq, dh), device=q.device)
    for j in range(skv // chunk):
        k_j = k[:, :, j * chunk:(j + 1) * chunk].float()
        v_j = v[:, :, j * chunk:(j + 1) * chunk].float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k_j)
        if causal:
            rows = torch.arange(sq, device=q.device)[:, None] + q_off
            cols = j * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = s.masked_fill(~(rows >= cols), float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(torch.isneginf(s), 0.0,
                        torch.exp(s - m_safe[..., None]))
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd",
                                                    p, v_j)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, h, sq, dh).to(q.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """repro's identity whose cotangent is cast to the primal dtype, so
    that a bf16 param's stacked gradient is bf16, not fp32. Autograd
    already returns every gradient in its input's dtype (the backward of
    a dtype cast casts back), so here it is the identity: a bf16 param's
    grad is bf16 without it."""
    return x


class _Pick(torch.autograd.Function):
    """``x.gather(dim, idx)`` for an ``idx`` that names each position of
    ``dim`` at most once a row; its gradient stores each cotangent at its
    position in zeros (``scatter_``, no atomics: ``gather``'s own
    backward is a ``scatter_add_``, atomic adds on the card)."""

    @staticmethod
    def forward(ctx, x, dim, idx):
        ctx.save_for_backward(idx)
        ctx.dim, ctx.shape = dim, x.shape
        return x.gather(dim, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.new_zeros(ctx.shape).scatter_(ctx.dim, idx, g), None, None


def pick(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, dim, idx)``, each position of ``dim`` picked at
    most once a row (a gold logit, a token's k router weights): the same
    values, a gradient with no atomics."""
    return _Pick.apply(x, dim, idx)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """logits (B, S, V) fp32/bf16; labels (B, S) int. Mean of
    logsumexp - gold logit in fp32 over the positions whose label is not
    ``ignore_id``, over max(count, 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = pick(logits, -1, torch.clamp(labels, min=0).long()[..., None]
                )[..., 0]
    mask = (labels != ignore_id).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
