"""Shared NN layer library, inference subset (PyTorch).

Conventions (those of repro's ``models/layers.py``):
  - params are dicts of tensors, or the ``ParamModule``s of
    models/transformer.py, indexed by name (``p["wq"]``);
  - every initializer takes an explicit ``torch.Generator`` and dtype;
  - attention goes through kernels/flash_attention: the hand-written
    kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.

Training pieces (``chunked_attention``, ``grad_cast``,
``cross_entropy_loss``) are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import math

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
