"""Plain PyTorch versions of the flash attention kernels, forward and
backward: the CPU paths of ``ops.flash_attention`` and
``ops.flash_attention_bwd`` and the yardsticks the CUDA kernels are held
to."""
from __future__ import annotations

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """(B, KV, G, Sq, Skv) fp32 scaled logits, -inf where masked."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    qf = (q.float() * scale).reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k.float())
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        cols = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(rows >= cols), float("-inf"))
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          scale: float | None = None,
                          return_lse: bool = False):
    """The function of repro's Pallas ``flash_attention_fwd`` in one pass:
    q (B, H, Sq, D), k/v (B, KV, Skv, D) -> (B, H, Sq, D) in q's dtype.
    fp32 throughout; query head h reads kv head h // (H // KV) (grouped,
    no repeat); causal column c is visible from row r iff
    r + (Skv - Sq) >= c; a row with no visible column gives 0. With
    ``return_lse`` also each row's logsumexp of its scaled logits (B, H,
    Sq) fp32, -inf for a row with no visible column."""
    b, h, sq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m_safe))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    out = out / torch.where(l == 0.0, 1.0, l)
    out = out.reshape(b, h, sq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, float("-inf"), m_safe + torch.log(l))
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor,
                              causal: bool = True,
                              scale: float | None = None):
    """The backward of ``flash_attention_plain`` from its output ``o`` and
    row logsumexp ``lse``, in fp32: P = exp(s - lse) (0 where masked or
    the row is empty), dV = P^T dO, dS = P * (dO V^T - rowsum(dO o)),
    dQ = scale dS K, dK = scale dS^T Q, dK and dV summed over each GQA
    group. Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, causal, scale)
    lse5 = lse.float().reshape(b, kv, g, sq, 1)
    p = torch.where(torch.isneginf(s) | torch.isneginf(lse5), 0.0,
                    torch.exp(s - lse5))
    dof = do.float().reshape(b, kv, g, sq, d)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dof)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", dof, v.float())
    delta = (dof * o.float().reshape(b, kv, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds,
                      q.float().reshape(b, kv, g, sq, d)) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def o_rounding_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                     causal: bool = True, scale: float | None = None):
    """How far the backward's (dq, dk, dv) may move, element by element,
    between two bf16 forwards of the same inputs. Each rounds its fp32
    output to bf16 once, and the two fp32 outputs differ by their sums'
    rounding; so o_d may move by one bf16 rounding step (2**-7 of
    itself) plus 2**-15 of sum_j P_ij |v_jd| (where o cancels). The
    backward reads o only through Delta = rowsum(dO * o), which then
    moves by at most E_i = 2**-7 sum_d |dO_id| (|o_id| + 2**-8
    sum_j P_ij |v_jd|). With P = exp(s - lse): dq_i moves by at most
    scale E_i sum_j P_ij |k_j|, dk_j by scale sum_i P_ij E_i |q_i|
    (summed over its GQA group), dv not at all. A row that sees few keys
    is ill-conditioned there (dS = P (dP - Delta) cancels), so this can
    exceed one rounding step of the gradient by far. Returns fp32
    tensors of the shapes of q, k and v."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, causal, scale)
    lse5 = lse.float().reshape(b, kv, g, sq, 1)
    p = torch.where(torch.isneginf(s) | torch.isneginf(lse5), 0.0,
                    torch.exp(s - lse5))
    pv = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float().abs())
    dof = do.float().abs().reshape(b, kv, g, sq, d)
    e = 2.0 ** -7 * (dof * (o.float().abs().reshape(b, kv, g, sq, d)
                            + 2.0 ** -8 * pv)).sum(-1, keepdim=True)
    dq = scale * e * torch.einsum("bkgqc,bkcd->bkgqd", p, k.float().abs())
    dk = scale * torch.einsum("bkgqc,bkgqd->bkcd", p,
                              e * q.float().abs().reshape(b, kv, g, sq, d))
    return dq.reshape(b, h, sq, d), dk, torch.zeros(k.shape,
                                                    device=k.device)
