"""Gradient compression with error feedback (repro's
``train/grad_compress.py`` in PyTorch).

int8 uniform quantization per tensor with an error-feedback accumulator
(Seide et al. / EF-SGD): the quantization residual is carried into the
next step, so compression bias vanishes asymptotically. "Per tensor" is
per leaf of the param tree, at repro's granularity: a layer-stacked
(L, ...) leaf has ONE scale, the amax over all its layers.

Usage: ``grads, ef_state = compress_decompress(grads, ef_state)`` between
the backward and the optimizer (on one card nothing is sent between the
two; the round trip is what a data-parallel all-reduce of int8 grads
would deliver).
"""
from __future__ import annotations

import torch

from .tree import tree_map


def init_state(params):
    """Error-feedback accumulators, one fp32 tensor per leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_decompress(grads, ef_state):
    """int8 quantize -> dequantize with error feedback. Returns
    (decompressed grads in each grad's dtype, new ef_state)."""

    def per_leaf(g, e):
        g32 = g.float() + e                  # add the carried error
        deq = dequantize_int8(*quantize_int8(g32))
        return deq.to(g.dtype), g32 - deq    # the new error

    out = tree_map(per_leaf, grads, ef_state)      # (grad, error) leaves
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
