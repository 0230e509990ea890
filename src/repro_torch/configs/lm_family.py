"""Shared cell/spec helpers for the LM-family transformers.

Shapes (assigned):
  train_4k     seq=4096    global_batch=256   -> train_step
  prefill_32k  seq=32768   global_batch=32    -> prefill (inference)
  decode_32k   seq=32768   global_batch=128   -> decode_step (KV cache in)
  long_500k    seq=524288  global_batch=1     -> decode_step, seq-sharded KV

long_500k note (DESIGN.md §4): all five assigned LM archs are
full-attention; the assigned shape lowers serve_step (ONE token vs a 512k
cache) which is LINEAR in cache length, so we run it with a
sequence-sharded cache + split-softmax merge instead of skipping. A
quadratic 500k PREFILL would be skipped for these archs; it was not
assigned.
"""
from __future__ import annotations

import dataclasses

from ..models.transformer import TransformerConfig
from .base import Cell, i32, sds

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# reduced variants: same family/topology, toy sizes (CPU smoke tests)
LM_SHAPES_REDUCED = {
    "train_4k": dict(kind="train", seq=32, batch=2),
    "prefill_32k": dict(kind="prefill", seq=64, batch=2),
    "decode_32k": dict(kind="decode", seq=64, batch=2),
    "long_500k": dict(kind="decode", seq=128, batch=1),
}


def reduce_config(cfg: TransformerConfig) -> TransformerConfig:
    """Same family (GQA ratio, activation, MoE-ness), toy dims."""
    kv = max(1, cfg.n_kv * 4 // cfg.n_heads)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(8, moe.n_experts),
                                  top_k=min(2, moe.top_k), d_ff=32,
                                  n_shared=min(1, moe.n_shared))
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv=kv,
        d_head=16, d_ff=128, moe=moe, dtype=cfg.dtype, remat=False)


def lm_cells(arch: str) -> list[Cell]:
    return [Cell(arch, s, LM_SHAPES[s]["kind"]) for s in LM_SHAPES]


def lm_input_specs(cfg: TransformerConfig, shape: str,
                   reduced: bool = False) -> dict:
    table = LM_SHAPES_REDUCED if reduced else LM_SHAPES
    info = table[shape]
    b, s = info["batch"], info["seq"]
    kind = info["kind"]
    if kind == "train":
        return {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    if kind == "prefill":
        return {"tokens": sds((b, s), i32)}
    assert kind == "decode"
    cache = (cfg.n_layers, b, cfg.n_kv, s, cfg.d_head)
    return {
        "tokens": sds((b, 1), i32),
        "cache_k": sds(cache, cfg.dtype),
        "cache_v": sds(cache, cfg.dtype),
        "cache_len": sds((), i32),
    }
