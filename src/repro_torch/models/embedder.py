"""TransformerEmbedder: MiniLM-class encoder (paper §III-B uses
all-MiniLM-L6-v2: 6 layers, d=384, 12 heads, mean pooling, 384-d output)
on the port's transformer (models/transformer with causal=False), whose
attention is the flash kernel on the card.

Batch invariance (DESIGN.md §8.3): ``embed`` pads every chunk it encodes
to ``batch_size`` rows (all-PAD rows, dropped after), so every matrix
product of the encoder has one shape whatever the number of texts, and a
text embeds to the same bits alone or inside any batch. That is what
keeps ``LiveVectorLake.query_batch == [query, ...]`` exact with this
embedder: cuBLAS and the CPU BLAS pick their blocking, and with it the
order of the sums, from the shapes.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from ..configs import minilm_embedder
from ..data.tokenizer import HashTokenizer
from ..kernels.common import resolve_device
from .transformer import TransformerConfig, forward_pooled, init_params

MINILM_CONFIG = minilm_embedder.CONFIG      # repro's name for the config


class TransformerEmbedder:
    """Batched text -> 384-d unit vectors (numpy fp32). Satisfies
    core.embedder.Embedder. ``device`` None = the card; ``params``: the
    port's modules (models/transformer.init_params, or repro's params
    through models/bridge.params_from_repro), copied to ``device`` if
    they lie elsewhere; default seeded random weights made there."""

    def __init__(self, cfg: TransformerConfig = MINILM_CONFIG,
                 max_len: int = 128, seed: int = 0, params=None,
                 device=None):
        self.cfg = cfg
        self.dim = cfg.d_model
        self.max_len = max_len
        self.device = resolve_device(device)
        self.tokenizer = HashTokenizer(cfg.vocab)
        if params is None:
            params = init_params(cfg, seed, self.device)
        elif next(params.parameters()).device != self.device:
            params = copy.deepcopy(params).to(self.device)
        self.params = params

    @torch.no_grad()
    def embed(self, texts: Sequence[str], batch_size: int = 32) -> np.ndarray:
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i: i + batch_size])
            toks = np.zeros((batch_size, self.max_len), np.int32)
            toks[:len(chunk)] = self.tokenizer.encode_batch(chunk,
                                                            self.max_len)
            toks = torch.from_numpy(toks).to(self.device)
            vecs = forward_pooled(self.params, toks, self.cfg)
            out.append(vecs[:len(chunk)].float().cpu().numpy())
        return np.concatenate(out, axis=0) if out else \
            np.zeros((0, self.dim), np.float32)
