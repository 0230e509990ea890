"""RAG serving engine: LiveVectorLake retrieval + LM generation.

The paper's end-to-end use case (§I): query -> temporal-aware retrieval
from the dual-tier store -> grounded generation. Temporal queries
retrieve from the cold tier AT the requested timestamp, so generation is
grounded in the knowledge as it existed then — the compliance story.

The generator is any dense ``TransformerConfig`` (the CLI uses a small
LM; ``configs/mistral_nemo_12b`` is the production width). On the card,
the prompt's attention is the flash attention kernel and each new
token's the split-K decode kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core.store import LiveVectorLake
from ..data.tokenizer import HashTokenizer
from ..kernels.common import resolve_device
from ..models import transformer as tfm
from .batcher import Batcher


@dataclasses.dataclass
class GenerationResult:
    query: str
    at: Optional[int]
    retrieved: list
    prompt: str
    token_ids: list[int]
    n_context_chunks: int


class RAGEngine:
    """``device`` None = the card. ``params``: the port's modules
    (models/transformer.init_params, or repro's params through
    models/bridge); default seeded random weights made on the device."""

    def __init__(self, store: LiveVectorLake, cfg: tfm.TransformerConfig,
                 params=None, seed: int = 0, max_prompt: int = 256,
                 retrieval_batch: int = 32, retrieval_k: int = 3,
                 device=None):
        self.store = store
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else tfm.init_params(
            cfg, seed, self.device)
        self.tokenizer = HashTokenizer(cfg.vocab)
        self.max_prompt = max_prompt
        self.cache_size = max_prompt + 64
        # serving-layer coalescing: concurrent retrieval requests queue
        # here and execute as batched hot-tier / snapshot passes.
        self.retrieval_k = retrieval_k
        self.retrieval_batcher: Batcher = store.query_batcher(
            k=retrieval_k, max_batch=retrieval_batch)

    def build_prompt(self, query: str, results) -> str:
        ctx = "\n\n".join(f"[{i+1}] {r.text}" for i, r in enumerate(results))
        return f"Context:\n{ctx}\n\nQuestion: {query}\n\nAnswer:"

    def answer(self, query: str, k: int = 3, at: Optional[int] = None,
               max_new_tokens: int = 16) -> GenerationResult:
        # 1. temporal-aware retrieval (hot tier or cold snapshot)
        results = self.store.query(query, k=k, at=at)
        # 2. grounded generation
        return self._generate(query, at, results, max_new_tokens)

    def answer_batch(self, queries: Sequence[str], k: Optional[int] = None,
                     at: Optional[int] = None, max_new_tokens: int = 16
                     ) -> list[GenerationResult]:
        """Batched serving path: retrieval for ALL queries coalesces
        through the request batcher into batched store passes (concurrent
        CURRENT queries become one hot-tier batch); generation then runs
        per query. Retrieved contexts are bit-identical to per-query
        ``answer`` calls."""
        k = self.retrieval_k if k is None else k
        if k == self.retrieval_k:
            reqs = [self.retrieval_batcher.submit((q, at, None))
                    for q in queries]
            self.retrieval_batcher.drain()
            retrieved = [r.result for r in reqs]
        else:                       # non-default k: direct batched pass
            retrieved = self.store.query_batch(list(queries), k=k, at=at)
        return [self._generate(q, at, res, max_new_tokens)
                for q, res in zip(queries, retrieved)]

    @torch.no_grad()
    def _generate(self, query: str, at: Optional[int], results,
                  max_new_tokens: int) -> GenerationResult:
        """Prefill the grounded prompt (padded to ``max_prompt``, so the
        first token comes from the last, possibly PAD, position, as in
        repro), then decode greedily: ``torch.argmax``, the first maximum
        on ties. The step after the last kept token is not run: its
        logits would never be read."""
        prompt = self.build_prompt(query, results)
        tokens = self.tokenizer.encode(prompt, max_len=self.max_prompt)
        toks = torch.from_numpy(tokens)[None, :].to(self.device)
        logits, cache, cache_len = tfm.prefill(self.params, toks, self.cfg,
                                               self.cache_size)
        out_ids = []
        cur = torch.argmax(logits, dim=-1)[:, None]
        for step in range(max_new_tokens):
            out_ids.append(int(cur[0, 0]))
            if step + 1 == max_new_tokens:
                break
            logits, cache, cache_len = tfm.decode_step(
                self.params, cur, cache, cache_len, self.cfg)
            cur = torch.argmax(logits, dim=-1)[:, None]
        return GenerationResult(query=query, at=at, retrieved=results,
                                prompt=prompt, token_ids=out_ids,
                                n_context_chunks=len(results))
