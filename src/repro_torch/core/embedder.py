"""Embedding generation (paper §III-B).

The paper uses SentenceTransformers all-MiniLM-L6-v2 (384-d). Offline and
TPU-native, we provide two embedders behind one protocol:

  - HashProjectionEmbedder: deterministic signed-feature-hashing ("count
    sketch") embeddings. Token + bigram features hash to +-1 at h positions
    of a dim-d vector; L2-normalize. Cosine similarity then approximates
    lexical overlap — meaningful retrieval without any pretrained weights,
    fully reproducible, and fast. Used by default for the system
    benchmarks (the paper's metrics — reprocessing %, leakage, latency
    ordering — do not depend on embedding *quality*).

  - models/embedder.py provides TransformerEmbedder: a MiniLM-class JAX
    encoder (6L/384d/12H, mean-pooled) sharing the LM layer stack; it is
    the production path and the RAG-serving examples use it.
"""
from __future__ import annotations

import re
import zlib
from typing import Protocol, Sequence

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")


class Embedder(Protocol):
    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray: ...


def _tokens(text: str) -> list[str]:
    toks = _TOKEN.findall(text.casefold())
    return toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]


class HashProjectionEmbedder:
    def __init__(self, dim: int = 384, n_hashes: int = 4, seed: int = 0):
        self.dim = dim
        self.n_hashes = n_hashes
        self.seed = seed

    def _accumulate(self, text: str, out: np.ndarray) -> None:
        for tok in _tokens(text):
            data = tok.encode()
            for i in range(self.n_hashes):
                h = zlib.crc32(data, self.seed * 1000003 + i * 8191)
                pos = h % self.dim
                sign = 1.0 if (h >> 17) & 1 else -1.0
                out[pos] += sign

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            self._accumulate(t, out[i])
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


class CachingEmbedder:
    """Content-address embedding cache (paper §III-A2 'automatic
    deduplication'): identical chunks across documents and versions share
    one embedding computation. Keys are SHA-256 chunk ids, so a cache hit
    is a *semantic* guarantee, not a heuristic."""

    def __init__(self, inner: Embedder):
        self.inner = inner
        self.dim = inner.dim
        self._cache: dict[str, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def embed_chunks(self, ids: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        todo: list[int] = []
        for i, cid in enumerate(ids):
            hit = self._cache.get(cid)
            if hit is not None:
                out[i] = hit
                self.hits += 1
            else:
                todo.append(i)
                self.misses += 1
        if todo:
            fresh = self.inner.embed([texts[i] for i in todo])
            for j, i in enumerate(todo):
                out[i] = fresh[j]
                self._cache[ids[i]] = fresh[j]
        return out

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return self.inner.embed(texts)

    def warm(self, ids: Sequence[str], embeddings: np.ndarray) -> None:
        """Pre-seed from a cold-tier snapshot (used on restart so dedup
        survives process death)."""
        for cid, e in zip(ids, embeddings):
            self._cache.setdefault(cid, np.asarray(e, np.float32))
