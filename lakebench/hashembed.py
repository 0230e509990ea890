"""A frozen copy of the store's default query embedder (signed feature
hashing of tokens and bigrams, L2-normalised), for the reference: it
re-embeds each query text itself, in float64, and never calls the
program's embedder."""
from __future__ import annotations

import re
import zlib

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")


def features(text: str) -> list[str]:
    toks = _TOKEN.findall(text.casefold())
    return toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]


def embed(texts, dim: int = 384, n_hashes: int = 4, seed: int = 0
          ) -> np.ndarray:
    """(len(texts), dim) float64 unit rows: each feature adds +-1 at
    ``n_hashes`` positions picked by crc32 with per-hash salts."""
    out = np.zeros((len(texts), dim), np.float64)
    for i, text in enumerate(texts):
        row = out[i]
        for tok in features(text):
            data = tok.encode()
            for j in range(n_hashes):
                h = zlib.crc32(data, seed * 1000003 + j * 8191)
                row[h % dim] += 1.0 if (h >> 17) & 1 else -1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)
