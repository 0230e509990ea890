"""Deterministic hash tokenizer (offline stand-in for a trained
SentencePiece/BPE vocab).

Words map to stable ids via crc32 into a fixed vocab range; ids 0..3 are
reserved (PAD=0, UNK=1, BOS=2, MASK=3). Deterministic across processes,
no external assets — good enough for an embedding pipeline whose quality
bar is lexical-overlap similarity (DESIGN.md §2).
"""
from __future__ import annotations

import re
import zlib

import numpy as np

PAD_ID, UNK_ID, BOS_ID, MASK_ID = 0, 1, 2, 3
N_RESERVED = 4

_TOKEN = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashTokenizer:
    def __init__(self, vocab_size: int = 30_522, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def encode(self, text: str, max_len: int | None = None,
               add_bos: bool = True) -> np.ndarray:
        toks = _TOKEN.findall(text.casefold())
        ids = [BOS_ID] if add_bos else []
        span = self.vocab_size - N_RESERVED
        for t in toks:
            h = zlib.crc32(t.encode(), self.seed)
            ids.append(N_RESERVED + (h % span))
        if max_len is not None:
            ids = ids[:max_len] + [PAD_ID] * max(0, max_len - len(ids))
        return np.asarray(ids, np.int32)

    def encode_batch(self, texts: list[str], max_len: int) -> np.ndarray:
        return np.stack([self.encode(t, max_len) for t in texts])
