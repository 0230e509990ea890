"""Data and traffic made from ``--seed`` alone.

The version plan of a configuration: ``corpus_rows`` passages (one
chunk each), ``chunks_per_doc`` consecutive passages to a document (the
chunk's position in it), committed at ``versions`` instants ``commit_interval_us``
apart. The first commit writes every passage; each later one supersedes
``corpus_rows // churn_divisor`` passages picked at random among all of
them (closing the open row of each and appending its new version). Rows
are laid out in commit order, which is the order the cold tier's fold
yields them in. Every seed gives the same sizes; only which passages
churn, the rows' values and the queries change.

Traffic: a stream of unique query texts drawn from a seeded vocabulary,
each with the instant it asks about (``None`` for a current-knowledge
query). Every seed gets the same multiset of text lengths and instants
in each block of requests, in another order, so the seed changes which
words and rows are asked for and not how much work a block is. The
i-th request of a seed is the same whatever the timing of the run.
"""
from __future__ import annotations

import dataclasses
import string

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def seed_of(seed: int, salt: int) -> int:
    """A non-negative 63-bit seed for one stream of a run (any integer
    ``seed``, negative or wider than 32 bits, is accepted)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt) & SEED_MASK


@dataclasses.dataclass
class History:
    """The full version history of one store: row r is the r-th row the
    cold tier's fold yields. ``vf``/``vt`` are each row's validity
    interval as the plan makes it, ``key`` its passage, ``commit`` the
    0-based commit that wrote it."""
    emb: torch.Tensor            # (N, D) float32 unit rows, on ``device``
    key: np.ndarray              # (N,) int64 passage index
    commit: np.ndarray           # (N,) int64
    vf: np.ndarray               # (N,) int64 unix microseconds
    vt: np.ndarray               # (N,) int64; OPEN for rows never closed
    instants: list[int]          # commit instants, one a commit
    per_doc: int                 # chunks a document: key = doc * per_doc + position
    bounds: list[tuple[int, int]]  # [lo, hi) rows of each commit
    closed: list[np.ndarray]     # passages each commit supersedes

    @property
    def n(self) -> int:
        return int(self.key.shape[0])

    def valid_at(self, t: int) -> np.ndarray:
        """(N,) bool: rows whose interval covers the instant ``t``."""
        return (self.vf <= t) & (t < self.vt)

    def current(self) -> np.ndarray:
        """Row ids of the open rows, in fold order (the active snapshot)."""
        return np.nonzero(self.vt == OPEN)[0]


OPEN = np.iinfo(np.int64).max


def chunk_id(row: int) -> str:
    return f"{row:012x}"


def row_of(cid: str) -> int:
    return int(cid, 16)


def doc_id(doc: int) -> str:
    return f"d{doc:05d}"


def passage_text(key: int, commit: int) -> str:
    return f"p{key}v{commit}"


def unit_rows(n: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, d) float32 rows uniform on the unit sphere, in blocks of 2^18
    rows so the normal draw never holds more than one block beside the
    result."""
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    step = 1 << 18
    for lo in range(0, n, step):
        x = torch.randn((min(step, n - lo), d), generator=gen,
                        dtype=torch.float32, device=device)
        out[lo:lo + x.shape[0]] = x / x.norm(dim=1, keepdim=True)
    return out


def make_history(cfg: dict, seed: int, device) -> History:
    n0 = int(cfg["corpus_rows"])
    if "books" in cfg and n0 != int(cfg["books"]) * int(cfg["chunks_per_doc"]):
        raise ValueError("corpus_rows is books x chunks_per_doc")
    churn = n0 // int(cfg["churn_divisor"])
    versions = int(cfg["versions"])
    d = int(cfg["dim"])
    t0, dt = int(cfg["t0_us"]), int(cfg["commit_interval_us"])
    instants = [t0 + c * dt for c in range(versions)]
    rng = np.random.default_rng(seed_of(seed, 1))
    n = n0 + (versions - 1) * churn
    key = np.empty(n, np.int64)
    commit = np.empty(n, np.int64)
    vf = np.empty(n, np.int64)
    vt = np.full(n, OPEN, np.int64)
    open_row = np.arange(n0, dtype=np.int64)
    key[:n0] = np.arange(n0)
    commit[:n0] = 0
    vf[:n0] = instants[0]
    bounds, closed = [(0, n0)], [np.zeros(0, np.int64)]
    lo = n0
    for c in range(1, versions):
        pick = np.sort(rng.choice(n0, churn, replace=False))
        vt[open_row[pick]] = instants[c]
        rows = np.arange(lo, lo + churn)
        key[rows] = pick
        commit[rows] = c
        vf[rows] = instants[c]
        open_row[pick] = rows
        bounds.append((lo, lo + churn))
        closed.append(pick)
        lo += churn
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 2))
    emb = unit_rows(n, d, gen, device)
    return History(emb, key, commit, vf, vt, instants,
                   int(cfg["chunks_per_doc"]), bounds, closed)


def vocabulary(size: int, seed: int) -> list[str]:
    """``size`` distinct lowercase words of 3 to 10 letters."""
    rng = np.random.default_rng(seed_of(seed, 3))
    letters = np.array(list(string.ascii_lowercase))
    words: dict[str, None] = {}
    while len(words) < size:
        m = size - len(words)
        lens = rng.integers(3, 11, m)
        draw = letters[rng.integers(0, 26, (m, 10))]
        for w, ln in zip(draw, lens):
            words.setdefault("".join(w[:ln]), None)
    return list(words)[:size]


class Traffic:
    """The request stream of one mix. ``next()`` returns (text, at):
    ``at`` is None for a current-knowledge query, else one of the commit
    instants. A text has ``words_min`` + Poisson(``words_mean`` -
    ``words_min``) words; texts are unique within a run: the first two
    words name the request's number in the vocabulary's base. Each block
    of ``BLOCK`` requests takes the same lengths (from a fixed stream)
    and the same count of each instant, shuffled by the seed."""

    BLOCK = 4096
    LENGTH_SEED = 0x5EED

    def __init__(self, mix: dict, instants: list[int], seed: int):
        self.mix = mix
        self.vocab = vocabulary(int(mix["vocab_size"]), seed)
        self.instants = np.asarray(instants, np.int64)
        self.rng = np.random.default_rng(seed_of(seed, 4))
        self.lengths = np.random.default_rng(self.LENGTH_SEED)
        self.lo = int(mix["words_min"])
        self.extra = float(mix["words_mean"]) - self.lo
        if self.lo < 2 or self.extra < 0:
            raise ValueError("a text has at least its two naming words")
        self.asof = mix["intent"] == "asof"
        self.i = 0
        self._block: list = []

    def _fill(self) -> None:
        b, v = self.BLOCK, len(self.vocab)
        lens = self.lo + self.lengths.poisson(self.extra, b)
        lens = self.rng.permutation(lens)
        words = self.rng.integers(0, v, (b, int(lens.max())))
        ats = self.rng.permutation(np.arange(b) % len(self.instants))
        vocab = self.vocab
        block = []
        for j in range(b):
            n = self.i + j
            head = [vocab[n % v], vocab[(n // v) % v]]
            text = " ".join(head + [vocab[w] for w in
                                    words[j, :lens[j] - 2]])
            at = int(self.instants[ats[j]]) if self.asof else None
            block.append((text, at))
        self._block = block[::-1]

    def next(self) -> tuple[str, int | None]:
        if not self._block:
            self._fill()
        self.i += 1
        return self._block.pop()
