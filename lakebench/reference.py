"""The plain reference: exact scores in float64 over rows whose validity
is worked out from the generator's version plan, never from the
program's state. Everything here is plain PyTorch and NumPy."""
from __future__ import annotations

import numpy as np
import torch

from . import hashembed
from .generator import History, row_of

BLOCK_ROWS = 1 << 17
BLOCK_QUERIES = 512


def query_vectors(texts, cfg: dict) -> np.ndarray:
    e = cfg["embedder"]
    return hashembed.embed(texts, dim=int(e["dim"]),
                           n_hashes=int(e["n_hashes"]), seed=int(e["seed"]))


def exact_topk(emb: torch.Tensor, allowed: np.ndarray, qs: np.ndarray,
               k: int, tf32: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Top-k rows of ``emb`` among ``allowed`` for each query of ``qs``,
    scored in float64 (or, for the control, as a float32 product with
    TF32 on). Scans in blocks of rows so the score block stays small.
    Returns (scores (Q, k) float64, rows (Q, k) int64)."""
    dev = emb.device
    ok = torch.as_tensor(allowed, device=dev)
    dtype = torch.float32 if tf32 else torch.float64
    out_s, out_r = [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        for q0 in range(0, qs.shape[0], BLOCK_QUERIES):
            q = torch.as_tensor(qs[q0:q0 + BLOCK_QUERIES], dtype=dtype,
                                device=dev)
            best_s = torch.full((q.shape[0], 0), -torch.inf, dtype=dtype,
                                device=dev)
            best_r = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                                 device=dev)
            for lo in range(0, emb.shape[0], BLOCK_ROWS):
                blk = emb[lo:lo + BLOCK_ROWS].to(dtype)
                s = q @ blk.T
                s = torch.where(ok[lo:lo + blk.shape[0]][None, :], s,
                                -torch.inf)
                s_all = torch.cat([best_s, s], dim=1)
                r_all = torch.cat([best_r, torch.arange(
                    lo, lo + blk.shape[0], device=dev).expand(q.shape[0],
                                                               -1)], dim=1)
                top = torch.topk(s_all, min(k, s_all.shape[1]), dim=1)
                best_s = top.values
                best_r = torch.gather(r_all, 1, top.indices)
            out_s.append(best_s.double().cpu().numpy())
            out_r.append(best_r.cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return np.concatenate(out_s), np.concatenate(out_r)


def row_scores(emb: torch.Tensor, qs: np.ndarray, rows: list) -> list:
    """float64 score of each query with each of its listed rows."""
    flat = np.asarray([r for rs in rows for r in rs], np.int64)
    if flat.size == 0:
        return [np.zeros(0) for _ in rows]
    qi = np.repeat(np.arange(len(rows)), [len(rs) for rs in rows])
    e = emb[torch.as_tensor(flat, device=emb.device)].double()
    q = torch.as_tensor(qs[qi], dtype=torch.float64, device=emb.device)
    s = (e * q).sum(dim=1).cpu().numpy()
    return np.split(s, np.cumsum([len(rs) for rs in rows])[:-1])


def compare(hist: History, emb: torch.Tensor, qs: np.ndarray,
            answers: list, allowed: list, ref_s: np.ndarray,
            ref_r: np.ndarray, k: int) -> dict:
    """The numbers a check holds an answer list to, each request's answer
    against its own reference. ``answers[i]`` is a list of (chunk id,
    score) in the order served, or None for a request that never got an
    answer; ``allowed[i]`` the (N,) validity of its instant; ``ref_s`` /
    ``ref_r`` the reference's top-k scores and rows."""
    nums = {"unanswered": 0, "short_answers": 0, "invalid_rows": 0,
            "duplicate_rows": 0, "score_err": 0.0, "rank_gap": 0.0,
            "recall_miss": 0.0}
    pairs = []
    for i, ans in enumerate(answers):
        ps = []
        if ans is None:
            nums["unanswered"] += 1
        else:
            for cid, score in ans:
                r = row_of_safe(cid)
                if not 0 <= r < hist.n or not allowed[i][r]:
                    nums["invalid_rows"] += 1
                    continue
                ps.append((r, float(score)))
            nums["short_answers"] += max(0, k - len(ans))
            nums["duplicate_rows"] += len(ps) - len({r for r, _ in ps})
        pairs.append(ps)
    exact = row_scores(emb, qs, [[r for r, _ in ps] for ps in pairs])
    hits = total = 0
    for i, ps in enumerate(pairs):
        if answers[i] is None:
            continue
        hits += len({r for r, _ in ps} & set(ref_r[i, :k].tolist()))
        total += k
        for j, ((_, s), e) in enumerate(zip(ps, exact[i])):
            nums["score_err"] = max(nums["score_err"], abs(s - float(e)))
            nums["rank_gap"] = max(nums["rank_gap"],
                                   float(ref_s[i, j]) - float(e))
    nums["recall_miss"] = 1.0 - hits / total if total else 1.0
    return nums


def row_of_safe(cid: str) -> int:
    try:
        return row_of(cid)
    except ValueError:
        return -1
