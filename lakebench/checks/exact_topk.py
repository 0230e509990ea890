"""Each sampled answer against the exact top-k, in float64, over the
rows valid at its request's instant (every open row for a current
query). This is what the fused temporal path promises: validity is
filtered before ranking, and the ranking is exact."""
from __future__ import annotations

import types

import numpy as np

from .. import reference
from ..generator import OPEN, chunk_id

CONTROLS = ("tf32",)


def allowed_rows(hist, at) -> np.ndarray:
    return hist.vt == OPEN if at is None else hist.valid_at(at)


def numbers(ctx, samples: list, control=None) -> dict:
    """``control="tf32"`` puts the reference at TF32 in the program's
    place, the nearest precision below the configuration's float32."""
    k = int(ctx.mix["k"])
    qs = reference.query_vectors([s.text for s in samples], ctx.cfg)
    ref_s = np.full((len(samples), k), -np.inf)
    ref_r = np.full((len(samples), k), -1, np.int64)
    answers = [s.answer for s in samples]
    masks = {}
    for at in sorted({s.at for s in samples}, key=lambda a: a or 0):
        idx = [i for i, s in enumerate(samples) if s.at == at]
        masks[at] = ok = allowed_rows(ctx.hist, at)
        rs, rr = reference.exact_topk(ctx.emb, ok, qs[idx], k)
        ref_s[idx], ref_r[idx] = rs, rr
        if control:
            cs, cr = reference.exact_topk(ctx.emb, ok, qs[idx], k,
                                          tf32=True)
            for j, i in enumerate(idx):
                answers[i] = [(chunk_id(int(r)), float(s))
                              for s, r in zip(cs[j], cr[j])]
    return reference.compare(ctx.hist, ctx.emb, qs, answers,
                             [masks[s.at] for s in samples], ref_s, ref_r,
                             k)


def context(hist, emb, rows, cfg: dict, mix: dict):
    ctx = types.SimpleNamespace(hist=hist, emb=emb, cfg=cfg, mix=mix)
    return ctx
