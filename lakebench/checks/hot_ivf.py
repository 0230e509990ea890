"""Current-knowledge answers of the hot tier against the same search in
exact arithmetic: the reference works out the hot tier's layout after
``recover()`` inserts the open rows into an empty segmented index (a
segment sealed every ``hot_capacity`` rows, then size-tiered merges of
``FANOUT`` segments to a fixed point), partitions each segment by the
same seeded Lloyd k-means, routes each query to its ``nprobe`` nearest
centroids, and ranks the probed members and the memtable's rows by their
float64 scores. The configuration states the int8 scan's recall@10
against this fp32 search; its scores are exact after the rescore.

The replica mirrors the index's build (seal size, fan-out, k-means seed
and iterations, the routing): a later change to how the program builds
its partitions, sound or not, has to change this file with it.

Controls, each the reference in the program's place one precision below
the configuration's: ``int4_pool`` picks each source's pool by int4
scores (below the int8 scan), ``tf32`` scores and rescores as float32
products with TF32 on (below the fp32 rescore)."""
from __future__ import annotations

import types

import numpy as np
import torch

from .. import reference
from ..generator import OPEN, chunk_id

FANOUT = 4            # the size-tiered compactor's fan-out
KMEANS_SEED = 0       # the index's k-means seed
KMEANS_ITERS = 10
CONTROLS = ("int4_pool", "tf32")


def tier(n: int, base: int = FANOUT) -> int:
    t = 0
    while n >= base:
        n //= base
        t += 1
    return t


def layout(n: int, capacity: int) -> tuple[list, np.ndarray]:
    """Segments (each an array of positions in the insertion order) and
    the memtable's positions once ``n`` rows are inserted one by one
    (a full memtable is sealed before the next insert) and the
    compactor has merged, oldest first, ``FANOUT`` segments of the lowest
    size tier that holds that many, until none does."""
    seals = n // capacity if n % capacity else max(n // capacity - 1, 0)
    segs = [np.arange(i * capacity, (i + 1) * capacity)
            for i in range(seals)]
    while True:
        by_tier: dict[int, list] = {}
        for s in segs:
            by_tier.setdefault(tier(len(s)), []).append(s)
        pick = next((by_tier[t][:FANOUT] for t in sorted(by_tier)
                     if len(by_tier[t]) >= FANOUT), None)
        if pick is None:
            return segs, np.arange(seals * capacity, n)
        ids = {id(p) for p in pick}
        segs = [s for s in segs if id(s) not in ids] + [np.concatenate(pick)]


def kmeans(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Seeded Lloyd k-means over unit rows (sqrt(n) centroids, at least
    8), normalised centroids, then each row's nearest centroid."""
    n = v.shape[0]
    c = min(max(8, int(np.sqrt(n))), n)
    rng = np.random.default_rng(KMEANS_SEED)
    centroids = v[rng.choice(n, c, replace=False)].copy()
    for _ in range(KMEANS_ITERS):
        assign = np.argmax(v @ centroids.T, axis=1)
        for j in range(c):
            members = v[assign == j]
            if len(members):
                centroids[j] = members.mean(0)
        norms = np.linalg.norm(centroids, axis=1, keepdims=True)
        centroids = centroids / np.maximum(norms, 1e-9)
    return centroids, np.argmax(v @ centroids.T, axis=1)


class Replica:
    """The hot tier's sources as the reference works them out: global
    history rows of each IVF segment with its centroids and assignment,
    and the memtable's rows."""

    def __init__(self, hist, rows: np.ndarray, cfg: dict):
        store = cfg["store"]
        order = hist.current()
        segs, mem = layout(len(order), int(store["hot_capacity"]))
        self.nprobe = int(store["nprobe"])
        self.segments = []
        for s in segs:
            g = order[s]
            if len(g) < int(store["ivf_min_rows"]):
                raise ValueError("a segment below ivf_min_rows would join "
                                 "the fused block: not modelled")
            cents, assign = kmeans(rows[g])
            self.segments.append((g, cents, assign))
        self.mem = order[mem]


def int4_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -7, 7) * scale


def source_topk(q: torch.Tensor, v: torch.Tensor, member, k: int,
                pool: int, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of one source for a block of queries: scores in ``q``'s type
    (float64; float32 with TF32 on for the ``tf32`` control) over its
    candidate rows (``member``: (Q, n) bool or None for all);
    with ``scale`` (the control) a pool of ``pool`` rows picked by int4
    scores first, then ranked by their exact scores."""
    s = q @ v.T
    if member is not None:
        s = torch.where(member, s, -torch.inf)
    if scale is not None:
        a = q @ int4_rows(v, scale).T
        if member is not None:
            a = torch.where(member, a, -torch.inf)
        pick = torch.topk(a, min(pool, a.shape[1]), dim=1).indices
        s = torch.full_like(s, -torch.inf).scatter(
            1, pick, torch.gather(s, 1, pick))
    top = torch.topk(s, min(k, s.shape[1]), dim=1)
    return top.values, top.indices


def answers(ctx, qs: np.ndarray, control=None
            ) -> tuple[np.ndarray, np.ndarray]:
    rep = ctx.replica
    k = int(ctx.mix["k"])
    pool = k * int(ctx.cfg["store"]["rescore_factor"])
    dev = ctx.emb.device
    dtype = torch.float32 if control == "tf32" else torch.float64
    out_s, out_r = [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    try:
        for q0 in range(0, qs.shape[0], reference.BLOCK_QUERIES):
            q = torch.as_tensor(qs[q0:q0 + reference.BLOCK_QUERIES],
                                dtype=dtype, device=dev)
            cand_s, cand_r = [], []
            sources = [(rep.mem, None, None)] + rep.segments
            for g, cents, assign in sources:
                gd = torch.as_tensor(g, device=dev)
                v = ctx.emb[gd].to(dtype)
                member, scale = None, None
                if cents is not None:
                    c = torch.as_tensor(cents, dtype=torch.float64,
                                        device=dev)
                    probe = torch.topk(q.double() @ c.T,
                                       min(rep.nprobe, c.shape[0]),
                                       dim=1).indices
                    pm = torch.zeros((q.shape[0], c.shape[0]),
                                     dtype=torch.bool, device=dev
                                     ).scatter(1, probe, True)
                    member = pm[:, torch.as_tensor(assign, device=dev)]
                if control == "int4_pool":
                    scale = (v.abs().amax(dim=0) / 7 if cents is not None
                             else torch.full((v.shape[1],), 1 / 7,
                                             dtype=dtype, device=dev))
                s, i = source_topk(q, v, member, k, pool, scale)
                cand_s.append(s)
                cand_r.append(gd[i])
            s_all, r_all = torch.cat(cand_s, 1), torch.cat(cand_r, 1)
            top = torch.topk(s_all, k, dim=1)
            out_s.append(top.values.double().cpu().numpy())
            out_r.append(torch.gather(r_all, 1, top.indices).cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return np.concatenate(out_s), np.concatenate(out_r)


def numbers(ctx, samples: list, control=None) -> dict:
    """``control`` (one of ``CONTROLS``) puts that control in the
    program's place."""
    k = int(ctx.mix["k"])
    qs = reference.query_vectors([s.text for s in samples], ctx.cfg)
    ref_s, ref_r = answers(ctx, qs)
    got = [s.answer for s in samples]
    if control:
        cs, cr = answers(ctx, qs, control)
        got = [[(chunk_id(int(r)), float(x)) for x, r in zip(cs[i], cr[i])]
               for i in range(len(samples))]
    ok = ctx.hist.vt == OPEN
    return reference.compare(ctx.hist, ctx.emb, qs, got,
                             [ok] * len(samples), ref_s, ref_r, k)


def context(hist, emb, rows, cfg: dict, mix: dict):
    ctx = types.SimpleNamespace(hist=hist, emb=emb, cfg=cfg, mix=mix)
    ctx.replica = Replica(hist, rows, cfg)
    return ctx
