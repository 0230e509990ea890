#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel (fp32 and int8) against its plain PyTorch version on
the card at the shapes the serving path gives it, runs the temporal
engine over a quarter-million-row history, and drives ``LiveVectorLake``
end to end, fp32 and quantized (ingest on the host; current,
point-in-time and window queries on the card), holding every answer
against the same store reopened on the CPU.

Phases (any failure stops the script with a non-zero exit):
  1. setup: card name and power limit, kernel build time;
  2. kernels vs plain versions, with times (kernel, plain, library) and
     the least time the card could take (bound);
  3. TemporalEngine, fp32 and int8, on a >= 250k-row cold tier (5
     commits) vs the CPU; the int8 engine also by recall@10 vs fp32;
  4. LiveVectorLake on the paper's corpus (100 docs x 5 versions) at two
     hot-tier capacities, fp32 then quantized: batch == sequential, CPU
     reopen equivalent, no out-of-window id, both kernels of the path
     launched at each capacity; the quantized store also by recall@10
     vs the fp32 one. Its launch counts are the "launches" below.
It prints a ``{"kernels": [...]}`` line, then, last, the one-line
``{"ok": true, "device": {...}}`` result. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
Imports no JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
D = 384                    # all-MiniLM-L6-v2 width, the paper's embedder
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
SEED = 0
T_COMMIT = [1_700_000_000_000_000 + c * 30 * 24 * 3600 * 1_000_000
            for c in range(5)]
# kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "topk_search": ("src/repro_torch/csrc/topk_search.cu",
                    "src/repro/kernels/topk_search/topk_search.py:25"),
    "temporal_window_topk": (
        "src/repro_torch/csrc/temporal_mask_score.cu",
        "src/repro/kernels/temporal_mask_score/temporal_mask_score.py:37"),
    "topk_search_q8": ("src/repro_torch/csrc/topk_search.cu",
                       "src/repro/kernels/topk_search/topk_search.py:54"),
    "temporal_window_topk_q8": (
        "src/repro_torch/csrc/temporal_mask_score.cu",
        "src/repro/kernels/temporal_mask_score/temporal_mask_score.py:74"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(in_bytes: int, out_bytes: int, flops: int) -> tuple[float, str]:
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def unit_rows(torch, gen, n: int, d: int, dev):
    x = torch.randn((n, d), generator=gen, device=dev, dtype=torch.float32)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def history(torch, gen, dev, n0: int, churn: int):
    """Validity columns of a resident history of n0 + 4 * churn rows in
    five commits, each closing `churn` random open rows and appending as
    many (the paper's five time points, 12.5% re-processed), with 5% of
    rows tenant-invisible (valid_from = VALID_TO_OPEN). Returns (vf, vt,
    vf_commit): vf_commit is valid_from before the tenant pushdown."""
    from repro_torch.core.types import VALID_TO_OPEN

    n = n0 + 4 * churn
    vf = torch.empty(n, dtype=torch.int64, device=dev)
    vt = torch.full((n,), VALID_TO_OPEN, dtype=torch.int64, device=dev)
    vf[:n0] = T_COMMIT[0]
    open_rows = torch.arange(n0, device=dev)
    for c in range(1, 5):
        pick = torch.randperm(open_rows.numel(), generator=gen,
                              device=dev)[:churn]
        closed = open_rows[pick]
        vt[closed] = T_COMMIT[c]
        new = torch.arange(n0 + (c - 1) * churn, n0 + c * churn, device=dev)
        vf[new] = T_COMMIT[c]
        keep = torch.ones(open_rows.numel(), dtype=torch.bool, device=dev)
        keep[pick] = False
        open_rows = torch.cat([open_rows[keep], new])
    invisible = torch.rand(n, generator=gen, device=dev) < 0.05
    return torch.where(invisible, VALID_TO_OPEN, vf), vt, vf


def phase_kernels(torch, dev) -> dict:
    from repro_torch.core.types import VALID_TO_OPEN
    from repro_torch.index.quant import Q8_MAX, fixed_scale
    from repro_torch.kernels.temporal_mask_score import ops as tops
    from repro_torch.kernels.temporal_mask_score.plain import (
        temporal_window_topk_plain, temporal_window_topk_q8_plain)
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.kernels.topk_search.plain import (topk_search_plain,
                                                       topk_search_q8_plain)
    from repro_torch.testing import topk_agree

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {name: {"err": 0.0, "times": []} for name in KERNELS}
    # the fixed 1/127 scale of the store's fused block and resident
    # history; rows are quantized as index/quant.quantize_rows does
    scale = torch.from_numpy(fixed_scale(D)).to(dev)

    def quantize(x):
        return torch.clamp(torch.round(x / scale), -Q8_MAX,
                           Q8_MAX).to(torch.int8)

    def hold(name, got, want, what):
        # want: the plain version at k + 1, its last entry read only as
        # the neighbour that tells a near-tie at the k-th slot
        ok, err, why = topk_agree(got[0], got[1], want[0], want[1],
                                  score_atol=1e-4, gap=1e-5)
        check(ok, f"{name} {what}: {why}")
        out[name]["err"] = max(out[name]["err"], err)

    def timed(name, n, nq, k, fn, plain, library, in_bytes, flops,
              iters=50, plain_iters=5):
        t = cuda_ms(torch, fn, iters)
        tp = cuda_ms(torch, plain, plain_iters, 1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, nq * k * 8, flops)
        out[name]["times"].append(dict(
            Q=nq, N=n, k=k, ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
            bound_by=by))

    # -- topk_search and topk_search_q8: the hot tier's fused block
    #    (memtable 4096 + small segments), and a ragged N; 70% of rows
    #    alive. The q8 scan fetches the rescore pool: k' = 4 * 10 = 40,
    #    and 128 for the deeper list.
    for n in (8192, 8191):
        corpus = unit_rows(torch, gen, n, D, dev)
        c8 = quantize(corpus)
        alive = torch.rand(n, generator=gen, device=dev) < 0.7
        live = int(alive.sum())
        for nq in (2, 32, 256):
            q = unit_rows(torch, gen, nq, D, dev)
            for k in (5, 10, 64, 128):
                hold("topk_search", kops.topk_search(q, corpus, alive, k),
                     topk_search_plain(q, corpus, alive, k + 1),
                     f"N={n} Q={nq} k={k}")
            for k in (40, 128):
                hold("topk_search_q8",
                     kops.topk_search_q8(q, c8, scale, alive, k),
                     topk_search_q8_plain(q, c8, scale, alive, k + 1),
                     f"N={n} Q={nq} k={k}")
            if n != 8192:
                continue
            # the work this data needs: alive rows only
            k = 10
            timed("topk_search", n, nq, k,
                  lambda: kops.topk_search(q, corpus, alive, k),
                  lambda: topk_search_plain(q, corpus, alive, k),
                  lambda: torch.topk(torch.matmul(q, corpus.T).masked_fill(
                      ~alive, -math.inf), k, dim=1),
                  live * D * 4 + n + nq * D * 4, 2 * nq * live * D)
            kp = 40
            timed("topk_search_q8", n, nq, kp,
                  lambda: kops.topk_search_q8(q, c8, scale, alive, kp),
                  lambda: topk_search_q8_plain(q, c8, scale, alive, kp),
                  lambda: torch.topk(torch.matmul(
                      q * scale, c8.float().T).masked_fill(
                      ~alive, -math.inf), kp, dim=1),
                  live * D + n + nq * D * 4 + D * 4, 2 * nq * live * D)
    q = unit_rows(torch, gen, 4, D, dev)
    dead = torch.zeros(corpus.shape[0], dtype=torch.bool, device=dev)
    for s, i in (kops.topk_search(q, corpus, dead, 10),
                 kops.topk_search_q8(q, c8, scale, dead, 40)):
        check(bool(torch.isneginf(s).all() and (i == -1).all()),
              "top-k all-masked: not all (-inf, -1)")
    tiny = corpus[:7].contiguous()
    m = torch.tensor([1, 0, 1, 1, 1, 0, 1], dtype=torch.bool, device=dev)
    hold("topk_search", kops.topk_search(q, tiny, m, 7),
         topk_search_plain(q, tiny, m, 8), "k=N=7")
    tiny8 = c8[:7].contiguous()
    hold("topk_search_q8", kops.topk_search_q8(q, tiny8, scale, m, 7),
         topk_search_q8_plain(q, tiny8, scale, m, 8), "k=N=7")
    del corpus, c8

    # -- temporal_window_topk(_q8): a resident history in five commits.
    #    2**20 rows: fp32 (1.6 GB) and the same rows in int8 (403 MB);
    #    2**22 rows in int8: the fp32 run's 1.6 GB.
    rng = torch.Generator().manual_seed(SEED + 1)

    def windows(nq, vf_commit, vt):
        """Point queries at each commit, at ts = vf and ts = vt - 1 of
        random closed rows, and mixed windows."""
        t0 = torch.empty(nq, dtype=torch.int64)
        t1 = torch.empty(nq, dtype=torch.int64)
        closed = torch.nonzero(vt != VALID_TO_OPEN).flatten().cpu()
        for qi in range(nq):
            kind = qi % 4
            if kind == 0:
                a = T_COMMIT[qi // 4 % 5] + (qi // 20) % 2
                b = a + 1
            elif kind in (1, 2):
                r = int(closed[torch.randint(len(closed), (1,),
                                             generator=rng)])
                a = int(vf_commit[r]) if kind == 1 else int(vt[r]) - 1
                b = a + 1
            else:
                a = T_COMMIT[0] + int(torch.randint(0, 3 * 10 ** 12, (1,),
                                                    generator=rng))
                b = a + int(torch.randint(1, 10 ** 13, (1,), generator=rng))
            t0[qi], t1[qi] = a, b
        return t0.to(dev), t1.to(dev)

    def in_window(name, got, vf_h, vt_h, t0, t1, what):
        s, i = got[0].cpu(), got[1].cpu().long()
        for qi in range(s.shape[0]):
            rows = i[qi][torch.isfinite(s[qi])]
            ok = bool(((vf_h[rows] < int(t1[qi]))
                       & (int(t0[qi]) < vt_h[rows])).all())
            check(ok, f"{name} returned an out-of-window row ({what} "
                      f"query {qi})")

    for n0, churn, fp32 in ((699_052, 87_381, True),
                            (2_796_204, 349_525, False)):
        vf, vt, vf_commit = history(torch, gen, dev, n0, churn)
        n = vf.numel()
        hist = unit_rows(torch, gen, n, D, dev) if fp32 else None
        c8 = torch.empty((n, D), dtype=torch.int8, device=dev)
        for lo in range(0, n, 1 << 20):                 # 1.6 GB of f32 a step
            hi = min(n, lo + (1 << 20))
            c8[lo:hi] = quantize(hist[lo:hi] if fp32 else
                                 unit_rows(torch, gen, hi - lo, D, dev))
        torch.cuda.synchronize()
        vf_h, vt_h = vf.cpu(), vt.cpu()
        for nq in (2, 32, 256):
            q = unit_rows(torch, gen, nq, D, dev)
            t0, t1 = windows(nq, vf_commit, vt)
            ks = (5, 10, 64, 128) if nq == 32 else (10,)
            for k in ks if fp32 else ():
                what = f"N={n} Q={nq} k={k}"
                got = tops.temporal_window_topk(q, hist, vf, vt, t0, t1, k)
                hold("temporal_window_topk", got, temporal_window_topk_plain(
                    q, hist, vf, vt, t0, t1, k + 1), what)
                in_window("temporal_window_topk", got, vf_h, vt_h, t0, t1,
                          what)
            for k in (40, 128):
                what = f"N={n} Q={nq} k={k}"
                got = tops.temporal_window_topk_q8(q, c8, scale, vf, vt, t0,
                                                   t1, k)
                hold("temporal_window_topk_q8", got,
                     temporal_window_topk_q8_plain(q, c8, scale, vf, vt, t0,
                                                   t1, k + 1), what)
                in_window("temporal_window_topk_q8", got, vf_h, vt_h, t0, t1,
                          what)
            # the work this data needs: rows valid for some query are read,
            # (query, row) pairs in window are scored
            valid = (vf[None, :] < t1[:, None]) & (t0[:, None] < vt[None, :])
            pairs, rows_any = int(valid.sum()), int(valid.any(0).sum())
            del valid

            def library(corpus, qq, k):
                ok = (vf[None, :] < t1[:, None]) & (t0[:, None] < vt[None, :])
                return torch.topk(torch.matmul(qq, corpus.T).masked_fill(
                    ~ok, -math.inf), k, dim=1)

            if fp32:
                k = 10
                timed("temporal_window_topk", n, nq, k,
                      lambda: tops.temporal_window_topk(q, hist, vf, vt, t0,
                                                        t1, k),
                      lambda: temporal_window_topk_plain(q, hist, vf, vt, t0,
                                                         t1, k),
                      lambda: library(hist, q, k),
                      rows_any * D * 4 + 16 * n + nq * D * 4 + 16 * nq,
                      2 * pairs * D, iters=10, plain_iters=2)
            kp = 40
            timed("temporal_window_topk_q8", n, nq, kp,
                  lambda: tops.temporal_window_topk_q8(q, c8, scale, vf, vt,
                                                       t0, t1, kp),
                  lambda: temporal_window_topk_q8_plain(q, c8, scale, vf, vt,
                                                        t0, t1, kp),
                  lambda: library(c8.float(), q * scale, kp),
                  rows_any * D + 16 * n + nq * D * 4 + 16 * nq + D * 4,
                  2 * pairs * D, iters=10, plain_iters=2)
        del hist, c8
        torch.cuda.empty_cache()
    for name, r in out.items():
        for row in r["times"]:
            log(f"  {name}: " + " ".join(
                f"{key}={val:.4f}" if isinstance(val, float) else
                f"{key}={val}" for key, val in row.items()))
        log(f"  {name}: max_abs_err={r['err']:.3g}")
    return out


# ---------------------------------------------------------------------------
# phase 3: the temporal engine over a quarter-million-row cold tier
# ---------------------------------------------------------------------------
def phase_engine(torch, workdir: str) -> None:
    import numpy as np

    from repro_torch.core.cold_tier import ColdTier
    from repro_torch.core.temporal import TemporalEngine
    from repro_torch.core.types import ChunkRecord
    from repro_torch.testing import results_equivalent

    rng = np.random.default_rng(SEED)
    n0, per_doc = 170_000, 25
    churn = n0 // 8
    t_commit = [1_700_000_000_000_000 + c * 86_400_000_000
                for c in range(5)]
    cold = ColdTier(f"{workdir}/cold", D, checkpoint_interval=0)

    def rows(m):
        x = rng.standard_normal((m, D), dtype=np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    keys = [(f"doc{i // per_doc:05d}", i % per_doc) for i in range(n0)]
    uid = 0
    t = time.perf_counter()
    for c, ts in enumerate(t_commit):
        if c == 0:
            chosen = keys
            closures = []
        else:
            pick = rng.choice(len(keys), churn, replace=False)
            chosen = [keys[j] for j in pick]
            closures = [{"doc_id": d, "position": p, "closed_at": ts,
                         "status": "superseded"} for d, p in chosen]
        emb = rows(len(chosen))
        recs = []
        for j, (d, p) in enumerate(chosen):
            recs.append(ChunkRecord(
                chunk_id=f"{uid:012x}", doc_id=d, position=p, valid_from=ts,
                text=f"{d}:{p}:v{c}", embedding=emb[j]))
            uid += 1
        cold.commit(recs, closures, ts)
    log(f"  cold tier: {uid} history rows in 5 commits, "
        f"{time.perf_counter() - t:.1f} s to build")
    check(uid >= 250_000, "cold tier holds fewer than 250k rows")

    q = rows(32)
    k = 10
    cases = ([("at", ts + dt) for ts in t_commit for dt in (0, 1)]
             + [("window", (t_commit[1], t_commit[3])),
                ("window", (t_commit[0] - 5, t_commit[0] + 1)),
                ("window", (t_commit[2] + 7, t_commit[4] + 9))])

    def run(engine, kind, arg, kk):
        if kind == "at":
            return engine.query_at_batch(q, arg, k=kk)
        return engine.query_window_batch(q, *arg, k=kk)

    # fp32, then int8: the quantized engine's history is int8 on the card
    # and its pools are rescored in fp32 from a spill beside the cold tier
    # (one file, which the CPU engine rewrites with the same rows)
    fp32_got = {}
    for quantized in (False, True):
        what = "quantized engine" if quantized else "engine"
        gpu = TemporalEngine(cold, quantized=quantized, device="cuda")
        cpu = TemporalEngine(cold, quantized=quantized, device="cpu")
        hits = 0
        for kind, arg in cases:
            got = run(gpu, kind, arg, k)
            want = run(cpu, kind, arg, k)
            ext = run(cpu, kind, arg, 4 * k)
            for r in got:
                if kind == "at":
                    gpu.assert_no_leakage(r, arg)
                else:
                    gpu.assert_no_window_leakage(r, *arg)
            for qi in range(len(q)):
                check(len(got[qi]) == k, f"{what} {kind} {arg}: short result")
                check(results_equivalent(want[qi], got[qi], ext[qi],
                                         rtol=1e-5, atol=1e-5),
                      f"{what} {kind} {arg} query {qi}: card != cpu")
            if not quantized:
                fp32_got[kind, arg] = got
                continue
            for a, b in zip(fp32_got[kind, arg], got):
                hits += len({r.chunk_id for r in a} & {r.chunk_id for r in b})
        t = time.perf_counter()
        for _ in range(5):
            gpu.query_at_batch(q, t_commit[2], k=k)
        log(f"  {what}: {len(cases)} query blocks of 32 held against the "
            f"CPU engine; query_at_batch(Q=32) "
            f"{(time.perf_counter() - t) / 5 * 1e3:.3f} ms on the host clock")
        if quantized:
            recall = hits / (len(cases) * len(q) * k)
            log(f"  {what}: recall@10 against the fp32 engine {recall:.4f}")
            check(recall >= 0.99, f"{what}: recall@10 {recall} < 0.99")
        del gpu, cpu


# ---------------------------------------------------------------------------
# phase 4: LiveVectorLake end to end
# ---------------------------------------------------------------------------
def phase_store(torch, workdir: str, quantized: bool,
                fp32_answers: dict | None = None) -> tuple[dict, dict]:
    """Drive fp32 or quantized stores at two hot-tier capacities, with the
    launch counts of that path's kernels set to 0 before and read after.
    A quantized run is also held to ``fp32_answers`` (the fp32 run's) by
    recall@10. Returns (launches, answers)."""
    from repro_torch.core.store import LiveVectorLake
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.kernels.temporal_mask_score import ops as tops
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.testing import results_equivalent

    corpus = generate_corpus(n_docs=100, n_versions=5)
    ts = corpus.timestamps
    texts = []
    for f in corpus.facts[:40]:
        texts.append(f"{f.name} equals units")
    texts += [f"{t} policy requires review" for t in
              ("security", "billing", "network", "storage", "compliance",
               "deployment", "monitoring", "identity", "backup", "capacity")]
    mixes = ([("current", {})]
             + [(f"at v{v}", {"at": t + 1}) for v, t in enumerate(ts)]
             + [("window v1-v3", {"window": (ts[1], ts[3])}),
                ("window v0-v4", {"window": (ts[0], ts[4] + 1)})])
    k = 10
    mode = "quantized" if quantized else "fp32"
    latency = {}
    answers = {}

    def counts() -> dict:
        if quantized:
            return {"topk_search_q8": kops.launches_q8,
                    "temporal_window_topk_q8": tops.launches_q8}
        return {"topk_search": kops.launches,
                "temporal_window_topk": tops.launches}

    kops.launches = kops.launches_q8 = 0
    tops.launches = tops.launches_q8 = 0
    for cap in (4096, 256):
        before = counts()
        root = f"{workdir}/lake-{mode}-{cap}"
        lake = LiveVectorLake(root, hot_capacity=cap, quantized=quantized,
                              device="cuda")
        t = time.perf_counter()
        for v, t_v in enumerate(ts):
            for doc in corpus.doc_ids():
                lake.ingest(doc, corpus.versions[v][doc], ts=t_v)
            # query between versions, so the later ingests land in a
            # resident fused block and a resident history (device
            # mirrors of memtable writes and of valid_to closures)
            lake.query_batch(texts[:8], k=k)
            lake.query_batch(texts[:8], k=k, at=t_v)
        t = time.perf_counter() - t
        st = lake.hot.index.stats()
        log(f"  {mode} hot_capacity={cap}: ingested {corpus.n_docs} docs x "
            f"{len(ts)} versions in {t:.1f} s; "
            f"{len(lake.hot)} live chunks, {st['segments']} segments "
            f"({st['partitioned_segments']} IVF), {st['tombstones']} "
            f"tombstones, {st['seals']} seals, {st['merges']} merges; "
            f"{lake.temporal._resident_history().n} history rows")
        if cap == 256:
            check(st["seals"] > 0 and st["partitioned_segments"] > 0
                  and st["tombstones"] > 0,
                  "small hot tier did not seal into IVF segments with "
                  "tombstones")
        got = {}
        for name, kw in mixes:
            for bs in (1, 8, 32):
                batch = texts[:bs]
                t = time.perf_counter()
                res = lake.query_batch(batch, k=k, **kw)
                latency.setdefault((cap, name, bs), []).append(
                    (time.perf_counter() - t) * 1e3)
                seq = [lake.query(x, k=k, **kw) for x in batch]
                check(res == seq, f"{mode} cap={cap} {name} batch={bs}: "
                                  f"query_batch != [query]")
            got[name] = lake.query_batch(texts, k=k, **kw)
            check(all(len(r) > 0 for r in got[name]),
                  f"{mode} cap={cap} {name}: empty result")
            for r in got[name]:                    # no out-of-window id
                if "at" in kw:
                    lake.temporal.assert_no_leakage(r, kw["at"])
                elif "window" in kw:
                    lake.temporal.assert_no_window_leakage(r, *kw["window"])
        answers[cap] = got
        for name, n in counts().items():
            check(n > before[name], f"{mode} cap={cap}: {name} was never "
                                    f"launched by LiveVectorLake")
        del lake
        cpu = LiveVectorLake(root, hot_capacity=cap, device="cpu")
        check(cpu.quantized == quantized, "STORE.json lost the format")
        for name, kw in mixes:
            want = cpu.query_batch(texts, k=k, **kw)
            ext = cpu.query_batch(texts, k=4 * k, **kw)
            for qi in range(len(texts)):
                check(results_equivalent(want[qi], got[name][qi], ext[qi],
                                         rtol=1e-5, atol=1e-5),
                      f"{mode} cap={cap} {name} query {qi}: card != cpu "
                      f"reopen")
        del cpu
        if fp32_answers is not None:
            hits = total = 0
            for name, _ in mixes:
                for a, b in zip(fp32_answers[cap][name], got[name]):
                    ids = {r.chunk_id for r in a}
                    hits += len(ids & {r.chunk_id for r in b})
                    total += len(ids)
            log(f"  {mode} cap={cap}: recall@10 against the fp32 store "
                f"{hits / total:.4f}")
            check(hits / total >= 0.99,
                  f"{mode} cap={cap}: recall@10 {hits / total} < 0.99")
    launches = counts()
    others = (kops.launches + kops.launches_q8 + tops.launches
              + tops.launches_q8 - sum(launches.values()))
    log(f"  launches on the {mode} path: {launches} (other kernels: "
        f"{others})")
    for (cap, name, bs), ms in sorted(latency.items()):
        if name in ("current", "at v2", "window v1-v3"):
            log(f"  {mode} query_batch cap={cap} {name} batch={bs}: "
                f"{ms[0]:.3f} ms on the host clock")
    return launches, answers


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "build.py").is_file():
        print(f"chip_smoke: the port is not at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    log("phase 1: setup")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library: fp32
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    build.build()
    for name in build.sources():
        build.load(name)
    log(f"  built {build.sources()} in {time.perf_counter() - t:.1f} s")

    log("phase 2: kernels against their plain versions")
    kern = phase_kernels(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        log("phase 3: temporal engine at scale")
        phase_engine(torch, work)
        log("phase 4: LiveVectorLake end to end")
        launches, fp32_answers = phase_store(torch, work, quantized=False)
        launches_q8, _ = phase_store(torch, work, quantized=True,
                                     fp32_answers=fp32_answers)
    launches.update(launches_q8)

    rows = []
    for name, (source, tpu) in KERNELS.items():
        at = next(r for r in kern[name]["times"]
                  if r["Q"] == 32 and r["N"] in (8192, 1 << 20))
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": kern[name]["err"], "ms": at["ms"],
                     "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                     "bound_by": at["bound_by"],
                     "library_ms": at["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
