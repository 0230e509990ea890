#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the serving path gives it, runs the temporal engine over a
quarter-million-row history, and drives ``LiveVectorLake`` end to end
(ingest on the host; current, point-in-time and window queries on the
card), holding every answer against the same store reopened on the CPU.

Phases (any failure stops the script with a non-zero exit):
  1. setup: card name and power limit, kernel build time;
  2. kernels vs plain versions, with times (kernel, plain, library) and
     the least time the card could take (bound);
  3. TemporalEngine on a >= 250k-row cold tier (5 commits) vs the CPU;
  4. LiveVectorLake on the paper's corpus (100 docs x 5 versions) at two
     hot-tier capacities: batch == sequential, CPU reopen equivalent,
     both kernels launched. Its launch counts are the "launches" below.
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
def phase_kernels(torch, dev) -> dict:
    from repro_torch.core.types import VALID_TO_OPEN
    from repro_torch.kernels.temporal_mask_score import ops as tops
    from repro_torch.kernels.temporal_mask_score.plain import (
        temporal_window_topk_plain)
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.kernels.topk_search.plain import topk_search_plain
    from repro_torch.testing import topk_agree

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"topk_search": {"err": 0.0, "times": []},
           "temporal_window_topk": {"err": 0.0, "times": []}}

    def hold(name, got, want, what):
        ok, err, why = topk_agree(got[0], got[1], want[0], want[1],
                                  score_atol=1e-4, gap=1e-5)
        check(ok, f"{name} {what}: {why}")
        out[name]["err"] = max(out[name]["err"], err)

    # -- topk_search: the hot tier's fused block (memtable 4096 + small
    #    segments), and a ragged N; 70% of rows alive
    for n in (8192, 8191):
        corpus = unit_rows(torch, gen, n, D, dev)
        alive = torch.rand(n, generator=gen, device=dev) < 0.7
        for nq in (2, 32, 256):
            q = unit_rows(torch, gen, nq, D, dev)
            for k in (5, 10, 64):
                hold("topk_search", kops.topk_search(q, corpus, alive, k),
                     topk_search_plain(q, corpus, alive, k),
                     f"N={n} Q={nq} k={k}")
            if n == 8192:
                k = 10
                t = cuda_ms(torch, lambda: kops.topk_search(
                    q, corpus, alive, k), 50)
                tp = cuda_ms(torch, lambda: topk_search_plain(
                    q, corpus, alive, k), 5, 1)
                tl = cuda_ms(torch, lambda: torch.topk(
                    torch.matmul(q, corpus.T).masked_fill(~alive, -math.inf),
                    k, dim=1), 50)
                # the work this data needs: alive rows only
                live = int(alive.sum())
                b, by = bound_ms(live * D * 4 + n + nq * D * 4, nq * k * 8,
                                 2 * nq * live * D)
                out["topk_search"]["times"].append(dict(
                    Q=nq, N=n, k=k, ms=t, plain_ms=tp, library_ms=tl,
                    bound_ms=b, bound_by=by))
    q = unit_rows(torch, gen, 4, D, dev)
    dead = torch.zeros(corpus.shape[0], dtype=torch.bool, device=dev)
    s, i = kops.topk_search(q, corpus, dead, 10)
    check(bool(torch.isneginf(s).all() and (i == -1).all()),
          "topk_search all-masked: not all (-inf, -1)")
    tiny = corpus[:7].contiguous()
    m = torch.tensor([1, 0, 1, 1, 1, 0, 1], dtype=torch.bool, device=dev)
    hold("topk_search", kops.topk_search(q, tiny, m, 7),
         topk_search_plain(q, tiny, m, 7), "k=N=7")

    # -- temporal_window_topk: a resident history of 2**20 rows (1.6 GB
    #    fp32) in five commits, each superseding 12.5% of the open rows
    n0, churn = 699_052, 87_381          # n0 + 4 * churn == 2**20
    n = n0 + 4 * churn
    t_commit = [1_700_000_000_000_000 + c * 30 * 24 * 3600 * 1_000_000
                for c in range(5)]
    vf = torch.empty(n, dtype=torch.int64, device=dev)
    vt = torch.full((n,), VALID_TO_OPEN, dtype=torch.int64, device=dev)
    vf[:n0] = t_commit[0]
    open_rows = torch.arange(n0, device=dev)
    for c in range(1, 5):
        pick = torch.randperm(open_rows.numel(), generator=gen,
                              device=dev)[:churn]
        closed = open_rows[pick]
        vt[closed] = t_commit[c]
        new = torch.arange(n0 + (c - 1) * churn, n0 + c * churn, device=dev)
        vf[new] = t_commit[c]
        keep = torch.ones(open_rows.numel(), dtype=torch.bool, device=dev)
        keep[pick] = False
        open_rows = torch.cat([open_rows[keep], new])
    vf_commit = vf.clone()                # windows are drawn from these
    invisible = torch.rand(n, generator=gen, device=dev) < 0.05
    vf = torch.where(invisible, VALID_TO_OPEN, vf)   # tenant pushdown rows
    hist = unit_rows(torch, gen, n, D, dev)
    torch.cuda.synchronize()
    rng = torch.Generator().manual_seed(SEED + 1)

    def windows(nq):
        """Point queries at each commit, at ts = vf and ts = vt - 1 of
        random closed rows, and mixed windows."""
        t0 = torch.empty(nq, dtype=torch.int64)
        t1 = torch.empty(nq, dtype=torch.int64)
        closed = torch.nonzero(vt != VALID_TO_OPEN).flatten().cpu()
        for qi in range(nq):
            kind = qi % 4
            if kind == 0:
                a = t_commit[qi // 4 % 5] + (qi // 20) % 2
                b = a + 1
            elif kind in (1, 2):
                r = int(closed[torch.randint(len(closed), (1,),
                                             generator=rng)])
                a = int(vf_commit[r]) if kind == 1 else int(vt[r]) - 1
                b = a + 1
            else:
                a = t_commit[0] + int(torch.randint(0, 3 * 10 ** 12, (1,),
                                                    generator=rng))
                b = a + int(torch.randint(1, 10 ** 13, (1,), generator=rng))
            t0[qi], t1[qi] = a, b
        return t0.to(dev), t1.to(dev)

    vf_h, vt_h = vf.cpu(), vt.cpu()
    for nq in (2, 32, 256):
        q = unit_rows(torch, gen, nq, D, dev)
        t0, t1 = windows(nq)
        for k in ((5, 10, 64) if nq == 32 else (10,)):
            got = tops.temporal_window_topk(q, hist, vf, vt, t0, t1, k)
            hold("temporal_window_topk", got,
                 temporal_window_topk_plain(q, hist, vf, vt, t0, t1, k),
                 f"N={n} Q={nq} k={k}")
            s, i = got[0].cpu(), got[1].cpu().long()
            for qi in range(nq):
                rows = i[qi][torch.isfinite(s[qi])]
                ok = bool(((vf_h[rows] < int(t1[qi]))
                           & (int(t0[qi]) < vt_h[rows])).all())
                check(ok, f"temporal_window_topk returned an out-of-window "
                          f"row (Q={nq} k={k} query {qi})")
        k = 10
        t = cuda_ms(torch, lambda: tops.temporal_window_topk(
            q, hist, vf, vt, t0, t1, k), 10)
        tp = cuda_ms(torch, lambda: temporal_window_topk_plain(
            q, hist, vf, vt, t0, t1, k), 2, 1)

        def library():
            valid = (vf[None, :] < t1[:, None]) & (t0[:, None] < vt[None, :])
            return torch.topk(torch.matmul(q, hist.T).masked_fill(
                ~valid, -math.inf), k, dim=1)
        tl = cuda_ms(torch, library, 5, 1)
        # the work this data needs: rows valid for some query are read,
        # (query, row) pairs in window are scored
        valid = (vf[None, :] < t1[:, None]) & (t0[:, None] < vt[None, :])
        pairs, rows_any = int(valid.sum()), int(valid.any(0).sum())
        del valid
        b, by = bound_ms(rows_any * D * 4 + 16 * n + nq * D * 4 + 16 * nq,
                         nq * k * 8, 2 * pairs * D)
        out["temporal_window_topk"]["times"].append(dict(
            Q=nq, N=n, k=k, ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
            bound_by=by))
    del hist
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

    gpu = TemporalEngine(cold, device="cuda")
    cpu = TemporalEngine(cold, device="cpu")
    q = rows(32)
    k = 10
    cases = ([("at", ts + dt) for ts in t_commit for dt in (0, 1)]
             + [("window", (t_commit[1], t_commit[3])),
                ("window", (t_commit[0] - 5, t_commit[0] + 1)),
                ("window", (t_commit[2] + 7, t_commit[4] + 9))])
    for kind, arg in cases:
        if kind == "at":
            got = gpu.query_at_batch(q, arg, k=k)
            want = cpu.query_at_batch(q, arg, k=k)
            ext = cpu.query_at_batch(q, arg, k=4 * k)
            for r in got:
                gpu.assert_no_leakage(r, arg)
        else:
            got = gpu.query_window_batch(q, *arg, k=k)
            want = cpu.query_window_batch(q, *arg, k=k)
            ext = cpu.query_window_batch(q, *arg, k=4 * k)
            for r in got:
                gpu.assert_no_window_leakage(r, *arg)
        for qi in range(len(q)):
            check(len(got[qi]) == k, f"engine {kind} {arg}: short result")
            check(results_equivalent(want[qi], got[qi], ext[qi],
                                     rtol=1e-5, atol=1e-5),
                  f"engine {kind} {arg} query {qi}: card != cpu")
    t = time.perf_counter()
    for _ in range(5):
        gpu.query_at_batch(q, t_commit[2], k=k)
    log(f"  engine: {len(cases)} query blocks of 32 held against the CPU "
        f"engine; query_at_batch(Q=32) "
        f"{(time.perf_counter() - t) / 5 * 1e3:.3f} ms on the host clock")


# ---------------------------------------------------------------------------
# phase 4: LiveVectorLake end to end
# ---------------------------------------------------------------------------
def phase_store(torch, workdir: str) -> dict:
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
    latency = {}
    kops.launches = 0
    tops.launches = 0
    for cap in (4096, 256):
        root = f"{workdir}/lake-{cap}"
        lake = LiveVectorLake(root, hot_capacity=cap, device="cuda")
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
        log(f"  hot_capacity={cap}: ingested {corpus.n_docs} docs x "
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
                check(res == seq, f"cap={cap} {name} batch={bs}: "
                                  f"query_batch != [query]")
            got[name] = lake.query_batch(texts, k=k, **kw)
            check(all(len(r) > 0 for r in got[name]),
                  f"cap={cap} {name}: empty result")
        del lake
        cpu = LiveVectorLake(root, hot_capacity=cap, device="cpu")
        for name, kw in mixes:
            want = cpu.query_batch(texts, k=k, **kw)
            ext = cpu.query_batch(texts, k=4 * k, **kw)
            for qi in range(len(texts)):
                check(results_equivalent(want[qi], got[name][qi], ext[qi],
                                         rtol=1e-5, atol=1e-5),
                      f"cap={cap} {name} query {qi}: card != cpu reopen")
        del cpu
    launches = {"topk_search": kops.launches,
                "temporal_window_topk": tops.launches}
    log(f"  launches on this path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched by LiveVectorLake")
    for (cap, name, bs), ms in sorted(latency.items()):
        if name in ("current", "at v2", "window v1-v3"):
            log(f"  query_batch cap={cap} {name} batch={bs}: "
                f"{ms[0]:.3f} ms on the host clock")
    return launches


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
        launches = phase_store(torch, work)

    replaces = {
        "topk_search": ("src/repro_torch/csrc/topk_search.cu",
                        "src/repro/kernels/topk_search/topk_search.py:25"),
        "temporal_window_topk": (
            "src/repro_torch/csrc/temporal_mask_score.cu",
            "src/repro/kernels/temporal_mask_score/"
            "temporal_mask_score.py:37"),
    }
    rows = []
    for name, (source, tpu) in replaces.items():
        at = next(r for r in kern[name]["times"] if r["Q"] == 32)
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
