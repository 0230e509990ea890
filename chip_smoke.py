#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU
    python3 chip_smoke.py --parent DIR   # also hold the top-k scans
                                         # against DIR's kernels

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the serving path gives it, runs the temporal engine over a
quarter-million-row history, drives ``LiveVectorLake`` end to end, fp32
and quantized, then the paper's RAG path: the MiniLM embedder at full
width embedding the paper's corpus into stores on the card, and a
Mistral-NeMo-12B generator at full width (seeded random weights)
answering requests grounded in them; last, the recsys family (DLRM at
MLPerf widths, FM, Wide&Deep, BERT4Rec) serving on the card.

Phases (any failure stops the script with a non-zero exit):
  1. setup: card name and power limit, kernel build time, and ptxas's
     registers, shared memory and spills of the attention kernels'
     tensor-core and split-decode instances and of the top-k scans'
     list, key and select kernels;
  2. kernels vs plain versions, with times (kernel, plain, library) and
     the least time the card could take (bound): the four top-k scans
     (k up to 128 on their register lists, k in {129, 500, 4096} on
     their radix-select path, whose k = 500 rows also split the device
     time into score, select, gather and order by CUDA events; with
     ``--parent``, every scan call is also held bit for bit against an
     earlier checkout's kernels, which are timed beside), flash
     attention (the MiniLM encoder, Mistral-NeMo prefill at 256 and
     4096 tokens), split-K decode (the engine's
     cache; decode_32k, 16 x 32768, at full and partial length; its
     partials at bs 512 against the plain partials, its in-library merge
     against merge_partials of the partials at the split it chose) and the
     embedding bag (DLRM's table 0, 25M x 128 fp32, at B 512 and
     262,144, L = 1, bit for bit; table 20 at B 4096, L = 100, fp32 and
     bf16, sum and mean);
  3. TemporalEngine, fp32 and int8, on a >= 250k-row cold tier (5
     commits) vs the CPU; the int8 engine also by recall@10 vs fp32;
  4. LiveVectorLake on the paper's corpus (100 docs x 5 versions) at two
     hot-tier capacities, fp32 then quantized: batch == sequential, CPU
     reopen equivalent, no out-of-window id, both kernels of the path
     launched at each capacity; the quantized store also by recall@10
     vs the fp32 one. Its launch counts are the top-k kernels'
     "launches" below;
  5. the MiniLM embedder (6L, d 384, fp32): bulk encode at the
     encode_corpus shape (4096 x 128) and encode_query (16 x 64), card
     vs CPU on 64 texts with the same weights; then the paper's corpus
     ingested into an fp32 and a quantized store that embed with it:
     CURRENT / HISTORICAL / COMPARATIVE ``query_batch`` at batch 1, 8,
     32 and k 10, 50 (a quantized pool of 200: the select path), batch ==
     sequential bit for bit, no out-of-window id, CPU reopen (CPU
     embedder, same weights) equivalent;
  6. RAG generation: Mistral-NeMo-12B at full width (40L, d 5120, bf16,
     ~24.5 GB made on the card) behind ``RAGEngine`` over the phase-5
     fp32 store answers 8 requests (4 current, 4 as-of), 16 new tokens
     each; retrieved contexts equal ``store.query``, ids in range. Phases
     5-6 (store and generation) are the attention kernels' main path:
     their "launches" below. Warm prefill and decode-step times, and one
     request under the profiler (device busy share, the attention
     kernels' device time). Then a decode-vs-prefill cross-check at full
     width, fp32, 4 layers: prefill 256 tokens + decode 128 against one
     prefill of 384 (logits within 1e-3 of their max abs, same argmax);
  7. recsys serving at full width, after phase 6 has freed the generator:
     DLRM at MLPerf widths over its 26 tables capped at 25M rows (58.3 GB
     fp32, seeded, made on the card) at serve_p99 (512) and serve_bulk
     (262,144): logits with the kernel bags equal those with the plain
     bags bit for bit, and the CPU forward over the batch's rows within
     1e-4 of their max; FM and Wide&Deep (39M and 40M ids) at both
     shapes and BERT4Rec at serve_p99 (flash_attention, D = 32), card vs
     CPU; retrieval_cand (1 x 1,000,448, k = 100) for the four through
     topk_search, held to the plain masked top-k. Its DLRM forwards are
     the embedding bag's "launches" below (26 a forward).
It prints a ``{"kernels": [...]}`` line, then, last, the one-line
``{"ok": true, "device": {...}}`` result. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
Imports no JAX.
"""
from __future__ import annotations

import ctypes
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
BF16_FLOPS = 989e12        # H100 SXM bf16 dense on the tensor cores
BIG_K = (129, 500, 4096)   # k above the register lists: the select path
# a Mistral-NeMo-12B decode step on the CUDA-core attention kernels with
# the split merge in torch (H100 80GB HBM3, 700 W), for comparison
DECODE_STEP_BEFORE_MS = "48.7-67.0"
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
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:27"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/flash_decode.py:25"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/embedding_bag.py:20"),
}
TILE_KERNELS = ("topk_search", "temporal_window_topk", "topk_search_q8",
                "temporal_window_topk_q8")


# (source, kernel) whose registers, shared memory and spills phase 1 logs
PTXAS_REPORT = (("flash_attention", "fa_wgmma_kernel"),
                ("flash_decode", "decode_partials_kernel"),
                ("flash_decode", "decode_merge_kernel"),
                ("topk_search", "topk_list_kernel"),
                ("topk_search", "topk_key_kernel"),
                ("temporal_mask_score", "topk_list_kernel"),
                ("temporal_mask_score", "topk_key_kernel"),
                ("topk_search", "select_hist_kernel"),
                ("topk_search", "select_digit_kernel"),
                ("topk_search", "select_above_kernel"),
                ("topk_search", "select_ties_kernel"),
                ("topk_search", "select_order_kernel"))


def ptxas_lines(log_text: str, kernel: str) -> list[str]:
    """One line per compiled instance of ``kernel`` in nvcc's ``-Xptxas
    -v`` output: its template arguments (as mangled), registers, static
    shared memory, stack and spills."""
    out, entry, frame = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            entry = name if kernel in name else None
        elif entry and "bytes stack frame" in line:
            frame = line.strip()
        elif entry and "Used" in line and "registers" in line:
            args = entry.split(kernel, 1)[1].split("EEv")[0]
            out.append(f"{kernel}<{args}>: "
                       f"{line.split('info    :')[-1].strip()}; {frame}")
            entry = None
    return out


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


def bound_ms(in_bytes: int, out_bytes: int, flops: int,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class ParentScans:
    """The four top-k scans of another checkout (``--parent``), whose
    csrc/topk_tile.cuh has the candidate-list interface: entries taking
    (inputs, out_s, out_i, Q, N, D, k, grid_x, q_begin, q_count, stream),
    ``topk_tile_grid_x(N, Q, sms, k)`` and ``topk_tile_list_len(k)``.
    Built with this checkout's nvcc flags into build/repro_torch/parent,
    launched in chunks of 2^25 candidates and merged with one stable sort
    as that checkout's kernels/common.py does. Called like the wrappers:
    ``parent(name, *args)``."""

    ENTRIES = {"topk_search": ("topk_search", "topk_search_f32"),
               "topk_search_q8": ("topk_search", "topk_search_q8"),
               "temporal_window_topk": ("temporal_mask_score",
                                        "temporal_window_topk_f32"),
               "temporal_window_topk_q8": ("temporal_mask_score",
                                           "temporal_window_topk_q8")}
    BUDGET = 1 << 25

    def __init__(self, torch, root: str):
        from repro_torch.kernels import build

        self.torch = torch
        out = build.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in ("topk_search", "temporal_mask_score"):
            so = out / f"lib{name}.so"
            src = Path(root) / "src" / "repro_torch" / "csrc" / f"{name}.cu"
            procs.append((name, so, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        self.libs = {}
        for name, so, proc in procs:
            text = proc.communicate()[0]
            check(proc.returncode == 0, f"parent {name}.cu: nvcc failed\n"
                                        f"{text}")
            lib = ctypes.CDLL(str(so))
            lib.topk_tile_grid_x.argtypes = [ctypes.c_longlong] * 4
            lib.topk_tile_grid_x.restype = ctypes.c_longlong
            lib.topk_tile_list_len.argtypes = [ctypes.c_longlong]
            lib.topk_tile_list_len.restype = ctypes.c_longlong
            self.libs[name] = lib
        for src, entry in self.ENTRIES.values():
            n_in = 3 if src == "topk_search" else 6
            fn = getattr(self.libs[src], entry)
            fn.argtypes = ([ctypes.c_void_p] * (n_in + 2)
                           + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

    def __call__(self, name: str, *args):
        from repro_torch.kernels.common import merge_candidates

        torch = self.torch
        q = torch.atleast_2d(args[0])
        corpus, k = args[1], args[-1]
        if name.endswith("_q8"):
            q = q * args[2]
            args = args[:2] + args[3:]
        nq, (n, d) = q.shape[0], corpus.shape
        inputs = [q, corpus] + [
            torch.broadcast_to(t, (nq,)).contiguous() if i >= 2 else t
            for i, t in enumerate(args[2:-1])]
        k = min(k, n)
        src, entry = self.ENTRIES[name]
        lib = self.libs[src]
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        gx = int(lib.topk_tile_grid_x(n, nq, sms, k))
        kk = int(lib.topk_tile_list_len(k))
        step = max(1, self.BUDGET // (gx * kk))
        if step < nq and step >= 32:
            step = step // 32 * 32
        stream = torch.cuda.current_stream(q.device).cuda_stream
        outs = []
        for q_begin in range(0, nq, step):
            qc = min(step, nq - q_begin)
            cs = torch.empty((gx, qc, kk), dtype=torch.float32,
                             device=q.device)
            ci = torch.empty((gx, qc, kk), dtype=torch.int32,
                             device=q.device)
            err = getattr(lib, entry)(*[t.data_ptr() for t in inputs],
                                      cs.data_ptr(), ci.data_ptr(), nq, n,
                                      d, k, gx, q_begin, qc, stream)
            check(err == 0, f"parent {entry}: CUDA error {err}")
            outs.append(merge_candidates(cs, ci, k))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))


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


def phase_kernels(torch, dev, parent=None) -> dict:
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
    out = {name: {"err": 0.0, "times": []} for name in TILE_KERNELS}
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

    ops = {"topk_search": kops.topk_search,
           "topk_search_q8": kops.topk_search_q8,
           "temporal_window_topk": tops.temporal_window_topk,
           "temporal_window_topk_q8": tops.temporal_window_topk_q8}
    libs = {"topk_search": kops._lib, "topk_search_q8": kops._lib,
            "temporal_window_topk": tops._lib,
            "temporal_window_topk_q8": tops._lib}
    held = {"parent": 0}

    def run(name, *args):
        """The kernel's answer; with ``parent``, also held bit for bit
        against the parent checkout's kernels on the same inputs."""
        got = ops[name](*args)
        if parent is not None:
            want = parent(name, *args)
            check(torch.equal(got[0].view(torch.int32),
                              want[0].view(torch.int32))
                  and torch.equal(got[1], want[1]),
                  f"{name} Q={got[0].shape[0]} k={got[0].shape[1]}: "
                  f"differs from the parent's kernels")
            held["parent"] += 1
        return got

    def split(name, args, reps=5):
        """Device ms of the select path's score, select, gather and order
        steps (CUDA events in the library), mean of ``reps`` calls."""
        lib = libs[name]()
        lib.topk_tile_split_on.argtypes = [ctypes.c_int]
        ms, acc = (ctypes.c_float * 4)(), [0.0] * 4
        check(lib.topk_tile_split_on(1) == 0, "topk_tile_split_on")
        for _ in range(reps):
            ops[name](*args)
            check(lib.topk_tile_split_ms(ms) == 0, "topk_tile_split_ms")
            acc = [x + y / reps for x, y in zip(acc, ms)]
        lib.topk_tile_split_on(0)
        return dict(zip(("score_ms", "select_ms", "gather_ms", "order_ms"),
                        acc))

    def timed(name, n, nq, k, args, plain, library, in_bytes, flops,
              iters=50, plain_iters=5):
        row = dict(Q=nq, N=n, k=k,
                   ms=cuda_ms(torch, lambda: ops[name](*args), iters))
        if parent is not None:
            row["parent_ms"] = cuda_ms(torch, lambda: parent(name, *args),
                                       iters)
        tp = cuda_ms(torch, plain, plain_iters, 1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, nq * k * 8, flops)
        row.update(plain_ms=tp, library_ms=tl, bound_ms=b, bound_by=by)
        if k > 128:
            row.update(split(name, args))
        out[name]["times"].append(row)

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
                hold("topk_search", run("topk_search", q, corpus, alive, k),
                     topk_search_plain(q, corpus, alive, k + 1),
                     f"N={n} Q={nq} k={k}")
            for k in (40, 128):
                hold("topk_search_q8",
                     run("topk_search_q8", q, c8, scale, alive, k),
                     topk_search_q8_plain(q, c8, scale, alive, k + 1),
                     f"N={n} Q={nq} k={k}")
            if n != 8192:
                continue
            for k in (BIG_K if nq != 32 else ()):
                hold("topk_search", run("topk_search", q, corpus, alive, k),
                     topk_search_plain(q, corpus, alive, k + 1),
                     f"N={n} Q={nq} k={k}")
                hold("topk_search_q8",
                     run("topk_search_q8", q, c8, scale, alive, k),
                     topk_search_q8_plain(q, c8, scale, alive, k + 1),
                     f"N={n} Q={nq} k={k}")
            # the work this data needs: alive rows only
            k = 10
            timed("topk_search", n, nq, k,
                  (q, corpus, alive, k),
                  lambda: topk_search_plain(q, corpus, alive, k),
                  lambda: torch.topk(torch.matmul(q, corpus.T).masked_fill(
                      ~alive, -math.inf), k, dim=1),
                  live * D * 4 + n + nq * D * 4, 2 * nq * live * D)
            kp = 40
            timed("topk_search_q8", n, nq, kp,
                  (q, c8, scale, alive, kp),
                  lambda: topk_search_q8_plain(q, c8, scale, alive, kp),
                  lambda: torch.topk(torch.matmul(
                      q * scale, c8.float().T).masked_fill(
                      ~alive, -math.inf), kp, dim=1),
                  live * D + n + nq * D * 4 + D * 4, 2 * nq * live * D)
            if nq == 32:
                continue
            k = 500                                  # the select path
            timed("topk_search", n, nq, k,
                  (q, corpus, alive, k),
                  lambda: topk_search_plain(q, corpus, alive, k),
                  lambda: torch.topk(torch.matmul(q, corpus.T).masked_fill(
                      ~alive, -math.inf), k, dim=1),
                  live * D * 4 + n + nq * D * 4, 2 * nq * live * D,
                  iters=20, plain_iters=3)
            timed("topk_search_q8", n, nq, k,
                  (q, c8, scale, alive, k),
                  lambda: topk_search_q8_plain(q, c8, scale, alive, k),
                  lambda: torch.topk(torch.matmul(
                      q * scale, c8.float().T).masked_fill(
                      ~alive, -math.inf), k, dim=1),
                  live * D + n + nq * D * 4 + D * 4, 2 * nq * live * D,
                  iters=20, plain_iters=3)
    q = unit_rows(torch, gen, 4, D, dev)
    dead = torch.zeros(corpus.shape[0], dtype=torch.bool, device=dev)
    for s, i in (run("topk_search", q, corpus, dead, 10),
                 run("topk_search_q8", q, c8, scale, dead, 40)):
        check(bool(torch.isneginf(s).all() and (i == -1).all()),
              "top-k all-masked: not all (-inf, -1)")
    tiny = corpus[:7].contiguous()
    m = torch.tensor([1, 0, 1, 1, 1, 0, 1], dtype=torch.bool, device=dev)
    hold("topk_search", run("topk_search", q, tiny, m, 7),
         topk_search_plain(q, tiny, m, 8), "k=N=7")
    tiny8 = c8[:7].contiguous()
    hold("topk_search_q8", run("topk_search_q8", q, tiny8, scale, m, 7),
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
                got = run("temporal_window_topk", q, hist, vf, vt, t0, t1, k)
                hold("temporal_window_topk", got, temporal_window_topk_plain(
                    q, hist, vf, vt, t0, t1, k + 1), what)
                in_window("temporal_window_topk", got, vf_h, vt_h, t0, t1,
                          what)
            for k in (40, 128):
                what = f"N={n} Q={nq} k={k}"
                got = run("temporal_window_topk_q8", q, c8, scale, vf, vt,
                          t0, t1, k)
                hold("temporal_window_topk_q8", got,
                     temporal_window_topk_q8_plain(q, c8, scale, vf, vt, t0,
                                                   t1, k + 1), what)
                in_window("temporal_window_topk_q8", got, vf_h, vt_h, t0, t1,
                          what)
            for k in (BIG_K if fp32 and nq != 32 else ()):
                what = f"N={n} Q={nq} k={k}"
                got = run("temporal_window_topk", q, hist, vf, vt, t0, t1, k)
                hold("temporal_window_topk", got, temporal_window_topk_plain(
                    q, hist, vf, vt, t0, t1, k + 1), what)
                in_window("temporal_window_topk", got, vf_h, vt_h, t0, t1,
                          what)
                got = run("temporal_window_topk_q8", q, c8, scale, vf, vt,
                          t0, t1, k)
                hold("temporal_window_topk_q8", got,
                     temporal_window_topk_q8_plain(q, c8, scale, vf, vt, t0,
                                                   t1, k + 1), what)
                in_window("temporal_window_topk_q8", got, vf_h, vt_h, t0, t1,
                          what)
                del got
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
                      (q, hist, vf, vt, t0, t1, k),
                      lambda: temporal_window_topk_plain(q, hist, vf, vt, t0,
                                                         t1, k),
                      lambda: library(hist, q, k),
                      rows_any * D * 4 + 16 * n + nq * D * 4 + 16 * nq,
                      2 * pairs * D, iters=10, plain_iters=2)
            kp = 40
            timed("temporal_window_topk_q8", n, nq, kp,
                  (q, c8, scale, vf, vt, t0, t1, kp),
                  lambda: temporal_window_topk_q8_plain(q, c8, scale, vf, vt,
                                                        t0, t1, kp),
                  lambda: library(c8.float(), q * scale, kp),
                  rows_any * D + 16 * n + nq * D * 4 + 16 * nq + D * 4,
                  2 * pairs * D, iters=10, plain_iters=2)
            if not fp32 or nq == 32:
                continue
            k = 500                                  # the select path
            timed("temporal_window_topk", n, nq, k,
                  (q, hist, vf, vt, t0, t1, k),
                  lambda: temporal_window_topk_plain(q, hist, vf, vt, t0,
                                                     t1, k),
                  lambda: library(hist, q, k),
                  rows_any * D * 4 + 16 * n + nq * D * 4 + 16 * nq,
                  2 * pairs * D, iters=5, plain_iters=2)
            timed("temporal_window_topk_q8", n, nq, k,
                  (q, c8, scale, vf, vt, t0, t1, k),
                  lambda: temporal_window_topk_q8_plain(q, c8, scale, vf, vt,
                                                        t0, t1, k),
                  lambda: library(c8.float(), q * scale, k),
                  rows_any * D + 16 * n + nq * D * 4 + 16 * nq + D * 4,
                  2 * pairs * D, iters=5, plain_iters=2)
        del hist, c8
        torch.cuda.empty_cache()
    for name, r in out.items():
        for row in r["times"]:
            log(f"  {name}: " + " ".join(
                f"{key}={val:.4f}" if isinstance(val, float) else
                f"{key}={val}" for key, val in row.items()))
        log(f"  {name}: max_abs_err={r['err']:.3g}")
    if parent is not None:
        log(f"  {held['parent']} top-k calls equal the parent's kernels bit "
            f"for bit (scores and ids)")
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


# ---------------------------------------------------------------------------
# phase 2 (attention): flash attention and split-K decode vs plain
# ---------------------------------------------------------------------------
def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a row of attention scores: all, or those the
    causal mask keeps (row r sees columns c <= r + skv - sq)."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(skv, max(0, r + off + 1)) for r in range(sq))


def phase_attention(torch, dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.plain import (
        flash_attention_plain)
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_decode.plain import (
        flash_decode_partials_plain, flash_decode_plain, merge_partials)
    from repro_torch.testing import partials_agree, rounding_agree

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {name: {"err": 0.0, "times": []}
           for name in ("flash_attention", "flash_decode")}
    # kernel vs plain: both compute in fp32 from the same inputs and round
    # to the output's dtype. Each output is held within rel of its own
    # value plus 1e-4 of its row's largest: fp32 outputs differ by the sum
    # order (~1e-6 relative), bf16 outputs by at most one rounding step
    # (2^-7 of the value). The outputs here are small (0.01 to 0.1 on
    # N(0, 1) inputs), so an absolute limit alone would pass wrong
    # kernels; the absolute limits stay as an outer bound.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rel = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
    peak = {torch.float32: FP32_FLOPS, torch.bfloat16: BF16_FLOPS}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(name, what, got, want, dtype, fn, plain, library, in_bytes,
               out_bytes, flops, iters, plain_iters):
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        err = float((got.float() - want.float()).abs().max())
        check(err <= tol[dtype], f"{name} {what}: max abs err {err} > "
                                 f"{tol[dtype]}")
        ok, ratio = rounding_agree(got, want, rel[dtype])
        check(ok, f"{name} {what}: an output differs from plain by {ratio:.3g}"
                  f" x its limit ({rel[dtype]:.3g} of its value + 1e-4 of "
                  f"its row's largest)")
        out[name]["err"] = max(out[name]["err"], err)
        t = cuda_ms(torch, fn, iters)
        tp = cuda_ms(torch, plain, plain_iters, 1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, out_bytes, flops, peak[dtype])
        out[name]["times"].append(dict(
            what=what, dtype=str(dtype).removeprefix("torch."), ms=t,
            plain_ms=tp, library_ms=tl, bound_ms=b, bound_by=by,
            max_abs_err=err, median_abs_value=float(
                want.float().abs().median()), err_over_limit=ratio))

    # (what, (B, H, KV, Sq, Skv, D), dtype, causal): the MiniLM encoder at
    # the main path's chunk x 8; BERT4Rec's serve_p99 batch (200 tokens:
    # both tiles ragged); Mistral-NeMo's RAG prefill; a prefill_32k layer
    # cut to 4096 tokens
    for what, (b, h, kv, sq, skv, d), dtype, causal, iters in (
            ("minilm encode 256x128", (256, 12, 12, 128, 128, 32),
             torch.float32, False, 20),
            ("bert4rec serve_p99 512x200", (512, 2, 2, 200, 200, 32),
             torch.float32, False, 20),
            ("nemo prefill 256", (1, 32, 8, 256, 256, 128), torch.bfloat16,
             True, 50),
            ("nemo prefill 4096", (1, 32, 8, 4096, 4096, 128),
             torch.bfloat16, True, 5)):
        q = randn((b, h, sq, d), dtype)
        k = randn((b, kv, skv, d), dtype)
        v = randn((b, kv, skv, d), dtype)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal)
        es = q.element_size()
        record("flash_attention", what, got, want, dtype,
               lambda: fa.flash_attention(q, k, v, causal=causal),
               lambda: flash_attention_plain(q, k, v, causal),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, enable_gqa=True),
               (b * h * sq + 2 * b * kv * skv) * d * es, b * h * sq * d * es,
               4 * b * h * visible_pairs(sq, skv, causal) * d, iters, 2)
        del q, k, v, got, want
    # (what, (B, H, KV, S, D), cache_len, dtype): the engine's cache
    # (max_prompt 256 + 64) after 15 decode steps; decode_32k at full and
    # partial length, in bf16 and (partial) in fp32. The kernel's fp32
    # split partials are held to the plain partials before the shared
    # merge: the merge would blur a split's error into 64 others.
    caches = {}
    for what, (b, h, kv, s, d), cache_len, dtype, iters in (
            ("engine cache 320", (1, 32, 8, 320, 128), 271, torch.bfloat16,
             50),
            ("decode_32k full", (16, 32, 8, 32768, 128), 32768,
             torch.bfloat16, 20),
            ("decode_32k partial", (16, 32, 8, 32768, 128), 30000,
             torch.bfloat16, 20),
            ("decode_32k partial fp32", (16, 32, 8, 32768, 128), 30000,
             torch.float32, 10)):
        if (b, kv, s, d, dtype) not in caches:
            caches.clear()
            torch.cuda.empty_cache()
            caches[b, kv, s, d, dtype] = (randn((b, kv, s, d), dtype),
                                          randn((b, kv, s, d), dtype))
        kc, vc = caches[b, kv, s, d, dtype]
        q = randn((b, h, d), dtype)
        ok, ratio, why = partials_agree(
            fd.flash_decode_partials(q, kc, vc, cache_len, 512),
            flash_decode_partials_plain(q, kc, vc, cache_len, 512), 1e-4)
        check(ok, f"flash_decode {what}: split partials vs plain: {why}")
        log(f"  flash_decode {what}: partials (m, l, acc) within "
            f"{ratio:.3g} x their 1e-4 limits")
        got = fd.flash_decode(q, kc, vc, cache_len=cache_len)
        want = flash_decode_plain(q, kc, vc, cache_len, 512)
        # the in-library merge against merge_partials of the partials at
        # the split this call chose: fp32 within 1e-5 (other sum orders),
        # bf16 within one rounding step of the merged fp32
        split = fd.choose_split(kv, cache_len, sms)
        merged = merge_partials(*fd.flash_decode_partials(
            q, kc, vc, cache_len, split))
        ok, ratio = (rounding_agree(got, merged, 1e-5, 1e-5)
                     if dtype == torch.float32 else
                     rounding_agree(got, merged.to(dtype), rel[dtype]))
        check(ok, f"flash_decode {what}: merge differs from merge_partials "
                  f"by {ratio:.3g} x its limit")
        log(f"  flash_decode {what}: split {split} rows, in-library merge "
            f"within {ratio:.3g} x its limit of merge_partials")
        es = q.element_size()
        record("flash_decode", what, got, want, dtype,
               lambda: fd.flash_decode(q, kc, vc, cache_len=cache_len),
               lambda: flash_decode_plain(q, kc, vc, cache_len, 512),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None], kc[:, :, :cache_len], vc[:, :, :cache_len],
                   enable_gqa=True),
               (b * h * d + 2 * b * kv * cache_len * d) * es, b * h * d * es,
               4 * b * h * cache_len * d, iters, 3)
        del q, got, want
    del caches
    torch.cuda.empty_cache()
    for name, r in out.items():
        for row in r["times"]:
            log(f"  {name}: " + " ".join(
                f"{key}={val:.4g}" if isinstance(val, float) else
                f"{key}={val}" for key, val in row.items()))
        log(f"  {name}: max_abs_err={r['err']:.3g}")
    return out


# ---------------------------------------------------------------------------
# phase 2 (recsys): the embedding bag vs plain
# ---------------------------------------------------------------------------
def bag_ids(torch, gen, v: int, b: int, bag: int, dev, pad: float = 0.0):
    """(B, L) int32 ids over the whole table: V - 1 and ids above 2^24
    (where V allows) among them, ``pad`` of the slots padding (-1 and
    -7), bag 0 all padding and bag 1 holding the id V (a NaN row)."""
    idx = torch.randint(0, v, (b, bag), generator=gen, device=dev,
                        dtype=torch.int32)
    if pad:
        u = torch.rand((b, bag), generator=gen, device=dev)
        idx = torch.where(u < pad / 2, -1, torch.where(u < pad, -7, idx))
    idx[-1, -1] = v - 1
    if v > (1 << 24) + 2:
        idx[-2, 0] = 1 << 24
        idx[-3, 0] = (1 << 24) + 1
    idx[0] = -1
    idx[1, bag // 2] = v
    return idx.to(torch.int32)


def phase_embedding_bag(torch, dev) -> dict:
    """The kernel against its plain version at the recsys path's shapes:
    DLRM's table 0 (25,000,192 x 128 fp32 after the one-card cap) at
    serve_p99 and serve_bulk (L = 1), and table 20 (11,316,992 x 128) at
    the widest bag of MLPerf's multi-hot DLRM (L = 100), fp32 and bf16."""
    import torch.nn.functional as F

    from repro_torch.configs.dlrm_mlperf import ONE_CARD
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.plain import embedding_bag_plain
    from repro_torch.models.recsys import table_init
    from repro_torch.testing import rounding_agree

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {"embedding_bag": {"err": 0.0, "times": []}}
    sizes = ONE_CARD.padded_table_sizes

    def hold(what, table, idx, w, combiner):
        got = eb.embedding_bag(table, idx, w, combiner)
        want = embedding_bag_plain(table, idx, w, combiner)
        nan = torch.isnan(want).any(1)
        check(torch.equal(torch.isnan(got).any(1), nan)
              and bool(torch.isnan(got[nan]).all())
              and int(nan.sum()) == 1 and bool(nan[1]),
              f"embedding_bag {what}: NaN rows differ from the bag with id V")
        g, t = got[~nan].float(), want[~nan].float()
        check(bool((g[0] == 0).all()), f"embedding_bag {what}: the "
                                       f"all-padding bag is not 0")
        err = float((g - t).abs().max())
        if idx.shape[1] == 1 and table.dtype == torch.float32:
            check(torch.equal(g, t), f"embedding_bag {what}: not bit for bit "
                                     f"(max abs err {err})")
        elif table.dtype == torch.bfloat16:
            ok, ratio = rounding_agree(g, t, 2 ** -7)
            check(ok, f"embedding_bag {what}: an output differs from plain "
                      f"by {ratio:.3g} x one bf16 rounding step")
        else:
            # 1e-5 of sum_j |w_j * row_j| a component (fmaf against a
            # product then an add: one rounding a term apart)
            valid = (idx >= 0) & (idx < table.shape[0])
            rows = table[torch.where(valid, idx, 0).long()].float().abs()
            scale = (torch.where(valid, w.abs(), 0.0)[..., None]
                     * rows).sum(1)
            if combiner == "mean":
                scale = scale / torch.where(valid, w, 0.0).sum(
                    1, keepdim=True).clamp_min(1e-9)
            check(bool(((g - t).abs() <= 1e-5 * scale[~nan]).all()),
                  f"embedding_bag {what}: max abs err {err} above 1e-5 of "
                  f"sum |w * row|")
        out["embedding_bag"]["err"] = max(out["embedding_bag"]["err"], err)

    def timed(what, table, batches, combiner, iters, plain_iters):
        """Kernel, plain and library time over ``batches`` [(idx, w)],
        one batch a call in turn (new rows each call: a serving caller
        finds them cold in L2)."""
        v, d = table.shape
        es = table.element_size()
        turn = {"i": 0}

        def nxt(of=batches):
            turn["i"] = (turn["i"] + 1) % len(of)
            return of[turn["i"]]

        # the library call's inputs made once: its time is F.embedding_bag's
        lib = [(idx.clamp(0, v - 1), torch.where(idx >= 0, w, 0.0).to(
            table.dtype)) for idx, w in batches]

        def library():
            idx, w = nxt(lib)
            return F.embedding_bag(idx, table, per_sample_weights=w,
                                   mode="sum")

        t = cuda_ms(torch, lambda: eb.embedding_bag(table, *nxt(), combiner),
                    iters)
        tp = cuda_ms(torch, lambda: embedding_bag_plain(table, *nxt(),
                                                        combiner),
                     plain_iters, 1)
        tl = cuda_ms(torch, library, iters, 1)
        del lib
        idx, _ = batches[0]
        b, bag = idx.shape
        n_valid = int(((idx >= 0) & (idx < v)).sum())
        bnd, by = bound_ms(n_valid * d * es + b * bag * 8, b * d * es,
                           2 * n_valid * d)
        out["embedding_bag"]["times"].append(dict(
            what=what, B=b, L=bag, ms=t, plain_ms=tp, library_ms=tl,
            bound_ms=bnd, bound_by=by))

    v0 = sizes[0]
    table = table_init(gen, (v0, 128), v0 ** -0.25, torch.float32, dev)
    for what, b, n_batches, iters in (("serve_p99", 512, 60, 50),
                                      ("serve_bulk", 262_144, 3, 10)):
        batches = []
        for _ in range(n_batches):
            idx = torch.randint(0, v0, (b, 1), generator=gen, device=dev,
                                dtype=torch.int32)
            batches.append((idx, torch.ones((b, 1), device=dev)))
        idx = bag_ids(torch, gen, v0, b, 1, dev)
        ones = torch.ones((b, 1), device=dev)
        for combiner in ("sum", "mean"):
            hold(f"{what} (B={b}, L=1) {combiner}", table, idx, ones,
                 combiner)
        # as DLRM calls it: one field of a (B, 26, 1) id tensor, read
        # through its row stride, and no weights (unit weights)
        fields = torch.randint(0, v0, (b, 26, 1), generator=gen, device=dev,
                               dtype=torch.int32)
        fields[:, 3] = idx
        hold(f"{what} (B={b}, L=1) field 3 of 26, no weights", table,
             fields[:, 3], None, "sum")
        del fields
        batches[0] = (idx, ones)
        timed(f"{what} table 0 fp32", table, batches, "sum", iters, 3)
    del table, batches
    torch.cuda.empty_cache()
    v20 = sizes[20]
    table = table_init(gen, (v20, 128), v20 ** -0.25, torch.float32, dev)
    b, bag = 4096, 100
    batches = []
    for _ in range(3):
        idx = bag_ids(torch, gen, v20, b, bag, dev, pad=0.3)
        batches.append((idx, torch.rand((b, bag), generator=gen, device=dev)))
    for dtype in (torch.float32, torch.bfloat16):
        t = table if dtype == torch.float32 else table.to(dtype)
        name = str(dtype).removeprefix("torch.")
        for combiner in ("sum", "mean"):
            hold(f"multi-hot (B={b}, L={bag}) {name} {combiner}", t,
                 *batches[0], combiner)
        timed(f"multi-hot table 20 {name}", t, batches, "sum", 10, 2)
        del t
    del table, batches
    torch.cuda.empty_cache()
    for row in out["embedding_bag"]["times"]:
        log("  embedding_bag: " + " ".join(
            f"{key}={val:.4g}" if isinstance(val, float) else
            f"{key}={val}" for key, val in row.items()))
    log(f"  embedding_bag: max_abs_err={out['embedding_bag']['err']:.3g}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the MiniLM embedder, and stores that embed with it
# ---------------------------------------------------------------------------
def query_texts(corpus) -> list[str]:
    texts = [f"{f.name} equals units" for f in corpus.facts[:22]]
    texts += [f"{t} policy requires review" for t in
              ("security", "billing", "network", "storage", "compliance",
               "deployment", "monitoring", "identity", "backup", "capacity")]
    return texts                                   # 32


def phase_embedder(torch, dev):
    """Bulk and query encode on the card, and card vs CPU with the same
    weights. Returns (card embedder, CPU embedder)."""
    import numpy as np

    from repro_torch.configs.minilm_embedder import CONFIG, SHAPES
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.models.embedder import TransformerEmbedder
    from repro_torch.models.transformer import forward_pooled

    emb = TransformerEmbedder(CONFIG, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in emb.params.parameters())
    log(f"  MiniLM: {n_params} parameters ({CONFIG.n_layers}L, "
        f"d {CONFIG.d_model}, {CONFIG.n_heads}H, d_ff {CONFIG.d_ff}, vocab "
        f"{CONFIG.vocab}, {CONFIG.dtype})")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for shape, info in SHAPES.items():
        b, s = info["batch"], info["seq"]
        toks = torch.randint(4, CONFIG.vocab, (b, s), generator=gen,
                             device=dev)
        with torch.no_grad():
            vecs = forward_pooled(emb.params, toks, CONFIG)
            torch.cuda.synchronize()
            t = time.perf_counter()
            reps = 3
            for _ in range(reps):
                vecs = forward_pooled(emb.params, toks, CONFIG)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t) / reps
        norms = vecs.float().norm(dim=1)
        check(vecs.shape == (b, CONFIG.d_model)
              and bool(torch.isfinite(vecs).all())
              and bool(((norms - 1).abs() < 1e-4).all()),
              f"MiniLM {shape}: not {b} finite unit vectors")
        log(f"  MiniLM {shape} ({b} x {s}): {t * 1e3:.2f} ms, "
            f"{b / t:.0f} sequences/s on the host clock")
        del toks, vecs
    torch.cuda.empty_cache()
    cpu = TransformerEmbedder(CONFIG, params=emb.params, device="cpu")
    corpus = generate_corpus(n_docs=100, n_versions=5)
    texts = [corpus.versions[0][doc][:600] for doc in corpus.doc_ids()[:32]]
    texts += query_texts(corpus)
    a, b = emb.embed(texts), cpu.embed(texts)
    err = float(np.abs(a - b).max())
    check(a.shape == (64, CONFIG.d_model) and bool(np.isfinite(a).all()),
          "MiniLM card embed: bad shape or not finite")
    check(err <= 1e-4, f"MiniLM card vs CPU: max abs err {err} > 1e-4")
    log(f"  MiniLM card vs CPU on 64 texts: max abs err {err:.3g}")
    return emb, cpu


def phase_rag_store(torch, workdir: str, emb, cpu_emb) -> dict:
    """The paper's corpus into an fp32 and a quantized store embedding
    with the MiniLM encoder on the card; queries at k 10 and 50; CPU
    reopen with the CPU embedder. Returns {quantized: root}."""
    from repro_torch.core.store import LiveVectorLake
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.kernels.temporal_mask_score import ops as tops
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.testing import results_equivalent

    corpus = generate_corpus(n_docs=100, n_versions=5)
    ts = corpus.timestamps
    texts = query_texts(corpus)
    mixes = [("current", {}), ("at v2", {"at": ts[2] + 1}),
             ("window v1-v3", {"window": (ts[1], ts[3])})]
    roots = {}
    for quantized in (False, True):
        mode = "quantized" if quantized else "fp32"
        root = f"{workdir}/rag-{mode}"
        roots[quantized] = root
        q8_before = (kops.launches_q8, tops.launches_q8)
        lake = LiveVectorLake(root, embedder=emb, quantized=quantized,
                              device="cuda")
        t = time.perf_counter()
        for v, t_v in enumerate(ts):
            for doc in corpus.doc_ids():
                lake.ingest(doc, corpus.versions[v][doc], ts=t_v)
        t = time.perf_counter() - t
        log(f"  {mode} store with MiniLM: ingested {corpus.n_docs} docs x "
            f"{len(ts)} versions in {t:.1f} s ({lake.embedder.misses} "
            f"chunks embedded); {len(lake.hot)} live chunks")
        got = {}
        for name, kw in mixes:
            for k in (10, 50):
                for bs in (1, 8, 32):
                    batch = texts[:bs]
                    t = time.perf_counter()
                    res = lake.query_batch(batch, k=k, **kw)
                    t = (time.perf_counter() - t) * 1e3
                    seq = [lake.query(x, k=k, **kw) for x in batch]
                    check(res == seq, f"{mode} MiniLM store {name} k={k} "
                                      f"batch={bs}: query_batch != [query]")
                    if bs == 32:
                        log(f"  {mode} MiniLM store query_batch {name} k={k} "
                            f"batch=32: {t:.3f} ms on the host clock")
                check(all(len(r) == k for r in res),
                      f"{mode} MiniLM store {name} k={k}: short result")
                for r in res:
                    if "at" in kw:
                        lake.temporal.assert_no_leakage(r, kw["at"])
                    elif "window" in kw:
                        lake.temporal.assert_no_window_leakage(
                            r, *kw["window"])
                got[name, k] = res
        if quantized:           # k = 50: pools of 200, the select path
            check(kops.launches_q8 > q8_before[0]
                  and tops.launches_q8 > q8_before[1],
                  "quantized MiniLM store: the q8 scans were not launched")
        del lake
        cpu = LiveVectorLake(root, embedder=cpu_emb, device="cpu")
        for name, kw in mixes:
            ext = cpu.query_batch(texts, k=200, **kw)
            for k in (10, 50):
                want = cpu.query_batch(texts, k=k, **kw)
                # the query vectors differ between card and CPU by the
                # embedder's error (<= 1e-4 a component, phase 5 check)
                for qi in range(len(texts)):
                    check(results_equivalent(want[qi], got[name, k][qi],
                                             ext[qi], rtol=1e-4, atol=1e-4),
                          f"{mode} MiniLM store {name} k={k} query {qi}: "
                          f"card != cpu reopen")
        del cpu
        log(f"  {mode} MiniLM store: batch == sequential, no leakage, "
            f"equivalent to the CPU reopen at k 10 and 50")
    return roots


# ---------------------------------------------------------------------------
# phase 6: RAG generation with Mistral-NeMo-12B at full width
# ---------------------------------------------------------------------------
def phase_rag_generate(torch, root: str, emb) -> None:
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.core.store import LiveVectorLake
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import RAGEngine

    corpus = generate_corpus(n_docs=100, n_versions=5)
    ts = corpus.timestamps
    t = time.perf_counter()
    params = init_params(CONFIG, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  Mistral-NeMo-12B: {n_params} parameters ({CONFIG.n_layers}L, "
        f"d {CONFIG.d_model}, {CONFIG.n_heads}H / {CONFIG.n_kv} KV, d_head "
        f"{CONFIG.d_head}, d_ff {CONFIG.d_ff}, vocab {CONFIG.vocab}, "
        f"{CONFIG.dtype}), {n_params * 2 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t:.1f} s")
    check(n_params == CONFIG.n_params(), "parameter count")
    store = LiveVectorLake(root, embedder=emb, device="cuda")
    engine = RAGEngine(store, CONFIG, params=params, max_prompt=256,
                       device="cuda")
    current = [f"{f.name} equals units" for f in corpus.facts[:4]]
    as_of = [f"{f.name} equals units" for f in corpus.facts[4:8]]
    at = ts[1] + 1
    new = 16
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = engine.answer_batch(current, max_new_tokens=new)
    results += engine.answer_batch(as_of, at=at, max_new_tokens=new)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    for res, q in zip(results, current + as_of):
        want = store.query(q, k=engine.retrieval_k, at=res.at)
        check(res.retrieved == want, f"RAG {q!r}: retrieved != store.query")
        check(len(res.token_ids) == new
              and all(0 <= x < CONFIG.vocab for x in res.token_ids),
              f"RAG {q!r}: bad token ids {res.token_ids}")
        check(res.n_context_chunks == engine.retrieval_k
              and res.prompt.startswith("Context:"), f"RAG {q!r}: prompt")
    log(f"  RAG: 8 requests (4 current, 4 at v1), {new} new tokens each, in "
        f"{t:.2f} s on the host clock ({t / 8 * 1e3:.1f} ms a request, "
        f"{8 * new / t:.1f} tokens/s)")
    log(f"  RAG first answer: {results[0].token_ids}")

    # where a request's time goes, warm: prefill and decode steps timed
    # apart on the host clock (synchronized), then one profiled request
    from repro_torch.models.transformer import decode_step, prefill
    toks = torch.from_numpy(engine.tokenizer.encode(
        results[0].prompt, max_len=engine.max_prompt))[None, :].to("cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache, n = prefill(params, toks, CONFIG, engine.cache_size)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t
        cur = logits.argmax(-1)[:, None]
        steps = []
        for _ in range(15):
            t = time.perf_counter()
            logits, cache, n = decode_step(params, cur, cache, n, CONFIG)
            cur = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t)
    t_dec = sum(steps) / len(steps)
    med = sorted(steps)[len(steps) // 2]
    log(f"  RAG warm: prefill of {toks.shape[1]} tokens {t_pre * 1e3:.2f} "
        f"ms, decode {t_dec * 1e3:.2f} ms a step (median {med * 1e3:.2f}; "
        f"weights alone bound a step at "
        f"{n_params * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms; "
        f"{DECODE_STEP_BEFORE_MS} ms a step before the attention kernels' "
        f"Hopper redesign)")
    profile_request(torch, engine, current[0], new)
    del engine, store, params
    torch.cuda.empty_cache()


def profiled(torch, fn):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activities),
    synchronized. Returns (its result, host seconds, the CUDA kernels'
    averages, or None where the profiler cannot trace the card). A
    failure of ``fn`` is fatal; only a profiler that cannot trace is
    logged and passed over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as exc:                       # noqa: BLE001
        log(f"  profiler: could not start tracing the card ({exc!r})")
        prof = None
    try:
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except Exception as exc:               # noqa: BLE001
                log(f"  profiler: could not stop tracing ({exc!r})")
                prof = None
    if prof is None:
        return res, wall, None
    try:
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    except Exception as exc:                       # noqa: BLE001
        log(f"  profiler: could not read the trace ({exc!r})")
        return res, wall, None
    return res, wall, kern


def log_device_time(what: str, wall: float, kern, top: int = 8) -> None:
    """Device busy time of a profiled call against its host time, and
    the kernels that take it."""
    if kern is None:
        return
    if not kern:
        log(f"  profiler: no device time recorded ({what})")
        return
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"  profiled {what}: {wall * 1e3:.1f} ms on the host clock, device "
        f"busy {busy * 1e3:.1f} ms ({busy / wall:.1%}; idle "
        f"{1 - busy / wall:.1%})")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def profile_request(torch, engine, query: str, new: int) -> None:
    """One RAG request under torch.profiler: device busy time against
    the host clock, and the kernels that take the device's time. The
    request is checked like the others."""
    res, wall, kern = profiled(
        torch, lambda: engine.answer(query, max_new_tokens=new))
    want = engine.store.query(query, k=engine.retrieval_k, at=res.at)
    check(res.retrieved == want, f"profiled RAG {query!r}: retrieved != "
                                 f"store.query")
    check(len(res.token_ids) == new
          and all(0 <= x < engine.cfg.vocab for x in res.token_ids),
          f"profiled RAG {query!r}: bad token ids {res.token_ids}")
    log_device_time("request", wall, kern)
    if kern:
        for name, keys in (
                ("flash_decode", ("decode_partials_kernel",
                                  "decode_merge_kernel")),
                ("flash_attention", ("fa_wgmma_kernel",
                                     "flash_attention_kernel"))):
            evs = [e for e in kern if any(x in e.key for x in keys)]
            log(f"  profiled request: {name} "
                f"{sum(e.self_device_time_total for e in evs) / 1e3:.3f} ms "
                f"on the device over {sum(e.count for e in evs)} kernel "
                f"launches")


def phase_decode_vs_prefill(torch) -> None:
    """Prefill 256 tokens, decode 128 given tokens, against one prefill
    of all 384: the two attention kernels held against each other at
    Mistral-NeMo's full width (fp32, 4 layers)."""
    import dataclasses

    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)

    cfg = dataclasses.replace(CONFIG, n_layers=4, dtype=torch.float32)
    params = init_params(cfg, seed=SEED + 1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    toks = torch.randint(4, cfg.vocab, (1, 384), generator=gen,
                         device="cuda")
    with torch.no_grad():
        _, cache, n = prefill(params, toks[:, :256], cfg, 384)
        for i in range(256, 384):
            logits, cache, n = decode_step(params, toks[:, i:i + 1], cache,
                                           n, cfg)
        want, _, _ = prefill(params, toks, cfg, 384)
    scale = float(want.abs().max())
    err = float((logits - want).abs().max())
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(err <= 1e-3 * scale, f"decode vs prefill: max abs err {err} > "
                               f"1e-3 x {scale}")
    check(bool((logits.argmax(-1) == want.argmax(-1)).all()),
          "decode vs prefill: argmax differs")
    log(f"  decode vs prefill (full width, fp32, 4 layers, 256 + 128 "
        f"tokens): max abs logit err {err:.3g} of max |logit| {scale:.3g}; "
        f"argmax equal")
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the recsys family at full width
# ---------------------------------------------------------------------------
def to_cpu(module) -> dict:
    return {n: p.detach().cpu() for n, p in module.named_parameters()}


def compact(torch, ids, *tables):
    """The ids remapped onto the rows of ``tables`` that they reference,
    and those rows, on the CPU (a model's CPU forward over a batch
    without the full tables)."""
    uniq, inv = torch.unique(ids, return_inverse=True)
    return (inv.cpu(), *(t[uniq.long()].cpu() for t in tables))


def held_to_cpu(what: str, got, want) -> None:
    """Card logits against the CPU forward's: within 1e-4 of their max
    |value| (TF32 off; the two sum the fp32 products in other orders)."""
    got = got.cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(got.shape == want.shape and bool(got.isfinite().all()),
          f"{what}: bad shape or not finite")
    check(err <= 1e-4 * scale, f"{what}: card vs CPU max abs err {err} > "
                               f"1e-4 x {scale}")
    log(f"  {what}: card vs CPU max abs err {err:.3g} of max |logit| "
        f"{scale:.3g}")


def serve_times(torch, what: str, fn, batches: list, reps: int) -> int:
    """Host ms a batch (synchronized, one batch a call in turn), device ms
    between CUDA events, samples/s and the peak of allocated memory.
    Returns the number of calls of ``fn``."""
    b = next(iter(batches[0].values())).shape[0]
    host = []
    with torch.no_grad():
        for i in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(batches[i % len(batches)])
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % len(batches)
            return fn(batches[turn["i"]])

        dev_ms = cuda_ms(torch, nxt, reps, 1)
    host.sort()
    log(f"  {what} (B={b}): host median {host[len(host) // 2]:.4f} min "
        f"{host[0]:.4f} max {host[-1]:.4f} ms a batch over {reps}; "
        f"device {dev_ms:.4f} ms a batch (CUDA events, {reps} batches); "
        f"{b / dev_ms * 1e3:.0f} samples/s; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return 2 * reps + 1


def phase_recsys(torch, dev) -> int:
    """DLRM at MLPerf widths over the one-card tables (58.3 GB fp32),
    then FM, Wide&Deep and BERT4Rec at full width, then retrieval_cand
    for the four, all through ``launch/steps.build_cell``'s functions.
    Returns the embedding bag's launches on the DLRM serving path."""
    from repro_torch.configs.bert4rec import CONFIG as B4R
    from repro_torch.configs.dlrm_mlperf import ONE_CARD
    from repro_torch.configs.fm import CONFIG as FM
    from repro_torch.configs.wide_deep import CONFIG as WD
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.plain import embedding_bag_plain
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.kernels.topk_search.plain import topk_search_plain
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys
    from repro_torch.models.bridge import params_from_repro, params_to_repro
    from repro_torch.models.transformer import init_params
    from repro_torch.testing import topk_agree

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def batch_size(bundle):
        return next(iter(bundle.arg_specs[1].values())).shape[0]

    # -- DLRM: 26 tables capped at 25M rows, seeded, made in place
    cfg = ONE_CARD
    t = time.perf_counter()
    params = recsys.dlrm_init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    log(f"  DLRM (MLPerf widths, tables capped at 25M rows): "
        f"{sum(cfg.padded_table_sizes)} table rows x {cfg.embed_dim}, "
        f"{gb:.2f} GB fp32 made on the card in "
        f"{time.perf_counter() - t:.1f} s")

    def dlrm_batch(b):
        # each field draws from its own table (repro's smoke batches draw
        # every field from min(table_sizes) = 3 rows, all in L2)
        ids = torch.stack([torch.randint(0, v, (b,), generator=gen,
                                         device=dev, dtype=torch.int32)
                           for v in cfg.table_sizes], dim=1)[..., None]
        return {"dense": torch.rand((b, cfg.n_dense), generator=gen,
                                    device=dev),
                "sparse_ids": ids}

    eb.launches = 0
    forwards = 0
    for shape, n_batches, reps in (("serve_p99", 20, 20),
                                   ("serve_bulk", 2, 4)):
        bundle = build_cell("dlrm-mlperf", shape, device=dev)
        b = batch_size(bundle)
        batches = [dlrm_batch(b) for _ in range(n_batches)]
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            got = bundle.fn(params, batches[0])
            plain = recsys.dlrm_forward(params, cfg, **batches[0],
                                        bag=embedding_bag_plain)
        forwards += 1
        check(got.shape == (b,) and bool(got.isfinite().all()),
              f"DLRM {shape}: bad shape or not finite")
        check(torch.equal(got, plain), f"DLRM {shape}: kernel bags != plain "
                                       f"bags (max abs "
                                       f"{float((got - plain).abs().max())})")
        log(f"  DLRM {shape}: logits with the kernel equal those with the "
            f"plain bag, bit for bit")
        if shape == "serve_p99":
            ids = batches[0]["sparse_ids"]
            tables, remap = {}, torch.empty_like(ids, device="cpu")
            for i in range(cfg.n_sparse):
                remap[:, i, 0], tables[f"table_{i}"] = compact(
                    torch, ids[:, i, 0], params["tables"][f"table_{i}"])
            cpu = recsys.dlrm_module({"tables": tables,
                                      "bot": to_cpu(params["bot"]),
                                      "top": to_cpu(params["top"])})
            held_to_cpu("DLRM serve_p99", got, recsys.dlrm_forward(
                cpu, cfg, batches[0]["dense"].cpu(), remap))
        forwards += serve_times(torch, f"DLRM {shape}",
                                lambda x: bundle.fn(params, x), batches, reps)
        with torch.no_grad():
            _, wall, kern = profiled(torch,
                                     lambda: bundle.fn(params, batches[1]))
        forwards += 1
        log_device_time(f"DLRM {shape} batch", wall, kern)
        if kern:
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            bags = sum(e.self_device_time_total for e in kern
                       if "embedding_bag" in e.key) / 1e3
            log(f"  DLRM {shape} batch: embedding_bag kernels {bags:.4f} ms "
                f"of {busy:.4f} ms device busy ({bags / busy:.1%}); the "
                f"rest (MLPs, interaction) {busy - bags:.4f} ms")
        del batches
    launches = eb.launches
    check(launches == cfg.n_sparse * forwards,
          f"DLRM: {launches} embedding_bag launches for {forwards} forwards "
          f"of {cfg.n_sparse} fields")
    log(f"  launches on the DLRM serving path: embedding_bag {launches} "
        f"({cfg.n_sparse} a forward, {forwards} forwards)")
    del params, plain, got
    torch.cuda.empty_cache()

    # -- FM and Wide&Deep: one table lookup a field (no kernel)
    for arch, mcfg, init, fwd in (
            ("fm", FM, recsys.fm_init, recsys.fm_forward),
            ("wide-deep", WD, recsys.widedeep_init,
             recsys.widedeep_forward)):
        t = time.perf_counter()
        params = init(mcfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        log(f"  {arch}: {mcfg.n_params()} parameters ({mcfg.n_sparse} "
            f"fields x {mcfg.vocab_per_field} ids, embed {mcfg.embed_dim}) "
            f"made on the card in {time.perf_counter() - t:.1f} s")
        vpf = mcfg.vocab_per_field
        for shape, reps in (("serve_p99", 20), ("serve_bulk", 4)):
            bundle = build_cell(arch, shape, device=dev)
            b = batch_size(bundle)
            batches = [{"ids": torch.randint(
                0, vpf, (b, mcfg.n_sparse), generator=gen, device=dev,
                dtype=torch.int32) + torch.arange(
                    mcfg.n_sparse, device=dev, dtype=torch.int32) * vpf}
                for _ in range(2)]
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                got = bundle.fn(params, batches[0])
            check(got.shape == (b,) and bool(got.isfinite().all()),
                  f"{arch} {shape}: bad shape or not finite")
            if shape == "serve_p99":
                if arch == "fm":
                    ids, w, v = compact(torch, batches[0]["ids"],
                                        params["w"], params["v"])
                    cpu = recsys.fm_module({"w0": params["w0"].cpu(), "w": w,
                                            "v": v})
                else:
                    ids, w, e = compact(torch, batches[0]["ids"],
                                        params["wide_w"], params["embed"])
                    cpu = recsys.widedeep_module({
                        "wide_w": w, "wide_b": params["wide_b"].cpu(),
                        "embed": e, "deep": to_cpu(params["deep"])})
                held_to_cpu(f"{arch} serve_p99", got, fwd(cpu, mcfg, ids))
            serve_times(torch, f"{arch} {shape}",
                        lambda x: bundle.fn(params, x), batches, reps)
        del params, batches, got
        torch.cuda.empty_cache()

    # -- BERT4Rec at serve_p99 on flash_attention (D = 32, non-causal);
    #    serve_bulk would hold 262,144 x 30,208 fp32 logits (31.7 GB)
    params = init_params(B4R, seed=SEED, device=dev)
    bundle = build_cell("bert4rec", "serve_p99", device=dev)
    b, s = bundle.arg_specs[1]["tokens"].shape
    batches = [{"tokens": torch.randint(4, B4R.vocab, (b, s), generator=gen,
                                        device=dev, dtype=torch.int32)}
               for _ in range(2)]
    fa_before = fa.launches
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got = bundle.fn(params, batches[0])
    check(fa.launches - fa_before == B4R.n_layers,
          "BERT4Rec: flash_attention not launched once a layer")
    cpu = params_from_repro(params_to_repro(params), B4R, "cpu")
    held_to_cpu("bert4rec serve_p99", got, recsys.bert4rec_forward(
        cpu, B4R, batches[0]["tokens"].cpu()))
    serve_times(torch, "bert4rec serve_p99", lambda x: bundle.fn(params, x),
                batches, 10)
    log(f"  bert4rec: flash_attention launched {fa.launches - fa_before} "
        f"times ({B4R.n_layers} a forward)")
    del params, batches, got
    torch.cuda.empty_cache()

    # -- retrieval_cand: 1 query x 1,000,448 candidates, the padded 1% tail
    #    masked, k = 100, through the hot tier's topk_search (D = 10: the
    #    scalar tile path)
    k_before = kops.launches
    for arch in ("dlrm-mlperf", "fm", "wide-deep", "bert4rec"):
        bundle = build_cell(arch, "retrieval_cand", device=dev)
        specs = bundle.arg_specs[0]
        n, d = specs["candidates"].shape
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
        mask[-max(1, n // 100):] = False
        batch = {"query": unit_rows(torch, gen, 1, d, dev),
                 "candidates": unit_rows(torch, gen, n, d, dev),
                 "candidate_mask": mask}
        got = bundle.fn(batch)
        want = topk_search_plain(batch["query"], batch["candidates"], mask,
                                 101)
        ok, err, why = topk_agree(got[0], got[1], want[0], want[1],
                                  score_atol=1e-4, gap=1e-5)
        check(ok and got[0].shape == (1, 100), f"{arch} retrieval_cand: {why}")
        check(bool(mask[got[1].long()].all()),
              f"{arch} retrieval_cand: a masked candidate ranked")
        ms = cuda_ms(torch, lambda: bundle.fn(batch), 20)
        log(f"  {arch} retrieval_cand (1 x {n}, D={d}, k=100): {ms:.4f} ms "
            f"(CUDA events); max abs score err vs plain {err:.3g}")
        del batch
    log(f"  retrieval_cand: topk_search launched {kops.launches - k_before} "
        f"times")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit: phase 2 also "
                         "holds each top-k call against its kernels, bit "
                         "for bit, and times them")
    args = ap.parse_args()
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
    logs = build.build()
    for name in build.sources():
        build.load(name)
    log(f"  built {build.sources()} in {time.perf_counter() - t:.1f} s")
    for name, kernel in PTXAS_REPORT:
        for line in ptxas_lines(logs.get(name, ""), kernel):
            log(f"  ptxas {line}")

    parent = ParentScans(torch, args.parent) if args.parent else None

    log("phase 2: kernels against their plain versions")
    kern = phase_kernels(torch, dev, parent)
    kern.update(phase_attention(torch, dev))
    kern.update(phase_embedding_bag(torch, dev))
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        log("phase 3: temporal engine at scale")
        phase_engine(torch, work)
        log("phase 4: LiveVectorLake end to end")
        launches, fp32_answers = phase_store(torch, work, quantized=False)
        launches_q8, _ = phase_store(torch, work, quantized=True,
                                     fp32_answers=fp32_answers)
        launches.update(launches_q8)
        log("phase 5: the MiniLM embedder and stores that embed with it")
        emb, cpu_emb = phase_embedder(torch, dev)
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_decode import ops as fd
        fa.launches = fd.launches = 0
        roots = phase_rag_store(torch, work, emb, cpu_emb)
        log("phase 6: RAG generation, Mistral-NeMo-12B at full width")
        phase_rag_generate(torch, roots[False], emb)
        launches["flash_attention"] = fa.launches
        launches["flash_decode"] = fd.launches
        log(f"  launches on the RAG path (phases 5-6): flash_attention "
            f"{fa.launches}, flash_decode {fd.launches}")
        for name in ("flash_attention", "flash_decode"):
            check(launches[name] > 0, f"{name} was never launched on the "
                                      f"RAG path")
        phase_decode_vs_prefill(torch)
    log("phase 7: the recsys family at full width")
    launches["embedding_bag"] = phase_recsys(torch, dev)
    check(launches["embedding_bag"] > 0,
          "embedding_bag was never launched on the DLRM serving path")

    rows = []
    main_shape = {"flash_attention": "nemo prefill 256",
                  "flash_decode": "engine cache 320",
                  "embedding_bag": "serve_p99 table 0 fp32"}
    for name, (source, tpu) in KERNELS.items():
        if name in main_shape:
            at = next(r for r in kern[name]["times"]
                      if r["what"] == main_shape[name])
        else:
            at = next(r for r in kern[name]["times"]
                      if r["Q"] == 32 and r["N"] in (8192, 1 << 20)
                      and r["k"] <= 128)
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
