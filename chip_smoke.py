#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU
    python3 chip_smoke.py --parent DIR   # also hold the top-k scans and
                                         # the bags against DIR's kernels

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the serving path gives it, runs the temporal engine over a
quarter-million-row history, drives ``LiveVectorLake`` end to end, fp32
and quantized, then the paper's RAG path: the MiniLM embedder at full
width embedding the paper's corpus into stores on the card, and a
Mistral-NeMo-12B generator at full width (seeded random weights)
answering requests grounded in them; last, the recsys family (DLRM at
MLPerf widths, FM, Wide&Deep, BERT4Rec) serving on the card, and the
shard fabric: sharded lakes on the card against one lake, through
background maintenance, a shard down, an online split and a repair; and
the LM family's serving cells, Qwen2-MoE-A2.7B at full width and depth
through ``build_cell``, with the MoE layer's capacity dispatch; and the
train cells of the LM and recsys families on the card, with the
hand-written backward kernels of attention and the embedding bag; and
SchNet's train cells, message passing on the hand-written
gather-segment-sum kernel.

Phases (any failure stops the script with a non-zero exit):
  1. setup: card name and power limit, kernel build time, and ptxas's
     registers, shared memory and spills of the attention kernels'
     tensor-core and split-decode instances, of the top-k scans' list,
     key and select kernels and of the embedding bag's instances;
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
     embedding bag's one-table call (DLRM's table 0, 25M x 128 fp32, at
     B 512 and 262,144, L = 1, bit for bit; table 20 at B 4096, L = 100,
     fp32 and bf16, sum and mean; with ``--parent``, every bag call also
     held bit for bit against the earlier checkout's kernel, timed
     beside);
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
     fp32, seeded, made on the card); first its grouped bag (one launch
     over the 26 tables) at serve_p99 (512) and serve_bulk (262,144)
     against its plain version (bit for bit, NaN at the bag with id V),
     with ``--parent`` field by field against the earlier checkout's
     kernel, timed against the plain version, 26 ``F.embedding_bag``
     calls and the parent's 26 launches; then the forward at both
     shapes: logits with the kernel bags equal those with the plain
     bags bit for bit, and the CPU forward over the batch's rows within
     1e-4 of their max; FM and Wide&Deep (39M and 40M ids) at both
     shapes and BERT4Rec at serve_p99 (flash_attention, D = 32), card vs
     CPU; retrieval_cand (1 x 1,000,448, k = 100) for the four through
     topk_search, held to the plain masked top-k. Its DLRM forwards are
     the embedding bag's "launches" below (one a forward);
  8. the shard fabric on the card, against phase 4's fp32 store (the
     oracle, fed the same stream): fabric A (fp32, 8 shards, 2 replicas,
     hot_capacity 256, seals and compactions on a FabricMaintenance
     worker, the scatter on pool threads) answers phase 4's nine mixes
     at batch 1, 8, 32 (k 10) and batch 8 (k 500) equivalently, batch ==
     sequential bit for bit, no out-of-window id; again with one shard
     down (degraded, complete), during and after an online split under a
     querying thread, and after a hot segment is corrupted and
     ``repair()`` rebuilds it; one CURRENT and one HISTORICAL batch of 32
     traced (plan, shard:<id>, merge); a CPU reopen equivalent, lake by
     lake and merged; fabric B (quantized, 4 shards) at recall@10 >=
     0.99 against fabric A. Then
     ``device_fanout_topk`` over 8 shards x 2^20 rows x 384 fp32 (12.9
     GB on the card), Q 1 / 32 / 256, k 10 / 100 / 500: every shard's
     block equal to ``topk_search`` alone bit for bit, the plain version's
     rule at Q = 32, ms a call, the library's and the bound. The four
     scans' "launches" below add phase 8's to phase 4's;
  9. the LM family at full width (seeded bf16 weights made on the card):
     Qwen2-MoE-A2.7B (24 layers, 60 experts padded to 64, top 4, 4
     shared; 30.3 GB) through ``build_cell``: prefill_32k at batch 1 and
     decode_32k at batch 4 (16 steps from cache_len 32,752 over a cache
     of seeded noise, then the same 16 again with the router logged, bit
     for bit), host and event ms, tokens/s and each step's bound (the
     experts the dispatch reads, and those its tokens need); the
     prefill's cache in an int8 ``KVCacheArena`` (bytes against bf16, the
     half-step bound); one layer's MoE block: dropless against the dense
     oracle on 512 tokens (bf16 and fp32), the capacity path at 2048
     tokens against the CPU (the same dropped pairs), two runs and a
     token alone against its batch bit for bit; decode against prefill
     (fp32, 4 layers, no drops: 1024 + 8 tokens against 1032, logits
     within 1e-3 of their max abs, argmax equal, top-4 near-ties
     reported); flash_attention at (1, 16, 32768, 128) bf16 against its
     plain version on the last 256 query rows; Nemotron-4-15B (all 32
     layers), Qwen1.5-32B (16 of 64) and Kimi-K2 (1 of 61) prefill and
     decode with finite logits. Its serving runs' launches are added to
     the two attention kernels' "launches" below; a ``{"phase9": ...}``
     line gives the weight and cache bytes and every cut (``reduced``).
  10. training on the card: the two backward kernels
     (``flash_attention_bwd``, ``embedding_bag_bwd``) against their plain
     versions at the shapes of the three train cells, small fp32 cases
     at D 64 and 128 and rows that see no key (two runs of each bit for
     bit; the forward's output with its lse equal to the serving output;
     bf16 at D 64 and 128 on the tensor-core body, by its own launch
     count, with its TFLOP/s), timed against the plain versions and the
     library's backward (SDPA, 26 ``F.embedding_bag``); then the train
     cells through ``build_cell``: Mistral-NeMo-12B train_4k at full
     width, 8 of 40 layers, 3 AdamW steps of 8 x 4096 tokens in 8
     microbatches with remat (host s, tokens/s, peak memory, launches a
     step, every attention backward on the tensor cores, the step's
     bound), and one
     step at 2 layers in fp32 (1 x 512) card vs CPU; DLRM train_batch
     (65,536) over tables capped at 4M rows, 3 steps on uniform ids and
     1 on the smoke batch (every id below 3), and one step card vs CPU
     on compact tables; BERT4Rec train_batch in 256 microbatches of 256
     x 200, then a resume check (a Trainer with checkpoints: 2 steps,
     save, restore, 2 more, equal to 4 straight bit for bit). The cells'
     steps are the backward kernels' "launches" below, and add to the
     forward kernels'; a ``{"phase10": ...}`` line gives each cell's
     losses, step times, peak memory and cuts (``reduced``);
  11. SchNet's train cells on the card: ``gather_segment_sum`` against its
     plain version (forward, the gradient of x by the kernel, that of w;
     bit for bit, two runs bit for bit) at molecule (8,192 edges into
     3,840 atoms), its energy readout (D 1), minibatch_lg's smoke batch,
     a minibatch_lg batch from ``sample_subgraph`` (1,024 seeds, fanout
     15-10, over a seeded 232,965-node graph with lognormal out-degrees
     of mean 50: node 0, the padding edges' end, is hot) and a 2^22-edge
     slice of ogb_products, timed against the plain version and
     ``index_add_``; then the four cells through ``build_cell`` at their
     published sizes, three AdamW steps each (ogb_products: 2,449,056
     nodes, 61,859,328 edges, the filter network in chunks of 2^22
     edges under checkpoint), one step on the sampled batch, grads card
     vs CPU at molecule and minibatch_lg, minibatch_lg at edge_chunk
     2^14 against one chunk, a checkpointed resume at molecule and two
     ogb_products steps from one state, bit for bit. The cells' steps are
     the kernel's "launches" below; a ``{"phase11": ...}`` line gives
     each cell's losses, step times, edges a second, peak memory, the
     ogb_products step's bound and the cuts (``reduced``).
It prints a ``{"kernels": [...]}`` line, then, last, the one-line
``{"ok": true, "device": {...}}`` result. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
Imports no JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
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
    # backward kernels: repro differentiates its references with XLA
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:27 (its "
        "backward; no Pallas counterpart)"),
    "embedding_bag_bwd": (
        "src/repro_torch/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag/embedding_bag.py:20 (its "
        "backward; no Pallas counterpart)"),
    # SchNet's message passing: repro leaves it to XLA
    "gather_segment_sum": (
        "src/repro_torch/csrc/segment_sum.cu",
        "src/repro/models/schnet.py:100 (jax.ops.segment_sum; no Pallas "
        "counterpart)"),
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
                ("topk_search", "select_order_kernel"),
                ("embedding_bag", "embedding_bag_kernel"),
                ("flash_attention", "bwd_delta_kernel"),
                ("flash_attention", "bwd_dkdv_kernel"),
                ("flash_attention", "bwd_dq_kernel"),
                ("flash_attention", "bwd_prep_kernel"),
                ("flash_attention", "bwd_dkdv_wgmma_kernel"),
                ("flash_attention", "bwd_dq_wgmma_kernel"),
                ("embedding_bag", "bag_bwd_chunks"),
                ("embedding_bag", "bag_bwd_rows"),
                ("segment_sum", "gss_chunks"),
                ("segment_sum", "gss_rows"))


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


def start_phase(torch, title: str, t0: float) -> None:
    """Logs a phase's title, the seconds since ``t0`` and the host's time
    to issue one small kernel (an add on 1024 floats; the median of 5
    rounds of 200, each far below the launch queue's depth): a host
    that paces the card slows every host-bound number after it."""
    x = torch.zeros(1024, device="cuda")
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            x.add_(1.0)
        rounds.append((time.perf_counter() - t) / 200 * 1e6)
    torch.cuda.synchronize()
    log(title)
    log(f"  at {time.perf_counter() - t0:.1f} s; the host issues a small "
        f"kernel in {sorted(rounds)[2]:.2f} us")


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


def queued_ms(torch, fn, n: int):
    """Device ms a call of ``fn`` (one kernel launch) over ``n`` calls
    queued behind a sleep kernel: the events then time the card's work
    back to back, not the host's enqueueing (the gaps between launches
    included). None if the host had not queued them all before the sleep
    ended."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)                 # ~50 ms at 2 GHz
    start.record()
    for _ in range(n):
        fn()
    late = start.query()                           # the sleep ended early
    end.record()
    end.synchronize()
    return None if late else start.elapsed_time(end) / n


def bound_ms(in_bytes: int, out_bytes: int, flops: int,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class ParentKernels:
    """The four top-k scans and the embedding bag of another checkout
    (``--parent``), built with this checkout's nvcc flags into
    build/repro_torch/parent. Its scans must have this checkout's C
    interface: they run through this checkout's wrappers over the
    parent's libraries. Its csrc/embedding_bag.cu has the one-table entry
    ``embedding_bag_fwd`` (one launch a table). Called like the wrappers:
    ``parent(name, *args)`` for a scan, ``parent.bag(table, idx, w,
    combiner)`` for a bag."""

    def __init__(self, torch, root: str):
        from repro_torch.kernels import build

        self.torch = torch
        out = build.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in ("topk_search", "temporal_mask_score", "embedding_bag"):
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
            self.libs[name] = ctypes.CDLL(str(so))
        self.libs["embedding_bag"].embedding_bag_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 6
            + [ctypes.c_int, ctypes.c_void_p])

    def __call__(self, name: str, *args):
        """A scan of the parent's library through this checkout's wrapper
        (its launch counts untouched)."""
        from repro_torch.kernels import build
        from repro_torch.kernels.temporal_mask_score import ops as tops
        from repro_torch.kernels.topk_search import ops as kops

        src = "topk_search" if name.startswith("topk") else \
            "temporal_mask_score"
        mod = kops if src == "topk_search" else tops
        mine, counts = build._loaded[src], (mod.launches, mod.launches_q8)
        build._loaded[src] = self.libs[src]
        try:
            return getattr(mod, name)(*args)
        finally:
            build._loaded[src] = mine
            mod.launches, mod.launches_q8 = counts

    def bag(self, table, idx, w, combiner):
        """The parent's one-table bag: (B, D) in the table's dtype; idx
        (B, L) int32 and w (B, L) fp32 or None, rows strided as they lie
        (slots contiguous), as that checkout's wrapper passes them."""
        torch = self.torch
        (b, bag), (v, d) = idx.shape, table.shape
        out = torch.empty((b, d), dtype=table.dtype, device=table.device)

        def ld(x):
            return x.stride(0) if b > 1 else bag

        err = self.libs["embedding_bag"].embedding_bag_fwd(
            table.data_ptr(), idx.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(),
            0 if table.dtype == torch.float32 else 1, v, d, b, bag, ld(idx),
            0 if w is None else ld(w), 1 if combiner == "mean" else 0,
            torch.cuda.current_stream(table.device).cuda_stream)
        check(err == 0, f"parent embedding_bag_fwd: CUDA error {err}")
        return out


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
def store_workload():
    """The paper's corpus (100 docs x 5 versions, explicit timestamps), 50
    query texts and nine mixes: current, as of each version, two
    windows."""
    from repro_torch.data.corpus import generate_corpus

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
    return corpus, texts, mixes


def ingest_stream(target, corpus, texts, k: int) -> float:
    """Feed ``target`` (a store or a fabric) every version of the corpus
    at its timestamp, querying between versions so the later ingests land
    in a resident fused block and a resident history (device mirrors of
    memtable writes and of valid_to closures). Returns the seconds."""
    t = time.perf_counter()
    for v, t_v in enumerate(corpus.timestamps):
        for doc in corpus.doc_ids():
            target.ingest(doc, corpus.versions[v][doc], ts=t_v)
        target.query_batch(texts[:8], k=k)
        target.query_batch(texts[:8], k=k, at=t_v)
    return time.perf_counter() - t


def phase_store(torch, workdir: str, quantized: bool,
                fp32_answers: dict | None = None) -> tuple[dict, dict]:
    """Drive fp32 or quantized stores at two hot-tier capacities, with the
    launch counts of that path's kernels set to 0 before and read after.
    A quantized run is also held to ``fp32_answers`` (the fp32 run's) by
    recall@10. Returns (launches, answers)."""
    from repro_torch.core.store import LiveVectorLake
    from repro_torch.kernels.temporal_mask_score import ops as tops
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.testing import results_equivalent

    corpus, texts, mixes = store_workload()
    ts = corpus.timestamps
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
        t = ingest_stream(lake, corpus, texts, k)
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


class AttentionCheck:
    """Holds ``flash_attention`` and ``flash_decode`` against their plain
    versions on the card and times them, the plain versions and the
    library's SDPA on the same inputs. Kernel vs plain: both compute in
    fp32 from the same inputs and round to the output's dtype. Each
    output is held within rel of its own value plus 1e-4 of its row's
    largest: fp32 outputs differ by the sum order (~1e-6 relative), bf16
    outputs by at most one rounding step (2^-7 of the value). The outputs
    here are small (0.01 to 0.1 on N(0, 1) inputs), so an absolute limit
    alone would pass wrong kernels; the absolute limits stay as an outer
    bound. ``out`` maps each kernel to its largest error and its rows of
    times."""

    def __init__(self, torch, dev, seed: int):
        self.torch, self.dev = torch, dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.out = {name: {"err": 0.0, "times": []}
                    for name in ("flash_attention", "flash_decode")}
        self.tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
        self.rel = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
        self.peak = {torch.float32: FP32_FLOPS, torch.bfloat16: BF16_FLOPS}

    def randn(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen,
                                device=self.dev).to(dtype)

    def record(self, name, what, got, want, dtype, fn, plain, library,
               in_bytes, out_bytes, flops, iters, plain_iters):
        from repro_torch.testing import rounding_agree

        torch = self.torch
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        err = float((got.float() - want.float()).abs().max())
        check(err <= self.tol[dtype], f"{name} {what}: max abs err {err} > "
                                      f"{self.tol[dtype]}")
        ok, ratio = rounding_agree(got, want, self.rel[dtype])
        check(ok, f"{name} {what}: an output differs from plain by "
                  f"{ratio:.3g} x its limit ({self.rel[dtype]:.3g} of its "
                  f"value + 1e-4 of its row's largest)")
        self.out[name]["err"] = max(self.out[name]["err"], err)
        t = cuda_ms(torch, fn, iters)
        tp = cuda_ms(torch, plain, plain_iters, 1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, out_bytes, flops, self.peak[dtype])
        self.out[name]["times"].append(dict(
            what=what, dtype=str(dtype).removeprefix("torch."), ms=t,
            plain_ms=tp, library_ms=tl, bound_ms=b, bound_by=by,
            max_abs_err=err, median_abs_value=float(
                want.float().abs().median()), err_over_limit=ratio))

    def attention(self, what, shape, dtype, causal, iters, rows=None):
        """Shape (B, H, KV, Sq, Skv, D). With ``rows``, the plain version
        computes the last ``rows`` query rows only (its scores at full
        length would not fit): causal attention aligns by Skv - Sq, so
        those rows are the same with q cut to them."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_attention.plain import (
            flash_attention_plain)

        b, h, kv, sq, skv, d = shape
        q = self.randn((b, h, sq, d), dtype)
        k = self.randn((b, kv, skv, d), dtype)
        v = self.randn((b, kv, skv, d), dtype)
        qp = q if rows is None else q[:, :, -rows:]
        got = fa.flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(qp, k, v, causal)
        es = q.element_size()
        self.record("flash_attention", what, got[:, :, -qp.shape[2]:], want,
                    dtype, lambda: fa.flash_attention(q, k, v, causal=causal),
                    lambda: flash_attention_plain(qp, k, v, causal),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True),
                    (b * h * sq + 2 * b * kv * skv) * d * es,
                    b * h * sq * d * es,
                    4 * b * h * visible_pairs(sq, skv, causal) * d, iters, 2)

    def decode(self, what, shape, cache_lens, dtype, iters):
        """Shape (B, H, KV, S, D), one cache of S entries, at each of
        ``cache_lens``. The kernel's fp32 split partials are held to the
        plain partials before the shared merge (the merge would blur a
        split's error into the others); the in-library merge to
        merge_partials of the partials at the split the call chose: fp32
        within 1e-5 (other sum orders), bf16 within one rounding step of
        the merged fp32."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_decode import ops as fd
        from repro_torch.kernels.flash_decode.plain import (
            flash_decode_partials_plain, flash_decode_plain, merge_partials)
        from repro_torch.testing import partials_agree, rounding_agree

        b, h, kv, s, d = shape
        kc, vc = (self.randn((b, kv, s, d), dtype) for _ in range(2))
        for cache_len in cache_lens:
            at = f"{what} at {cache_len}" if len(cache_lens) > 1 else what
            q = self.randn((b, h, d), dtype)
            ok, ratio, why = partials_agree(
                fd.flash_decode_partials(q, kc, vc, cache_len, 512),
                flash_decode_partials_plain(q, kc, vc, cache_len, 512), 1e-4)
            check(ok, f"flash_decode {at}: split partials vs plain: {why}")
            log(f"  flash_decode {at}: partials (m, l, acc) within "
                f"{ratio:.3g} x their 1e-4 limits")
            got = fd.flash_decode(q, kc, vc, cache_len=cache_len)
            want = flash_decode_plain(q, kc, vc, cache_len, 512)
            split = fd.choose_split(kv, cache_len, self.sms)
            merged = merge_partials(*fd.flash_decode_partials(
                q, kc, vc, cache_len, split))
            ok, ratio = (rounding_agree(got, merged, 1e-5, 1e-5)
                         if dtype == self.torch.float32 else
                         rounding_agree(got, merged.to(dtype),
                                        self.rel[dtype]))
            check(ok, f"flash_decode {at}: merge differs from "
                      f"merge_partials by {ratio:.3g} x its limit")
            log(f"  flash_decode {at}: split {split} rows, in-library merge "
                f"within {ratio:.3g} x its limit of merge_partials")
            es = q.element_size()
            self.record(
                "flash_decode", at, got, want, dtype,
                lambda: fd.flash_decode(q, kc, vc, cache_len=cache_len),
                lambda: flash_decode_plain(q, kc, vc, cache_len, 512),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kc[:, :, :cache_len],
                    vc[:, :, :cache_len], enable_gqa=True),
                (b * h * d + 2 * b * kv * cache_len * d) * es,
                b * h * d * es, 4 * b * h * cache_len * d, iters, 3)

    def log_rows(self) -> None:
        for name, r in self.out.items():
            for row in r["times"]:
                log(f"  {name}: " + " ".join(
                    f"{key}={val:.4g}" if isinstance(val, float) else
                    f"{key}={val}" for key, val in row.items()))
            log(f"  {name}: max_abs_err={r['err']:.3g}")


def phase_attention(torch, dev) -> dict:
    # (what, (B, H, KV, Sq, Skv, D), dtype, causal): the MiniLM encoder at
    # the main path's chunk x 8; BERT4Rec's serve_p99 batch (200 tokens:
    # both tiles ragged); Mistral-NeMo's RAG prefill; a prefill_32k layer
    # cut to 4096 tokens
    att = AttentionCheck(torch, dev, SEED + 2)
    for what, shape, dtype, causal, iters in (
            ("minilm encode 256x128", (256, 12, 12, 128, 128, 32),
             torch.float32, False, 20),
            ("bert4rec serve_p99 512x200", (512, 2, 2, 200, 200, 32),
             torch.float32, False, 20),
            ("nemo prefill 256", (1, 32, 8, 256, 256, 128), torch.bfloat16,
             True, 50),
            ("nemo prefill 4096", (1, 32, 8, 4096, 4096, 128),
             torch.bfloat16, True, 5)):
        att.attention(what, shape, dtype, causal, iters)
    # (what, (B, H, KV, S, D), cache_lens, dtype): the engine's cache
    # (max_prompt 256 + 64) after 15 decode steps; decode_32k at full and
    # partial length, in bf16, and in fp32
    for what, shape, cache_lens, dtype, iters in (
            ("engine cache 320", (1, 32, 8, 320, 128), (271,),
             torch.bfloat16, 50),
            ("decode_32k", (16, 32, 8, 32768, 128), (32768, 30000),
             torch.bfloat16, 20),
            ("decode_32k partial fp32", (16, 32, 8, 32768, 128), (30000,),
             torch.float32, 10)):
        att.decode(what, shape, cache_lens, dtype, iters)
        torch.cuda.empty_cache()
    att.log_rows()
    return att.out


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


def same_bits(torch, a, b) -> bool:
    """``a`` and ``b`` equal bit for bit, NaNs included."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(ints[a.dtype]),
                            b.contiguous().view(ints[b.dtype])))


def phase_embedding_bag(torch, dev, parent=None) -> dict:
    """The kernel's one-table call against its plain version at the
    recsys path's shapes: DLRM's table 0 (25,000,192 x 128 fp32 after the
    one-card cap) at serve_p99 and serve_bulk (L = 1), and table 20
    (11,316,992 x 128) at the widest bag of MLPerf's multi-hot DLRM (L =
    100), fp32 and bf16; with ``parent``, every call also against the
    parent checkout's kernel, bit for bit, and timed beside."""
    import torch.nn.functional as F

    from repro_torch.configs.dlrm_mlperf import ONE_CARD
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.plain import embedding_bag_plain
    from repro_torch.models.recsys import table_init
    from repro_torch.testing import rounding_agree

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {"embedding_bag": {"err": 0.0, "times": []}}
    sizes = ONE_CARD.padded_table_sizes
    held = {"parent": 0}

    def hold(what, table, idx, w, combiner):
        got = eb.embedding_bag(table, idx, w, combiner)
        want = embedding_bag_plain(table, idx, w, combiner)
        if parent is not None:
            check(same_bits(torch, got, parent.bag(table, idx, w, combiner)),
                  f"embedding_bag {what}: differs from the parent's kernel")
            held["parent"] += 1
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
        row = dict(what=what, B=b, L=bag, ms=t, plain_ms=tp, library_ms=tl,
                   bound_ms=bnd, bound_by=by, device_ms=queued_ms(
                       torch, lambda: eb.embedding_bag(table, *nxt(),
                                                       combiner), iters))
        if parent is not None:
            row["parent_ms"] = cuda_ms(
                torch, lambda: parent.bag(table, *nxt(), combiner), iters)
        out["embedding_bag"]["times"].append(row)

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
    if parent is not None:
        log(f"  {held['parent']} embedding_bag calls equal the parent's "
            f"kernel bit for bit")
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


def phase_decode_vs_prefill(torch, cfg, prompt: int, steps: int,
                            seeds: tuple, router: bool = False) -> None:
    """Prefill ``prompt`` tokens and decode ``steps`` given tokens, against
    one prefill of all of them, at a full-width config cut in depth and
    widened to fp32: the two attention kernels (and a MoE config's
    capacity and dropless dispatches) held against each other. With
    ``router``, every top-k boundary within 1e-5 in router probability
    is logged: a near-tie that flips would break the rule."""
    import contextlib

    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)

    n_all = prompt + steps
    params = init_params(cfg, seed=seeds[0], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seeds[1])
    toks = torch.randint(4, cfg.vocab, (1, n_all), generator=gen,
                         device="cuda")
    with torch.no_grad(), (RouterLog() if router
                           else contextlib.nullcontext()) as log_r:
        _, cache, n = prefill(params, toks[:, :prompt], cfg, n_all)
        for i in range(prompt, n_all):
            logits, cache, n = decode_step(params, toks[:, i:i + 1], cache,
                                           n, cfg)
        want, _, _ = prefill(params, toks, cfg, n_all)
    scale = float(want.abs().max())
    err = float((logits - want).abs().max())
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(err <= 1e-3 * scale, f"decode vs prefill: max abs err {err} > "
                               f"1e-3 x {scale}")
    check(bool((logits.argmax(-1) == want.argmax(-1)).all()),
          "decode vs prefill: argmax differs")
    ties = ""
    if router:
        near = log_r.near_ties()
        ties = (f"; top-{cfg.moe.top_k} boundaries within 1e-5 in router "
                f"probability: {len(near)} {near[:8]}")
    log(f"  decode vs prefill (full width, fp32, {cfg.n_layers} layers, "
        f"{prompt} + {steps} tokens): max abs logit err {err:.3g} of max "
        f"|logit| {scale:.3g}; argmax equal{ties}")
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


L2_BYTES = 50e6        # H100 SXM L2


def dlrm_bags(torch, params, cfg, shape: str, ids: list, iters: int,
              plain_iters: int, parent=None) -> dict:
    """The grouped bag over DLRM's 26 tables at a serving shape (``ids``:
    batches of (B, 26, L) ids), as the forward calls it: held against its
    plain version on the first batch with bag 0 all padding and the id V
    in bag 1 of field 5 (bit for bit at L = 1, NaN at exactly that bag);
    with ``parent``, the 26 fields of that batch and of the batch as
    drawn against the parent's kernel bit for bit. Timed between CUDA
    events (a batch a call in turn): the kernel into the feature stack,
    its plain version, the library (26 ``F.embedding_bag`` calls in one
    timed region) and the parent's 26 launches. The bound counts a table
    of at most 50 MB (it stays in L2) at most its size once, and a larger
    one every valid row it reads, plus the ids read and the bags
    written. Returns the timing row."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.plain import (
        embedding_bag_grouped_plain)

    tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
    b, f, bag = ids[0].shape
    d, es = cfg.embed_dim, tables[0].element_size()
    probe = ids[0].clone()
    probe[0] = -1
    probe[1, 5, 0] = tables[5].shape[0]
    got = eb.embedding_bag_grouped(tables, probe)
    want = embedding_bag_grouped_plain(tables, probe)
    nan = torch.isnan(want).any(2)
    check(torch.equal(torch.isnan(got).any(2), nan)
          and bool(torch.isnan(got[nan]).all()) and int(nan.sum()) == 1
          and bool(nan[1, 5]), f"grouped embedding_bag {shape}: NaN bags "
                               f"differ from the bag with id V")
    check(bool((got[0] == 0).all()), f"grouped embedding_bag {shape}: the "
                                     f"all-padding bags are not 0")
    # one-hot (L = 1): one product rounded once either way
    check(bag == 1 and torch.equal(got[~nan], want[~nan]),
          f"grouped embedding_bag {shape}: not bit for bit with plain")
    del want
    if parent is not None:
        for x in (probe, ids[0]):
            got = eb.embedding_bag_grouped(tables, x)
            for i, t in enumerate(tables):
                check(same_bits(torch, got[:, i], parent.bag(
                    t, x[:, i], None, "sum")), f"grouped embedding_bag "
                                               f"{shape}: field {i} differs "
                                               f"from the parent's kernel")
        log(f"  grouped embedding_bag {shape}: the 26 fields equal the "
            f"parent's kernel bit for bit")
    del got, probe
    turn = {"i": 0}

    def nxt(of=ids):
        turn["i"] = (turn["i"] + 1) % len(of)
        return of[turn["i"]]

    feats = torch.empty((b, f + 1, d), dtype=tables[0].dtype,
                        device=tables[0].device)
    t = cuda_ms(torch, lambda: eb.embedding_bag_grouped(
        tables, nxt(), None, "sum", out=feats[:, 1:]), iters)
    tp = cuda_ms(torch, lambda: embedding_bag_grouped_plain(
        tables, nxt(), None, "sum", feats[:, 1:]), plain_iters, 1)
    del feats
    # the library call's inputs made once (every id of a batch is valid)
    lib = [[x[:, i].contiguous() for i in range(f)] for x in ids]

    def library():
        return [F.embedding_bag(x, tb, mode="sum")
                for x, tb in zip(nxt(lib), tables)]

    tl = cuda_ms(torch, library, iters, 1)
    del lib
    row = {"what": f"grouped {shape}", "B": b, "L": bag, "F": f, "ms": t,
           "plain_ms": tp, "library_ms": tl}
    if parent is not None:
        row["parent_ms"] = cuda_ms(torch, lambda: [
            parent.bag(tb, x, None, "sum")
            for tb, x in zip(tables, nxt().unbind(1))], iters)
    in_bytes, n_valid = b * f * bag * 4, 0
    for i, tb in enumerate(tables):
        x = ids[0][:, i]
        rows = int(((x >= 0) & (x < tb.shape[0])).sum())
        n_valid += rows
        size = tb.numel() * es
        in_bytes += min(size, rows * d * es) if size <= L2_BYTES else (
            rows * d * es)
    row["bound_ms"], row["bound_by"] = bound_ms(in_bytes, b * f * d * es,
                                                2 * n_valid * d)
    log("  embedding_bag: " + " ".join(
        f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
        for key, val in row.items()))
    return row


def phase_recsys(torch, dev, parent=None) -> tuple[int, list]:
    """DLRM at MLPerf widths over the one-card tables (58.3 GB fp32),
    then FM, Wide&Deep and BERT4Rec at full width, then retrieval_cand
    for the four, all through ``launch/steps.build_cell``'s functions.
    Returns the embedding bag's launches on the DLRM serving path and
    the grouped bag's timing rows (``dlrm_bags``)."""
    from repro_torch.configs.bert4rec import CONFIG as B4R
    from repro_torch.configs.dlrm_mlperf import ONE_CARD
    from repro_torch.configs.fm import CONFIG as FM
    from repro_torch.configs.wide_deep import CONFIG as WD
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.plain import (
        embedding_bag_grouped_plain)
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

    def dlrm_ids(b):
        # each field draws from its own table (repro's smoke batches draw
        # every field from min(table_sizes) = 3 rows, all in L2)
        return torch.stack([torch.randint(0, v, (b,), generator=gen,
                                          device=dev, dtype=torch.int32)
                            for v in cfg.table_sizes], dim=1)[..., None]

    def dlrm_batch(b):
        return {"dense": torch.rand((b, cfg.n_dense), generator=gen,
                                    device=dev),
                "sparse_ids": dlrm_ids(b)}

    bag_rows = []
    for shape, n_batches, iters, plain_iters in (
            ("serve_p99", 20, 50, 3), ("serve_bulk", 2, 5, 2)):
        b = batch_size(build_cell("dlrm-mlperf", shape, device=dev))
        bag_rows.append(dlrm_bags(torch, params, cfg, shape,
                                  [dlrm_ids(b) for _ in range(n_batches)],
                                  iters, plain_iters, parent))
        torch.cuda.empty_cache()

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
                                        bag=embedding_bag_grouped_plain)
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
            log(f"  DLRM {shape} batch: the grouped embedding_bag kernel "
                f"{bags:.4f} ms of {busy:.4f} ms device busy "
                f"({bags / busy:.1%}); the rest (MLPs, interaction) "
                f"{busy - bags:.4f} ms")
        del batches
    launches = eb.launches
    check(launches == forwards,
          f"DLRM: {launches} embedding_bag launches for {forwards} forwards "
          f"(one a forward, over its {cfg.n_sparse} tables)")
    log(f"  launches on the DLRM serving path: embedding_bag {launches} "
        f"(one a forward over {cfg.n_sparse} tables, {forwards} forwards)")
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
    return launches, bag_rows


# ---------------------------------------------------------------------------
# phase 8: the shard fabric on the card
# ---------------------------------------------------------------------------
FANOUT_SHAPE = (8, 1 << 20)    # device_fanout_topk: shards x rows a shard
FANOUT_DEAD = 0.125            # share of each shard's rows masked dead


def hot_segment_files(store) -> list[str]:
    import glob
    import os
    return sorted(glob.glob(os.path.join(store.root, "hot_index",
                                         "seg-*.npz")))


def phase_fabric(torch, work: str, dev) -> dict:
    """Phase 8, first part: ``ShardFabric``s of card-resident shard lakes
    against one ``LiveVectorLake`` fed the same stream (phase 4's fp32
    store at hot_capacity 4096, reopened when this run made it). The four
    scans' launch counts are set to 0 once the oracle's answers are taken
    and read at the end. Returns those launches."""
    import threading

    from repro_torch.core.store import LiveVectorLake
    from repro_torch.kernels.temporal_mask_score import ops as tops
    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.obs import REGISTRY, trace
    from repro_torch.serve.maintenance import FabricMaintenance
    from repro_torch.shard import Rebalancer, ShardFabric
    from repro_torch.testing import FAULTS, results_equivalent
    from repro_torch.testing.faults import corrupt_file

    corpus, texts, mixes = store_workload()
    ts = corpus.timestamps
    k, big = 10, 500
    oracle = LiveVectorLake(f"{work}/lake-fp32-4096", hot_capacity=4096,
                            device=dev)
    if len(oracle.hot) == 0:                 # phase 4 did not run here
        t = ingest_stream(oracle, corpus, texts, k)
        log(f"  oracle: ingested in {t:.1f} s")
    want = {name: {kk: oracle.query_batch(texts, k=kk, **kw)
                   for kk in (k, 4 * k)} for name, kw in mixes}
    want_big = {name: {kk: oracle.query_batch(texts[:8], k=kk, **kw)
                       for kk in (big, 4 * big)} for name, kw in mixes}

    def equivalent(name, kw, res, kk, what):
        ref = want[name] if kk == k else want_big[name]
        for qi, r in enumerate(res):
            check(results_equivalent(ref[kk][qi], r, ref[4 * kk][qi],
                                     rtol=1e-5, atol=1e-5),
                  f"{what} {name} k={kk} query {qi}: not equivalent to "
                  f"the oracle")
            if "at" in kw:                   # no out-of-window id
                oracle.temporal.assert_no_leakage(r, kw["at"])
            elif "window" in kw:
                oracle.temporal.assert_no_window_leakage(r, *kw["window"])

    def hold(fab, what, seq=False):
        """Every mix at batch 1, 8 and 32 (k 10) and at batch 8 with k 500
        (the radix select) against the oracle; with ``seq`` also
        query_batch == [query] bit for bit."""
        for name, kw in mixes:
            for bs in (1, 8, 32):
                res = fab.query_batch(texts[:bs], k=k, **kw)
                equivalent(name, kw, res, k, f"{what} batch={bs}")
            if seq:
                check(res == [fab.query(x, k=k, **kw) for x in texts[:32]],
                      f"{what} {name}: query_batch != [query]")
            equivalent(name, kw, fab.query_batch(texts[:8], k=big, **kw),
                       big, f"{what} batch=8")

    def counts() -> dict:
        return {"topk_search": kops.launches,
                "temporal_window_topk": tops.launches,
                "topk_search_q8": kops.launches_q8,
                "temporal_window_topk_q8": tops.launches_q8}

    kops.launches = kops.launches_q8 = 0
    tops.launches = tops.launches_q8 = 0

    # -- fabric A: fp32, 8 shards, 2 replicas, small hot tiers sealed and
    #    compacted by the maintenance worker, the scatter on pool threads
    root_a = f"{work}/fabric-a"
    fab = ShardFabric(root_a, n_shards=8, replicas=2, hot_capacity=256,
                      shard_timeout_s=120.0, device=dev)
    maint = FabricMaintenance(fab).start()
    t = ingest_stream(fab, corpus, texts, k)
    check(maint.drain(timeout=300.0), "fabric A: maintenance did not drain")
    jobs = REGISTRY.counter("maintenance_jobs", worker=maint.worker.name)
    log(f"  fabric A (fp32, S=8, R=2, hot_capacity=256): ingested "
        f"{corpus.n_docs} docs x {len(ts)} versions in {t:.1f} s; "
        f"{int(jobs.value)} maintenance jobs on the worker thread")
    check(jobs.value > 0 and maint.worker.last_error is None,
          f"fabric A: maintenance jobs {jobs.value}, last error "
          f"{maint.worker.last_error}")
    seals = 0
    for sid in fab.ring.shards:
        st = fab.lake(sid).store
        check(st.device.type == dev.type, f"{sid} is not on {dev}")
        hs = st.hot.index.stats()
        seals += hs["seals"]
        log(f"    {sid}: {len(st.hot)} live chunks, {hs['seals']} seals, "
            f"{hs['segments']} segments ({hs['partitioned_segments']} "
            f"IVF), {hs['tombstones']} tombstones, {hs['merges']} merges")
    check(seals > 0, "fabric A: no lake sealed")
    before = counts()
    hold(fab, "fabric A", seq=True)
    for name in ("topk_search", "temporal_window_topk"):
        check(counts()[name] > before[name],
              f"fabric A: {name} was never launched")
    fp32 = {name: fab.query_batch(texts, k=k, **kw) for name, kw in mixes}

    # drill 1: one shard down; R = 2 still covers every record
    dead = fab.ring.shards[1]
    FAULTS.arm(f"shard:{dead}:query", times=10**9)
    try:
        hold(fab, f"fabric A with {dead} down")
        lg = fab.planner.last_gather
        check(lg["degraded"] and lg["complete"]
              and lg["shards_missing"] == [dead],
              f"fabric A with {dead} down: gather {lg}")
    finally:
        FAULTS.reset()
    log(f"  drill: {dead} down: degraded and complete, equivalent")

    # drill 2: an online split while a thread keeps querying
    epoch = fab.manifest.load()["epoch"]
    stop, bad, served = threading.Event(), [], [0]

    def reader():
        i = 0
        try:
            while not stop.is_set():
                name, kw = mixes[i % len(mixes)]
                i += 1
                res = fab.query_batch(texts[:8], k=k, **kw)
                for qi, r in enumerate(res):
                    if not results_equivalent(
                            want[name][k][qi], r, want[name][4 * k][qi],
                            rtol=1e-5, atol=1e-5):
                        bad.append(f"{name} query {qi}")
                served[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            bad.append(f"{type(e).__name__}: {e}")

    th = threading.Thread(target=reader)
    th.start()
    t = time.perf_counter()
    try:
        rep = Rebalancer(fab).split("s08")
    finally:
        t = time.perf_counter() - t
        stop.set()
        th.join(300.0)
    check(not th.is_alive(), "split drill: the query thread hung")
    check(not bad, f"split drill: answers during the split: {bad[:5]}")
    maint.attach("s08")
    state = fab.manifest.load()
    check(state["transition"] is None and state["epoch"] > epoch,
          f"split drill: transition {state['transition']}, epoch "
          f"{epoch} -> {state['epoch']}")
    hold(fab, "fabric A after the split")
    log(f"  drill: split s08 in {t:.1f} s ({rep['docs_copied']} docs "
        f"copied, epoch {epoch} -> {state['epoch']}), {served[0]} "
        f"batches answered during it, all equivalent")

    # drill 3: a hot segment corrupted on disk, found by the scrubber,
    # rebuilt from cold authority by repair()
    check(maint.drain(timeout=300.0), "fabric A: maintenance did not drain")
    victim = next(sid for sid in fab.ring.shards
                  if hot_segment_files(fab.lake(sid).store))
    st = fab.lake(victim).store
    check(corrupt_file(hot_segment_files(st)[0], "bitflip"),
          "drill: corrupt_file failed")
    st.scrubber.repair_hot = False           # leave the rebuild to repair
    check(st.scrubber.scrub_full()["corrupt"] >= 1,
          "drill: the scrubber missed the corrupted hot segment")
    rep = fab.repair()
    check(rep["shards"][victim]["hot_rebuilt"] and not rep["unrepairable"]
          and not st.integrity.degraded(), f"drill: repair {rep}")
    hold(fab, f"fabric A after repairing {victim}")
    log(f"  drill: {victim}'s hot segment corrupted, quarantined, rebuilt "
        f"by repair(): equivalent")

    # the first traced fabric batches: host ms of plan, shard:<id>, merge
    for intent, kw in (("current", {}), ("historical", {"at": ts[2] + 1})):
        with trace(f"fabric:{intent}") as root:
            fab.query_batch(texts[:32], k=k, **kw)
        plan, merge = root.find("plan")[0], root.find("merge")[0]
        sh = sorted((sp.wall_ms, sp.name) for sp in root.find_prefix("shard:"))
        kern = sum(sp.wall_ms for sp in root.find_prefix("kernel:"))
        log(f"  traced {intent} batch of 32: {root.wall_ms:.3f} ms; plan "
            f"{plan.wall_ms:.3f}, merge {merge.wall_ms:.3f}; "
            f"{len(sh)} shard spans {sh[0][0]:.3f}-{sh[-1][0]:.3f} ms "
            f"(sum {sum(x for x, _ in sh):.3f}); kernel spans (synchronized) "
            f"sum {kern:.3f} ms")
        log("    " + ", ".join(f"{n} {x:.3f}" for x, n in sorted(
            sh, key=lambda p: p[1])))

    # the CPU reopen: every lake (the split's sources purged docs, its
    # destination imported them, repair() rebuilt a hot tier: the device
    # mirrors must have followed) and the fabric answer as on the card.
    # A lake's current rows may hold docs it no longer owns: a purged
    # doc comes back when a hot tier is re-derived from the cold history
    # the lake keeps (on reopen, or by rebuild_hot), in repro too, and
    # the planner's ownership filter drops it. So a lake's current
    # answers are compared over the docs it owns, both sides taken at a
    # depth of `deep` and filtered by the ring; temporal answers include
    # the purged docs' history on both sides and are compared whole.
    deep = 200

    def lake_answers(fabric, sid, kw):
        if sid is None:
            return fabric.query_batch(texts, k=4 * k, **kw), 0
        got = fabric.lake(sid).query_batch(texts, k=4 * k if kw else deep,
                                           **kw)
        if kw:
            return got, 0
        own = [[r for r in res if sid in fabric.ring.owners(r.doc_id)]
               for res in got]
        return own, sum(len(a) - len(b) for a, b in zip(got, own))

    sids = [*fab.ring.shards, None]
    card = {(sid, name): lake_answers(fab, sid, kw)[0]
            for sid in sids for name, kw in mixes}
    maint.stop()
    del fab, maint, st
    cpu = ShardFabric(root_a, device="cpu")
    foreign = 0
    for sid in sids:
        for name, kw in mixes:
            got, n = lake_answers(cpu, sid, kw)
            foreign += n
            for qi, ext in enumerate(got):
                check(results_equivalent(ext[:k], card[sid, name][qi][:k],
                                         ext[:4 * k], rtol=1e-5, atol=1e-5),
                      f"fabric A {sid or 'merged'} {name} query {qi}: "
                      f"card != cpu reopen")
    del cpu
    log(f"  fabric A reopened on the CPU: each of its {len(sids) - 1} "
        f"lakes (current answers over the docs it owns; {foreign} rows "
        f"of docs it does not own in the reopened lakes' answers at "
        f"depth {deep}) and the fabric equivalent")

    # -- fabric B: quantized, 4 shards, 1 replica, exact-size hot tiers
    before = counts()
    fab_b = ShardFabric(f"{work}/fabric-b", n_shards=4, hot_capacity=4096,
                        quantized=True, device=dev)
    t = ingest_stream(fab_b, corpus, texts, k)
    hits = total = 0
    for name, kw in mixes:
        for a, b in zip(fp32[name], fab_b.query_batch(texts, k=k, **kw)):
            ids = {r.chunk_id for r in a}
            hits += len(ids & {r.chunk_id for r in b})
            total += len(ids)
    log(f"  fabric B (quantized, S=4, R=1, hot_capacity=4096): ingested in "
        f"{t:.1f} s; recall@10 against fabric A {hits / total:.4f}")
    check(hits / total >= 0.99, f"fabric B: recall@10 {hits / total} < 0.99")
    for name in ("topk_search_q8", "temporal_window_topk_q8"):
        check(counts()[name] > before[name],
              f"fabric B: {name} was never launched")
    del fab_b, oracle
    launches = counts()
    log(f"  launches on the fabric path: {launches}")
    return launches


def phase_fanout(torch, dev, launches: dict) -> None:
    """Phase 8, second part: ``device_fanout_topk`` over S shards of N rows
    x D fp32 made on the card, FANOUT_DEAD of each shard's rows masked
    dead: each shard's block equals a lone ``topk_search`` on it bit for
    bit, and at Q = 32 the plain version by phase 2's rule. Its launches
    (not those of the comparisons or the timing) are added to
    ``launches``; logs ms a call, the library's and the bound."""
    import numpy as np

    from repro_torch.kernels.topk_search import ops as kops
    from repro_torch.kernels.topk_search.plain import topk_search_plain
    from repro_torch.shard import device_fanout_topk as fanout
    from repro_torch.testing import topk_agree

    n_shards, n = FANOUT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    emb = torch.empty((n_shards, n, D), dtype=torch.float32, device=dev)
    for si in range(n_shards):
        emb[si] = unit_rows(torch, gen, n, D, dev)
    mask = torch.rand((n_shards, n), generator=gen, device=dev) >= FANOUT_DEAD
    live = int(mask.sum())
    log(f"  device_fanout_topk: {n_shards} x {n} x {D} fp32 "
        f"({emb.numel() * 4 / 1e9:.2f} GB on the card), {live} rows alive")
    for nq in (1, 32, 256):
        q = unit_rows(torch, gen, nq, D, dev)
        q_np = q.cpu().numpy()
        for k in (10, 100, 500):
            before = kops.launches
            s, i = fanout(q_np, emb, mask, k)
            nl = kops.launches - before
            launches["topk_search"] += nl
            check(s.shape == (n_shards, nq, k) and s.dtype == np.float32
                  and i.dtype == np.int32, f"fanout Q={nq} k={k}: "
                                           f"{s.shape} {s.dtype} {i.dtype}")
            saved = kops.launches, kops.launches_q8
            for si in range(n_shards):           # the same kernel, alone
                ls, li = kops.topk_search(q, emb[si], mask[si], k)
                check(np.array_equal(ls.cpu().numpy().view(np.int32),
                                     s[si].view(np.int32))
                      and np.array_equal(li.cpu().numpy(), i[si]),
                      f"fanout Q={nq} k={k} shard {si}: differs from "
                      f"topk_search alone")
                if nq == 32:
                    ws, wi = topk_search_plain(q, emb[si], mask[si], k + 1)
                    ok, err, why = topk_agree(s[si], i[si], ws, wi,
                                              score_atol=1e-4, gap=1e-5)
                    check(ok, f"fanout Q={nq} k={k} shard {si}: {why}")
            kops.launches, kops.launches_q8 = saved

            def library():
                for si in range(n_shards):
                    torch.topk(torch.matmul(q, emb[si].T).masked_fill(
                        ~mask[si], -math.inf), k, dim=1)

            ms = cuda_ms(torch, lambda: fanout(q_np, emb, mask, k), 5, 1)
            kops.launches, kops.launches_q8 = saved
            lib_ms = cuda_ms(torch, library, 5, 1)
            b, by = bound_ms(live * D * 4 + n_shards * n + nq * D * 4,
                             n_shards * nq * k * 8, 2 * nq * live * D)
            log(f"  fanout Q={nq} k={k}: {nl} launches a call, "
                f"{ms:.4f} ms a call (events), library {lib_ms:.4f}, "
                f"bound {b:.4f} ({by}); every shard bit for bit with "
                f"topk_search alone" + ("; plain rule held" if nq == 32
                                        else ""))
    del emb, mask


# ---------------------------------------------------------------------------
# phase 9: the LM family's serving cells at full width
# ---------------------------------------------------------------------------
# bf16 rule for outputs rounded at many points (the expert GEMMs, the
# activation, each partial sum of the MoE combine): one rounding step of
# each value plus 2**-5 of its row's largest
BF16_MOE = dict(rel=2 ** -7, slack=2 ** -5)
# the capacity path, card against CPU (the same code; cuBLAS and the CPU's
# BLAS sum in other orders, and bf16 rounds each partial result): fp32
# (weights widened) at 1e-4; bf16 at one rounding step of each value plus
# one of its row's largest, the tightest power-of-two slack with room
# (PERF.md section 2). Each is also read at every slack of SLACK_LADDER,
# the first being the one-rounding rule's
CAPACITY_RULES = {"bfloat16": dict(rel=2 ** -7, slack=2 ** -7),
                  "float32": dict(rel=1e-4, slack=1e-4)}
SLACK_LADDER = (1e-4, 2 ** -10, 2 ** -8, 2 ** -7, 2 ** -6, 2 ** -5)
QWEN_MOE = "qwen2-moe-a2.7b"
MOE_TOKENS = (512, 2048)        # phase 9's MoE block: dropless, capacity
# (arch, layers kept or None for all, prefill tokens, decode steps)
OTHER_LMS = (("nemotron-4-15b", None, 4096, 8), ("qwen1.5-32b", 16, 1024, 1),
             ("kimi-k2-1t-a32b", 1, 1024, 1))


def timed(torch, fn):
    """(fn(), host ms, CUDA-event ms, issue ms): the host clock around the
    call and a synchronize, the events around the call on the current
    stream, the host clock until the call returned (the time the host
    spends issuing its work; equal to the host ms when the host paces
    the card)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    a.record()
    res = fn()
    issue = time.perf_counter() - t
    b.record()
    torch.cuda.synchronize()
    return (res, (time.perf_counter() - t) * 1e3, a.elapsed_time(b),
            issue * 1e3)


def dense_macs(cfg) -> int:
    """Multiply-adds a token spends in the layers outside the routed
    experts: attention projections, router and shared experts (or the
    MLP)."""
    d, dh = cfg.d_model, cfg.d_head
    gated = 2 if cfg.act in ("swiglu", "geglu") else 1
    per_layer = d * dh * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * dh * d
    if cfg.moe:
        fs = cfg.moe.n_shared * cfg.moe.d_ff
        per_layer += d * cfg.moe.n_experts + d * fs * gated + fs * d
    else:
        per_layer += d * cfg.d_ff * gated + cfg.d_ff * d
    return cfg.n_layers * per_layer


def expert_macs(cfg) -> int:
    """Multiply-adds of one routed expert for one token (its weights)."""
    d, f = cfg.d_model, cfg.moe.d_ff
    return d * f * (2 if cfg.act in ("swiglu", "geglu") else 1) + f * d


def weight_bytes(cfg, experts: int) -> int:
    """bf16 weights a step reads once: the layers' dense part (the
    router in fp32), ``experts`` routed experts summed over the layers,
    the head (and the embedding rows, left out)."""
    return 2 * (dense_macs(cfg) + experts * expert_macs(cfg)
                + cfg.d_model * cfg.vocab) \
        + 2 * cfg.n_layers * cfg.d_model * cfg.moe.n_experts


def decode_bound(cfg, b: int, cache_len: int, experts_read: int
                 ) -> tuple[float, str]:
    """Least time of one bf16 decode step of ``b`` tokens at
    ``cache_len``: the weights once (``experts_read`` routed experts over
    all layers), the cache's K and V once, the new entries and the fp32
    logits written; against the step's products (each token's top-k
    experts, its attention over cache_len + 1 entries, the head)."""
    kv = cfg.n_layers * b * cfg.n_kv * cfg.d_head * 2 * 2   # K + V
    flops = 2 * b * (dense_macs(cfg) + cfg.n_layers * cfg.moe.top_k
                     * expert_macs(cfg) + cfg.d_model * cfg.vocab) \
        + 4 * b * cfg.n_heads * (cache_len + 1) * cfg.d_head * cfg.n_layers
    return bound_ms(weight_bytes(cfg, experts_read) + kv * cache_len,
                    kv + b * cfg.vocab * 4, flops, BF16_FLOPS)


def prefill_bound(cfg, s: int, expert_rows: int) -> tuple[float, str]:
    """Least time of a bf16 prefill of one sequence of ``s`` tokens: every
    weight once, the cache and the last position's logits written;
    against its products, the routed experts counted over
    ``expert_rows`` rows a layer (the tokens' s * k assignments, or the
    capacity buffer's padded rows), causal attention's s(s+1)/2 pairs a
    head, the head for the last position."""
    cache = cfg.n_layers * cfg.n_kv * s * cfg.d_head * 2 * 2
    flops = 2 * s * dense_macs(cfg) + 2 * cfg.d_model * cfg.vocab \
        + cfg.n_layers * (4 * cfg.n_heads * s * (s + 1) // 2 * cfg.d_head
                          + 2 * expert_rows * expert_macs(cfg))
    return bound_ms(weight_bytes(cfg, cfg.n_layers * cfg.moe.n_experts)
                    + s * 4, cache + cfg.vocab * 4, flops, BF16_FLOPS)


class RouterLog:
    """Wraps the transformer's ``moe_block`` while it is entered: logs
    each layer's top-k expert ids and the smallest gap in router
    probability between a token's k-th and (k+1)-th expert."""

    def __init__(self):
        from repro_torch.models import moe as pm
        from repro_torch.models import transformer as tfm
        self.pm, self.tfm, self.calls = pm, tfm, []

    def __enter__(self):
        pm, orig = self.pm, self.tfm.moe_block
        self.orig = orig

        def logged(p, x, cfg, dropless=False):
            probs, _, ids = pm._route(p, x.reshape(-1, x.shape[-1]), cfg)
            top, _ = pm._top_k(probs, cfg.top_k + 1)
            self.calls.append((ids, top[:, -2] - top[:, -1]))
            return orig(p, x, cfg, dropless)

        self.tfm.moe_block = logged
        return self

    def __exit__(self, *exc):
        self.tfm.moe_block = self.orig

    def distinct_experts(self) -> int:
        """Experts the logged calls' tokens need, summed over calls."""
        return sum(int(ids.unique().numel()) for ids, _ in self.calls)

    def near_ties(self, eps: float = 1e-5) -> list:
        """(call, token, gap) of every top-k boundary within ``eps``."""
        out = []
        for i, (_, gap) in enumerate(self.calls):
            for tok in (gap < eps).nonzero()[:, 0].tolist():
                out.append((i, tok, float(gap[tok])))
        return out


def phase_lm_serving(torch, dev, reduced: list) -> tuple:
    """Qwen2-MoE-A2.7B at full width and depth (24 layers, bf16) through
    ``build_cell``: prefill_32k at batch 1, its cache into an int8
    ``KVCacheArena``, then decode_32k at batch 4: 16 steps from cache_len
    32,752 over a cache of seeded bf16 noise, then the same 16 steps again
    with the router logged, bit for bit. Returns the model's params, the
    main path's launches of the two attention kernels, and the bytes of
    the weights and caches."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.moe import ROWS, capacity, padded_experts
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.kv_cache import (CacheConfig, KVCacheArena,
                                            dequantize_kv)

    pre = build_cell(QWEN_MOE, "prefill_32k", device=dev)
    dec = build_cell(QWEN_MOE, "decode_32k", device=dev)
    cfg = pre.model_cfg
    s = pre.arg_specs[1]["tokens"].shape[1]
    t = time.perf_counter()
    params = init_params(cfg, seed=SEED + 9, device=dev)
    torch.cuda.synchronize()
    n_alloc = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"  {QWEN_MOE}: {cfg.n_params()} parameters ({n_alloc} allocated "
        f"with the experts padded to {padded_experts(cfg.moe.n_experts)}), "
        f"{w_bytes} bytes made on the card in "
        f"{time.perf_counter() - t:.1f} s; {cfg.n_active_params()} active "
        f"a token")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    toks = torch.randint(4, cfg.vocab, (1, s), generator=gen, device=dev,
                         dtype=torch.int32)
    fa.launches = fd.launches = 0                   # the main path
    times = []
    with torch.no_grad():
        for _ in range(2):
            out = None                  # the earlier run's cache goes first
            out, host, ev, _ = timed(torch, lambda: pre.fn(
                params, {"tokens": toks}))
            times.append((host, ev))
        logits, cache, n = out
    check(n == s and tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill_32k: logits")
    shape = (cfg.n_layers, 1, cfg.n_kv, s, cfg.d_head)
    check(tuple(cache["k"].shape) == shape == tuple(cache["v"].shape)
          and bool(cache["k"][:, :, :, -1].abs().sum() > 0),
          "prefill_32k: cache")
    cap = capacity(s, cfg.moe)
    rows_pad = padded_experts(cfg.moe.n_experts) * -(-cap // ROWS) * ROWS
    b_need = prefill_bound(cfg, s, s * cfg.moe.top_k)
    b_disp = prefill_bound(cfg, s, rows_pad)
    for i, (host, ev) in enumerate(times):
        log(f"  prefill_32k (1 x {s}) run {i + 1}: host {host:.2f} ms, "
            f"events {ev:.2f} ms, {s / host * 1e3:.0f} tokens/s")
    log(f"  prefill_32k bound: {b_need[0]:.3f} ms ({b_need[1]}; the "
        f"tokens' {s * cfg.moe.top_k} expert rows a layer), "
        f"{b_disp[0]:.3f} ms ({b_disp[1]}; the capacity buffer's "
        f"{rows_pad} rows: cap {cap})")
    cache_bytes = 2 * cache["k"].numel() * cache["k"].element_size()

    # the prefill's cache in one int8 slot of a KVCacheArena
    arena = KVCacheArena(CacheConfig(cfg.n_layers, cfg.n_kv, cfg.d_head,
                                     s, 1, quantize_int8=True), device=dev)
    slot = arena.claim()
    arena.write_prefill(slot, cache["k"][:, 0], cache["v"][:, 0])
    worst = 0.0
    for name in ("k", "v"):
        q, sc = getattr(arena, name), getattr(arena, f"{name}_scale")
        for layer in range(cfg.n_layers):
            x = cache[name][layer, 0].float()
            deq = dequantize_kv(q[layer, slot], sc[layer, slot],
                                torch.float32)
            worst = max(worst, float(((deq - x).abs()
                                      / (sc[layer, slot] / 2)).max()))
    dk, dv = arena.dequantized([slot])
    deq_err = max(float((dk[:, 0] - cache["k"][:, 0]).float().abs().max()),
                  float((dv[:, 0] - cache["v"][:, 0]).float().abs().max()))
    # half a step, plus the fp32 roundings of x / scale and q * scale
    # (each at most 127 * 2**-24 of a step)
    check(worst <= 1 + 2 ** -13, f"KVCacheArena: a dequantized entry is "
                                 f"{worst} half-steps from its value")
    log(f"  KVCacheArena int8, one slot of {s}: {arena.memory_bytes()} "
        f"bytes against {cache_bytes} in bf16 "
        f"({arena.memory_bytes() / cache_bytes:.4f}); dequantized within "
        f"{worst:.6f} of quantize_kv's half step (fp32); bf16 "
        f"dequantized() max abs err {deq_err:.4g}")
    del arena, dk, dv, cache, logits, out
    torch.cuda.empty_cache()

    # decode_32k at batch 4 over a cache of seeded noise
    b, steps, start = 4, 16, s - 16
    cshape = (cfg.n_layers, b, cfg.n_kv, s, cfg.d_head)
    ck = torch.randn(cshape, generator=gen, device=dev, dtype=cfg.dtype)
    cv = torch.randn(cshape, generator=gen, device=dev, dtype=cfg.dtype)
    first = torch.randint(4, cfg.vocab, (b, 1), generator=gen, device=dev,
                          dtype=torch.int32)

    def run():
        cur, n, rows, outs = first, torch.tensor(start, dtype=torch.int32), \
            [], []
        for _ in range(steps):
            batch = {"tokens": cur, "cache_k": ck, "cache_v": cv,
                     "cache_len": n}
            (lg, _, _, n), host, ev, issue = timed(
                torch, lambda: dec.fn(params, batch))
            rows.append((host, ev, issue))
            outs.append(lg)
            cur = lg.argmax(-1)[:, None].to(torch.int32)
        return rows, outs, n

    with torch.no_grad():
        rows, outs, n = run()
        launches = {"flash_attention": fa.launches,
                    "flash_decode": fd.launches}
        with RouterLog() as router:
            _, again, _ = run()
    check(n == s and all(tuple(x.shape) == (b, cfg.vocab) for x in outs)
          and all(bool(torch.isfinite(x).all()) for x in outs),
          "decode_32k: logits")
    check(all(torch.equal(x, y) for x, y in zip(outs, again)),
          "decode_32k: a rerun of the 16 steps differs")
    e_pad = padded_experts(cfg.moe.n_experts)
    need = router.distinct_experts() / steps
    d_read = decode_bound(cfg, b, s - 1, cfg.n_layers * e_pad)
    d_need = decode_bound(cfg, b, s - 1, int(round(need)))
    for i, (host, ev, issue) in enumerate(rows):
        log(f"  decode_32k (4 x 1, cache_len {start + i}) step {i + 1}: "
            f"host {host:.2f} ms, events {ev:.2f} ms, issued in "
            f"{issue:.2f} ms, {b / host * 1e3:.1f} tokens/s")
    host, ev, issue = (sorted(col) for col in zip(*rows))
    log(f"  decode_32k median: host {host[steps // 2]:.2f} ms "
        f"({b / host[steps // 2] * 1e3:.1f} tokens/s), events "
        f"{ev[steps // 2]:.2f} ms, issued in {issue[steps // 2]:.2f} ms; "
        f"bound {d_read[0]:.3f} ms ({d_read[1]}; "
        f"the dispatch reads all {e_pad} experts of the {cfg.n_layers} "
        f"layers), {d_need[0]:.3f} ms ({d_need[1]}; the {need:.1f} experts "
        f"a step its tokens need, at most {min(e_pad, b * cfg.moe.top_k)} "
        f"a layer)")
    del ck, cv, outs, again, router
    torch.cuda.empty_cache()
    reduced.append(f"{QWEN_MOE}: prefill_32k batch 32 -> 1 (32 sequences' "
                   f"cache: 206 GB); decode_32k batch 128 -> 4 (824 GB)")
    return params, launches, dict(
        weights_bytes=w_bytes, prefill_cache_bytes=cache_bytes,
        decode_cache_bytes=b * cache_bytes)


def phase_moe_block(torch, dev, p, cfg) -> None:
    """One Qwen2-MoE layer's MoE block at full width on the card: dropless
    against the dense oracle on 512 tokens (bf16, and fp32 on the same
    weights widened); the capacity path at 2048 tokens against the same
    function on the CPU, in bf16 and in fp32 (weights widened), the
    dropped pairs equal (one router column overloaded so that some drop);
    two runs and a token alone against its batch, bit for bit."""
    from repro_torch.models import moe as pm
    from repro_torch.testing import rounding_agree

    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n_drop, n_cap = MOE_TOKENS
    x = torch.randn((1, n_drop, cfg.d_model), generator=gen, device=dev,
                    dtype=cfg.dtype)
    with torch.no_grad():
        for dtype, rule in ((torch.bfloat16, BF16_MOE),
                            (torch.float32, dict(rel=1e-4, slack=1e-4))):
            pw = {k: (v if k == "router" else v.to(dtype))
                  for k, v in p.items()}
            xw = x.to(dtype)
            got, _ = pm.moe_block(pw, xw, m, dropless=True)
            want = pm.moe_block_dense_ref(pw, xw, m)
            ok, ratio = rounding_agree(got, want, **rule)
            check(ok, f"moe dropless vs dense ref ({dtype}): {ratio:.3g} x "
                      f"its limit")
            log(f"  moe_block dropless vs moe_block_dense_ref, {n_drop} "
                f"tokens, "
                f"{str(dtype).removeprefix('torch.')}: max abs err "
                f"{float((got.float() - want.float()).abs().max()):.4g}, "
                f"{ratio:.3g} x the limit")
            del pw
        out, _ = pm.moe_block(p, x, m, dropless=True)
        again, _ = pm.moe_block(p, x, m, dropless=True)
        check(torch.equal(out, again), "moe dropless: two runs differ")
        for i in (0, n_drop // 2, n_drop - 1):
            alone, _ = pm.moe_block(p, x[:, i:i + 1], m, dropless=True)
            check(torch.equal(alone[0, 0], out[0, i]),
                  f"moe dropless: token {i} alone differs from its batch")
        log(f"  moe_block dropless: two runs bit for bit; tokens 0, "
            f"{n_drop // 2}, {n_drop - 1} alone bit for bit with their batch "
            f"of {n_drop}")

        x = torch.randn((1, n_cap, cfg.d_model), generator=gen, device=dev,
                        dtype=cfg.dtype)
        natural = pm.dropped_pairs(p, x, m)
        check(torch.equal(natural.cpu(), pm.dropped_pairs(
            {k: v.cpu() for k, v in p.items()}, x.cpu(), m)),
              "moe capacity: the dropped pairs differ card vs CPU")
        over = dict(p, router=p["router"].clone())
        over["router"][:, 0] *= 3.0
        for name, rule in CAPACITY_RULES.items():
            dtype = getattr(torch, name)
            pw = {k: (v if k == "router" else v.to(dtype))
                  for k, v in over.items()}
            pc = {k: v.cpu() for k, v in pw.items()}
            xw = x.to(dtype)
            drops = pm.dropped_pairs(pw, xw, m)
            check(len(drops) > 0 and torch.equal(
                drops.cpu(), pm.dropped_pairs(pc, xw.cpu(), m)),
                f"moe capacity (expert 0 overloaded, {dtype}): dropped "
                f"pairs")
            got, _ = pm.moe_block(pw, xw, m)
            again, _ = pm.moe_block(pw, xw, m)
            check(torch.equal(got, again), "moe capacity: two runs differ")
            t = time.perf_counter()
            want, _ = pm.moe_block(pc, xw.cpu(), m)
            t = time.perf_counter() - t
            ok, ratio = rounding_agree(got.cpu(), want, **rule)
            check(ok, f"moe capacity card vs CPU ({dtype}): {ratio:.3g} x "
                      f"its limit")
            ladder = ", ".join(
                f"{slack:.3g}: "
                f"{rounding_agree(got.cpu(), want, rule['rel'], slack)[1]:.3g}"
                for slack in SLACK_LADDER)
            log(f"  moe_block capacity, {n_cap} tokens (cap "
                f"{pm.capacity(n_cap, m)}), {name}: {len(natural)} pairs "
                f"dropped by the seeded router, {len(drops)} with expert "
                f"0's column x 3, the same sets card and CPU; outputs card "
                f"vs CPU {ratio:.3g} x the limit (rel {rule['rel']:.3g}, "
                f"slack {rule['slack']:.3g}; CPU {t:.1f} s); x the limit "
                f"at rel {rule['rel']:.3g} by slack: {ladder}; two runs bit "
                f"for bit")
            del pw, pc


def phase_moe_rows(torch, dev, p) -> None:
    """The MoE block's blocked GEMMs at Qwen2-MoE's widths (the router in
    fp32, the shared experts in bf16): every count of 128-row blocks from
    1 to 256 (prefill_32k's 32,768 tokens) gives each block the bits that
    it has among 256, and so do ragged counts; then their times at 32,768
    tokens against one unblocked GEMM and against a loop of 128-row
    GEMMs, one launch a block."""
    from repro_torch.models.moe import ROWS, _by_rows

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    n = 256 * ROWS
    total = dict(blocked=0.0, unblocked=0.0, loop=0.0)
    for name in ("router", "shared_w_in", "shared_w_out"):
        w = p[name]
        x = torch.randn((n, w.shape[0]), generator=gen, device=dev,
                        dtype=w.dtype)
        full = _by_rows(x, w)
        counts = [j * ROWS for j in range(1, 257)] + [1, 5, 200, 1000]
        bad = [c for c in counts if not torch.equal(_by_rows(x[:c], w),
                                                    full[:c])]
        check(not bad, f"_by_rows {name}: rows differ from their bits among "
                       f"{n} at counts {bad[:8]}")
        times = dict(
            blocked=cuda_ms(torch, lambda: _by_rows(x, w), 5),
            unblocked=cuda_ms(torch, lambda: x @ w, 5),
            loop=cuda_ms(torch, lambda: torch.cat(
                [x[i:i + ROWS] @ w for i in range(0, n, ROWS)]), 3))
        for key, ms in times.items():
            total[key] += ms
        log(f"  _by_rows {name} ({n} x {w.shape[0]} @ {tuple(w.shape)}, "
            f"{str(w.dtype).removeprefix('torch.')}): {len(counts)} row "
            f"counts bit for bit with {n}; blocked {times['blocked']:.4f} "
            f"ms, unblocked {times['unblocked']:.4f}, a loop of 128-row "
            f"GEMMs {times['loop']:.4f}")
    log(f"  _by_rows at prefill_32k, a layer: blocked {total['blocked']:.4f} "
        f"ms, unblocked {total['unblocked']:.4f}, loop {total['loop']:.4f}")


def phase_lm_attention(torch, dev) -> dict:
    """The two attention kernels at the shapes phase 9's serving runs give
    them, against their plain versions with phase 2's rules: Qwen2-MoE's
    prefill_32k (1, 16, 32768, 128; the plain version on the last 256
    query rows) and decode_32k (4 x 16 heads over 32,768 entries, before
    and at the first and the last step), and each other config's prefill
    and last decode step."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_family import LM_SHAPES

    att = AttentionCheck(torch, dev, SEED + 14)
    bf16 = torch.bfloat16
    cfg = get_arch(QWEN_MOE).model_config(False)
    h, kv, d = cfg.n_heads, cfg.n_kv, cfg.d_head
    s = LM_SHAPES["prefill_32k"]["seq"]
    att.attention("qwen2-moe prefill_32k", (1, h, kv, s, s, d), bf16, True,
                  5, rows=256)
    s = LM_SHAPES["decode_32k"]["seq"]
    att.decode("qwen2-moe decode_32k", (4, h, kv, s, d),
               (s - 16, s - 15, s), bf16, 20)
    for arch, _, s, steps in OTHER_LMS:
        cfg = get_arch(arch).model_config(False)
        h, kv, d = cfg.n_heads, cfg.n_kv, cfg.d_head
        att.attention(f"{arch} prefill {s}", (1, h, kv, s, s, d), bf16,
                      True, 5)
        att.decode(f"{arch} decode", (1, h, kv, s + steps, d),
                   (s + steps,), bf16, 20)
        torch.cuda.empty_cache()
    att.log_rows()
    return att.out


def phase_lm_others(torch, dev, reduced: list) -> dict:
    """The other LM configs at full width, seeded, on the card: prefill
    and decode steps with every logit finite and every shape right.
    Returns the attention kernels' launches here."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)

    launches = {"flash_attention": 0, "flash_decode": 0}
    for arch, layers, s, steps in OTHER_LMS:
        full = get_arch(arch).model_config(False)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        if layers is not None:
            reduced.append(f"{arch}: {full.n_layers} -> {layers} layers")
        t = time.perf_counter()
        params = init_params(cfg, seed=SEED + 15, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t
        w_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        gen = torch.Generator(device=dev).manual_seed(SEED + 16)
        toks = torch.randint(4, cfg.vocab, (1, s + steps), generator=gen,
                             device=dev)
        fa.launches = fd.launches = 0
        with torch.no_grad():
            (logits, cache, n), pre_host, pre_ev, _ = timed(
                torch, lambda: prefill(params, toks[:, :s], cfg, s + steps))
            ok = bool(torch.isfinite(logits).all())
            dec = []
            for i in range(s, s + steps):
                (logits, cache, n), host, ev, _ = timed(
                    torch, lambda: decode_step(params, toks[:, i:i + 1],
                                               cache, n, cfg))
                ok = ok and bool(torch.isfinite(logits).all())
                dec.append((host, ev))
        launches["flash_attention"] += fa.launches
        launches["flash_decode"] += fd.launches
        check(ok and tuple(logits.shape) == (1, cfg.vocab) and n == s + steps
              and tuple(cache["k"].shape) == (cfg.n_layers, 1, cfg.n_kv,
                                              s + steps, cfg.d_head),
              f"{arch}: logits or shapes")
        log(f"  {arch} ({cfg.n_layers} of {full.n_layers} layers, "
            f"{w_bytes} bytes of weights made in {t_init:.1f} s): prefill "
            f"1 x {s} host {pre_host:.2f} ms, events {pre_ev:.2f} ms; "
            f"{steps} decode steps host "
            f"{' '.join(f'{h:.2f}' for h, _ in dec)} ms, events "
            f"{' '.join(f'{e:.2f}' for _, e in dec)} ms; logits finite")
        del params, cache, logits
        torch.cuda.empty_cache()
    return launches


def phase_lm(torch, dev, kern: dict) -> dict:
    """Phase 9. Returns its launches of the two attention kernels: the
    serving runs' (Qwen2-MoE's cells, the other configs), not the checks
    against plain versions and oracles."""
    import gc
    import threading

    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG

    reduced: list = []
    t0 = time.perf_counter()
    log(f"  host at phase 9: {threading.active_count()} threads "
        f"{sorted(t.name for t in threading.enumerate())}, "
        f"{len(gc.get_objects())} objects tracked by the collector")
    params, launches, sizes = phase_lm_serving(torch, dev, reduced)
    layer = dict(params["layers"][0]["moe"].named_parameters())
    phase_moe_block(torch, dev, layer, CONFIG)
    phase_moe_rows(torch, dev, layer)
    del params, layer
    torch.cuda.empty_cache()
    phase_decode_vs_prefill(torch, dataclasses.replace(
        CONFIG, n_layers=4, dtype=torch.float32, moe=dataclasses.replace(
            CONFIG.moe, capacity_factor=CONFIG.moe.n_experts)), 1024, 8,
        (SEED + 12, SEED + 13), router=True)
    reduced.append(f"{QWEN_MOE} decode vs prefill: 24 -> 4 layers, fp32, "
                   f"capacity_factor 60")
    for name, r in phase_lm_attention(torch, dev).items():
        kern[name]["times"].extend(r["times"])
        kern[name]["err"] = max(kern[name]["err"], r["err"])
    for name, n in phase_lm_others(torch, dev, reduced).items():
        launches[name] += n
    log(json.dumps({"phase9": dict(sizes, reduced=reduced)}))
    log(f"  launches on the LM serving path (phase 9): {launches}; phase 9 "
        f"took {time.perf_counter() - t0:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the LM serving path")
    return launches


# ---------------------------------------------------------------------------
# phase 10: training on the card
# ---------------------------------------------------------------------------
NEMO = "mistral-nemo-12b"
NEMO_TRAIN = dict(layers=8, batch=8, steps=3)   # of 40 layers, 256 rows
TRAIN_DLRM_ROWS = 4_000_000     # phase 10's DLRM tables, each capped here
BERT4REC_BATCH = 32_768         # of 65,536, to keep phase 10 short
BERT4REC_ACCUM = 128            # microbatches of 256 x 200 (repro: 16)
DLRM_KINK_SHARE = 0.05          # card vs CPU: at most this share dropped
TC_BWD_DIMS = (64, 128)         # bf16 head dims whose backward is on wgmma


def peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


class BackwardCheck:
    """Holds the two backward kernels against their plain versions on the
    card and times them, the plain versions and the library's backward on
    the same inputs. Attention: the kernel's lse against the plain
    forward's by ``testing.lse_agree`` (-inf at the same rows, else 1e-5
    of max(1, |lse|)); the backward kernel against the plain backward on
    the kernel's o and lse, dq, dk, dv by ``testing.grads_agree`` (fp32
    within 1e-4 of each tensor's largest; bf16 within one rounding step of
    each value plus 1e-4 of its row's largest, floored at 1e-2 of the
    tensor's); the chain (forward with lse, then backward) against the
    plain chain (the plain backward on the plain forward's o and lse) by
    the same rule plus, in bf16, ``o_rounding_bound``; the output with
    lse equal to the serving output bit for bit. The bag:
    bit for bit where every bag has one slot, else within 1e-5 of the sum
    of |coef * g| over each row's slots. Two runs of each backward bit for
    bit."""

    def __init__(self, torch, dev, seed: int):
        self.torch, self.dev = torch, dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.out = {name: {"err": 0.0, "times": []}
                    for name in ("flash_attention_bwd", "embedding_bag_bwd")}

    def randn(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen,
                                device=self.dev).to(dtype)

    def row(self, name, what, err, fn, plain, library, in_bytes, out_bytes,
            flops, peak, iters, plain_iters, **extra):
        torch = self.torch
        self.out[name]["err"] = max(self.out[name]["err"], err)
        t = cuda_ms(torch, fn, iters)
        tp = cuda_ms(torch, plain, plain_iters, 1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, out_bytes, flops, peak)
        self.out[name]["times"].append(dict(
            what=what, ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
            bound_by=by, max_abs_err=err, **extra))

    def attention(self, what, shape, dtype, causal, iters):
        """Shape (B, H, KV, Sq, Skv, D)."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_attention.plain import (
            flash_attention_bwd_plain, flash_attention_plain,
            o_rounding_bound)
        from repro_torch.testing import grads_agree, lse_agree

        torch = self.torch
        bf16 = dtype == torch.bfloat16
        b, h, kv, sq, skv, d = shape
        q, do = (self.randn((b, h, sq, d), dtype) for _ in range(2))
        k, v = (self.randn((b, kv, skv, d), dtype) for _ in range(2))
        o, lse = fa.flash_attention_with_lse(q, k, v, causal)
        check(torch.equal(o, fa.flash_attention(q, k, v, causal)),
              f"flash_attention {what}: the output with lse differs from "
              f"the serving output")
        o_p, lse_p = flash_attention_plain(q, k, v, causal, return_lse=True)
        ok, lse_ratio = lse_agree(lse, lse_p)
        check(ok, f"flash_attention {what}: lse is {lse_ratio:.3g} x its "
                  f"limit from plain")
        tc0 = fa.bwd_tc_launches
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
        tc = fa.bwd_tc_launches - tc0
        check(tc == (bf16 and d in TC_BWD_DIMS),
              f"flash_attention_bwd {what}: {tc} tensor-core launches")
        again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash_attention_bwd {what}: two runs differ")
        # the backward alone (the plain backward on the kernel's o and
        # lse), then the chain forward-with-lse and backward (the plain
        # backward on the plain forward's o and lse; in bf16 the two
        # forwards' o may round apart, o_rounding_bound)
        env = o_rounding_bound(q, k, v, o_p, do, lse_p, causal) if bf16 \
            else (None,) * 3
        err, worst, chain, unbound = 0.0, 0.0, 0.0, 0.0
        for label, want, bound in (
                ("", flash_attention_bwd_plain(q, k, v, o, do, lse, causal),
                 (None,) * 3),
                (" (the chain)", flash_attention_bwd_plain(
                    q, k, v, o_p, do, lse_p, causal), env)):
            for name, x, y, e in zip(("dq", "dk", "dv"), got, want, bound):
                check(bool(torch.isfinite(x).all()),
                      f"flash_attention_bwd {what}: {name} not finite")
                ok, ratio = grads_agree(x, y, bf16, e)
                check(ok, f"flash_attention_bwd {what}{label}: {name} is "
                          f"{ratio:.3g} x its limit from plain")
                if label:
                    chain = max(chain, ratio)
                    unbound = max(unbound, grads_agree(x, y, bf16)[1])
                else:
                    err = max(err, float((x.float() - y.float()).abs().max()))
                    worst = max(worst, ratio)
            del want
        if causal and sq > skv:
            check(float(got[0][:, :, :sq - skv].abs().max()) == 0.0,
                  f"flash_attention_bwd {what}: a row with no key has a "
                  f"gradient")
        del env, o_p, lse_p
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        try:
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
        except TypeError:       # a torch without enable_gqa: repeat k, v
            rep = [leaves[0]] + [x.repeat_interleave(h // kv, 1)
                                 for x in leaves[1:]]
            out = F.scaled_dot_product_attention(*rep, is_causal=causal)
        es = q.element_size()
        pairs = b * h * visible_pairs(sq, skv, causal)
        # what the body executes: 20 pairs x D on the tensor cores (P and
        # dS split in two), 14 on the CUDA cores (S and dP recomputed)
        executed = (20 if tc else 14) * pairs * d
        self.row("flash_attention_bwd", what, err,
                 lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, causal),
                 lambda: flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                   causal),
                 lambda: torch.autograd.grad(out, leaves, do,
                                             retain_graph=True),
                 (3 * b * h * sq + 2 * b * kv * skv) * d * es + b * h * sq * 4,
                 (b * h * sq + 2 * b * kv * skv) * d * es, 10 * pairs * d,
                 BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS,
                 iters, 1, dtype=str(dtype).removeprefix("torch."),
                 body="wgmma" if tc else "cuda cores",
                 executed_flops=executed, err_over_limit=worst,
                 chain_over_limit=chain, chain_without_bound=unbound,
                 lse_over_limit=lse_ratio)
        row = self.out["flash_attention_bwd"]["times"][-1]
        row["tflops"] = executed / row["ms"] / 1e9
        del out, leaves
        torch.cuda.empty_cache()

    def autograd_vs_cpu(self, what, shape, dtype, causal):
        """torch.autograd through ``flash_attention`` on the card (the
        forward kernel with its lse, then the backward kernel) against
        torch.autograd through the plain forward on the CPU: the output
        and dq, dk, dv by ``testing.grads_agree``, in bf16 with
        ``o_rounding_bound`` (the CPU's gradient reads the fp32 output,
        the card's its bf16 rounding)."""
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_attention.plain import (
            flash_attention_plain, o_rounding_bound)
        from repro_torch.testing import grads_agree

        torch = self.torch
        b, h, kv, sq, skv, d = shape
        x = [self.randn(s, dtype) for s in ((b, h, sq, d), (b, kv, skv, d),
                                            (b, kv, skv, d), (b, h, sq, d))]
        card = [t.clone().requires_grad_(True) for t in x[:3]]
        cpu = [t.cpu().requires_grad_(True) for t in x[:3]]
        out = fa.flash_attention(*card, causal=causal)
        out.backward(x[3])
        want, lse = flash_attention_plain(*cpu, causal=causal,
                                          return_lse=True)
        want.backward(x[3].cpu())
        env = o_rounding_bound(*(t.detach() for t in cpu), want.detach(),
                               x[3].cpu(), lse.detach(), causal)
        worst, unbound = 0.0, 0.0
        for name, got, ref, e in zip(("o", "dq", "dk", "dv"),
                                     [out.detach()] + [t.grad for t in card],
                                     [want.detach()] + [t.grad for t in cpu],
                                     (None,) + env):
            check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"flash_attention autograd {what}: {name}")
            ok, ratio = grads_agree(got.cpu(), ref, dtype == torch.bfloat16,
                                    e)
            check(ok, f"flash_attention autograd {what}: {name} card vs "
                      f"CPU is {ratio:.3g} x its limit")
            worst = max(worst, ratio)
            unbound = max(unbound, grads_agree(got.cpu(), ref, dtype ==
                                               torch.bfloat16)[1])
        log(f"  flash_attention autograd {what}: card vs CPU plain autograd, "
            f"o, dq, dk, dv within {worst:.3g} x their limits "
            f"({unbound:.3g} x without o_rounding_bound)")
        del out, card, x
        torch.cuda.empty_cache()

    def bag(self, what, sizes, b, bag, combiner, weighted, hot, iters):
        """One grouped backward over tables of ``sizes`` rows (D 128,
        fp32), ids uniform over each table (``hot``: below 3, the smoke
        batch's), g the slice [:, 1:] of a (B, F + 1, D) stack as DLRM's
        backward hands it over."""
        import torch.nn.functional as F

        from repro_torch.kernels.embedding_bag import ops as eb
        from repro_torch.kernels.embedding_bag.plain import (
            embedding_bag_backward_plain)

        torch = self.torch
        f, d = len(sizes), 128
        hi = [3 if hot else n for n in sizes]
        ids = torch.stack([torch.randint(0, n, (b, bag), generator=self.gen,
                                         device=self.dev, dtype=torch.int32)
                           for n in hi], 1)
        w = torch.rand((b, f, bag), generator=self.gen, device=self.dev) \
            if weighted else None
        g = self.randn((b, f + 1, d), torch.float32)[:, 1:]
        got = eb.embedding_bag_grouped_bwd(sizes, torch.float32, ids, w,
                                           combiner, g)
        check(torch.equal(got, eb.embedding_bag_grouped_bwd(
            sizes, torch.float32, ids, w, combiner, g)),
            f"embedding_bag_bwd {what}: two runs differ")
        want = embedding_bag_backward_plain(sizes, torch.float32, ids, w,
                                            combiner, g)
        same = torch.equal(got, want)
        if bag == 1:
            check(same, f"embedding_bag_bwd {what}: one-slot bags differ "
                        f"from plain")
        else:
            ones = torch.ones_like(ids, dtype=torch.float32)
            mag = embedding_bag_backward_plain(
                sizes, torch.float32, ids, ones if w is None else w,
                combiner, g.abs())
            check(bool(((got - want).abs() <= 1e-5 * mag).all()),
                  f"embedding_bag_bwd {what}: beyond 1e-5 of sum |w g|")
            del mag
        err = float((got - want).abs().max())
        del want
        rows, n = sum(sizes), int((ids >= 0).sum())
        # the library: one F.embedding_bag backward a table (its dense
        # gradient), the 26 in turn
        tabs = [torch.empty((r, d), device=self.dev).requires_grad_(True)
                for r in sizes]
        outs = [F.embedding_bag(ids[:, i], t, mode=combiner,
                                per_sample_weights=None if w is None
                                else w[:, i]) for i, t in enumerate(tabs)]

        def library():
            for i in range(f):
                torch.autograd.grad(outs[i], tabs[i], g[:, i],
                                    retain_graph=True)

        self.row("embedding_bag_bwd", what, err,
                 lambda: eb.embedding_bag_grouped_bwd(
                     sizes, torch.float32, ids, w, combiner, g),
                 lambda: embedding_bag_backward_plain(
                     sizes, torch.float32, ids, w, combiner, g),
                 library, b * f * d * 4 + ids.numel() * 4
                 + (0 if w is None else w.numel() * 4), rows * d * 4,
                 2 * n * d, FP32_FLOPS, iters, 1, bit_for_bit=same)
        del got, tabs, outs
        torch.cuda.empty_cache()

    def log_rows(self) -> None:
        for name, r in self.out.items():
            for row in r["times"]:
                log(f"  {name}: " + " ".join(
                    f"{key}={val:.4g}" if isinstance(val, float) else
                    f"{key}={val}" for key, val in row.items()))
            log(f"  {name}: max_abs_err={r['err']:.3g}")


def dlrm_train_config():
    from repro_torch.configs.dlrm_mlperf import CONFIG
    return dataclasses.replace(CONFIG, table_sizes=tuple(
        min(v, TRAIN_DLRM_ROWS) for v in CONFIG.table_sizes))


def phase_train_kernels(torch, dev) -> dict:
    """The backward kernels at the shapes of phase 10's cells, small fp32
    cases at D 64 and 128, and rows that see no key."""
    from repro_torch.configs import get_arch

    chk = BackwardCheck(torch, dev, SEED + 20)
    nemo = get_arch(NEMO).model_config(False)
    for what, shape, dtype, causal, iters in (
            ("nemo train_4k", (1, nemo.n_heads, nemo.n_kv, 4096, 4096,
                               nemo.d_head), torch.bfloat16, True, 3),
            ("bert4rec train 256x200", (256, 2, 2, 200, 200, 32),
             torch.float32, False, 5),
            ("fp32 D64 causal", (2, 8, 2, 256, 256, 64), torch.float32, True,
             5),
            ("fp32 D128 causal", (1, 4, 4, 256, 256, 128), torch.float32,
             True, 5),
            ("empty rows 300x100", (1, 4, 2, 300, 100, 64), torch.float32,
             True, 5),
            ("bf16 D128 empty rows 300x100", (1, 8, 2, 300, 100, 128),
             torch.bfloat16, True, 5),
            ("bf16 D64 causal GQA 4", (1, 8, 2, 512, 512, 64),
             torch.bfloat16, True, 5)):
        chk.attention(what, shape, dtype, causal, iters)
    chk.autograd_vs_cpu("bf16 D128 1x512", (1, nemo.n_heads, nemo.n_kv, 512,
                                            512, nemo.d_head),
                        torch.bfloat16, True)
    from repro_torch.configs.recsys_family import RECSYS_SHAPES

    sizes = dlrm_train_config().padded_table_sizes
    b = RECSYS_SHAPES["train_batch"]["batch"]
    chk.bag("dlrm train_batch", sizes, b, 1, "sum", False, False, 5)
    chk.bag("dlrm train_batch hot", sizes, b, 1, "sum", False, True, 5)
    chk.bag("multi-hot 4096x20 weighted", sizes, 4096, 20, "sum",
            True, False, 5)
    chk.log_rows()
    return chk.out


def train_steps(torch, what: str, cell, params, opt_state, batches: list,
                tokens: int, counters: dict, main: dict,
                first_step: int = 0) -> tuple[list, list]:
    """``cell.fn`` on each batch in turn, the main path of phase 10: the
    launch counts are set to 0 before each step and read after it, into
    ``main``. Logs each step's host s, tokens (or samples) a second, peak
    memory and launches. Returns (losses, host ms)."""
    losses, hosts = [], []
    for i, batch in enumerate(batches):
        for m, a in counters.values():
            setattr(m, a, 0)
        torch.cuda.reset_peak_memory_stats()
        step = torch.tensor(first_step + i, dtype=torch.int32,
                            device=cell.device)
        (params, opt_state, loss), host, _, _ = timed(
            torch, lambda: cell.fn(params, opt_state, batch, step))
        made = {k: getattr(m, a) for k, (m, a) in counters.items()}
        for k, n in made.items():
            main[k] += n
        loss = float(loss)
        check(math.isfinite(loss), f"{what} step {i}: loss {loss}")
        losses.append(loss)
        hosts.append(host)
        log(f"  {what} step {first_step + i + 1}: loss {loss:.5f}, host "
            f"{host / 1e3:.3f} s, {tokens / host * 1e3:.0f} a second, peak "
            f"{peak_gb(torch):.2f} GB, launches {made}")
    return losses, hosts


def card_vs_cpu(torch, loss, params, batch, cpu_params, cpu_batch,
                rows=None) -> tuple[float, float, float, str]:
    """One step's loss and gradients on the card against the same on the
    CPU (plain versions). Returns (card loss, CPU loss, the largest ratio
    of a leaf's error to 1e-4 of its largest |value|, that leaf). The
    loss's error counts as a leaf's, against 1e-4 of max(1, |loss|).
    ``rows`` maps a leaf name to the card rows its CPU leaf holds
    (compact tables); the card's other rows must be 0."""
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves

    vg = grad_accum_value_and_grad(loss)
    l_card, g_card = vg(params, batch)
    l_cpu, g_cpu = vg(cpu_params, cpu_batch)
    l_card, l_cpu = float(l_card), float(l_cpu)
    worst = abs(l_card - l_cpu) / (1e-4 * max(1.0, abs(l_cpu)))
    at, cpu = "the loss", dict(leaves(g_cpu))
    for name, g in leaves(g_card):
        want = cpu[name]
        if rows and name in rows:
            full = g
            g = g[rows[name]]
            check(abs(float(full.abs().sum()) - float(g.abs().sum()))
                  <= 1e-6 * max(1.0, float(g.abs().sum())),
                  f"{name} has gradient outside the batch's rows")
        g = g.detach().cpu()
        top = float(want.abs().max())
        err = float((g - want).abs().max())
        ratio = err / (1e-4 * top) if top > 0 else (0.0 if err == 0 else
                                                    float("inf"))
        if ratio > worst:
            worst, at = ratio, name
    return l_card, l_cpu, worst, at


def grads_card_vs_cpu(torch, what: str, *args, **kwargs) -> None:
    """``card_vs_cpu``, held: the loss and every leaf within 1e-4 of its
    largest |value|."""
    l_card, l_cpu, worst, at = card_vs_cpu(torch, *args, **kwargs)
    check(worst <= 1.0, f"{what}: {at} card vs CPU is {worst:.3g} x its "
                        f"limit (loss {l_card} card, {l_cpu} CPU)")
    log(f"  {what}: card vs CPU loss {l_card:.6f} / {l_cpu:.6f}; the loss "
        f"and every grad within {worst:.3g} x 1e-4 of its largest")


class relu_signs:
    """Within the block, every ``torch.relu`` call records its input's
    signs (x > 0) into ``masks``, in call order."""

    def __init__(self, torch):
        self.torch, self.masks = torch, []

    def __enter__(self):
        self.relu = self.torch.relu

        def relu(x):
            self.masks.append((x > 0).detach())
            return self.relu(x)

        self.torch.relu = relu
        return self

    def __exit__(self, *exc):
        self.torch.relu = self.relu


def phase_train_nemo(torch, dev, reduced: list, counters: dict,
                     main: dict) -> dict:
    """Mistral-NeMo-12B train_4k at full width, 8 of 40 layers, through
    ``build_cell``: AdamW, 8 sequences of 4096 in 8 microbatches, remat;
    then one step at 2 layers in fp32 (seq 512) card vs CPU."""
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import train_tree

    cfg = dataclasses.replace(CONFIG, n_layers=NEMO_TRAIN["layers"])
    cell = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg)
    check(cell.accum == 8 and cell.optimizer == "adamw" and cfg.remat,
          f"{NEMO} train_4k: accum {cell.accum}, {cell.optimizer}")
    t = time.perf_counter()
    params = train_tree(tfm.init_params(cfg, seed=SEED + 21, device=dev))
    params, opt_state, batch, _ = make_smoke_args(cell, seed=SEED + 21,
                                                  params=params)
    n = NEMO_TRAIN["batch"]
    batch = {k: v[:n] for k, v in batch.items()}
    torch.cuda.synchronize()
    state = sum(p.numel() * p.element_size() for p in _leaves(params)) \
        + sum(p.numel() * 4 for p in _leaves(params)) * 2
    log(f"  {NEMO} train_4k: {cfg.n_params()} parameters, "
        f"{state} bytes of params and AdamW state made in "
        f"{time.perf_counter() - t:.1f} s; batch {n} x 4096, "
        f"{cell.accum} microbatches of {n // cell.accum}")
    seq = batch["tokens"].shape[1]
    pairs = cfg.n_heads * visible_pairs(seq, seq, True) * n
    flops = 6 * cfg.n_params() * n * seq + 14 * pairs * cfg.d_head \
        * cfg.n_layers
    bound = flops / BF16_FLOPS * 1e3
    before = main["flash_attention_bwd"], main["flash_attention_bwd_wgmma"]
    losses, hosts = train_steps(torch, f"{NEMO} train_4k", cell, params,
                                opt_state, [batch] * NEMO_TRAIN["steps"],
                                n * seq, counters, main)
    bwd = main["flash_attention_bwd"] - before[0]
    check(bwd > 0 and main["flash_attention_bwd_wgmma"] - before[1] == bwd,
          f"{NEMO} train_4k: not every attention backward ran on wgmma")
    log(f"  {NEMO} train_4k bound: {bound:.1f} ms a step (6 N tokens + "
        f"causal attention forward and backward, {flops:.4g} FLOPs at "
        f"989 TFLOP/s)")
    reduced.append(f"{NEMO} train_4k: 40 -> {cfg.n_layers} layers; global "
                   f"batch 256 -> {n} (accum 8 kept: microbatch 1 x 4096)")
    out = dict(step_bound_ms=bound, losses=losses,
               host_s=[h / 1e3 for h in hosts], peak_gb=peak_gb(torch))
    del params, opt_state, batch, cell
    torch.cuda.empty_cache()

    # one step at 2 layers, fp32, sequence 512: card vs CPU
    cfg = dataclasses.replace(CONFIG, n_layers=2, dtype=torch.float32)
    params = train_tree(tfm.init_params(cfg, seed=SEED + 22, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    batch = {"tokens": torch.randint(4, cfg.vocab, (1, 512), generator=gen,
                                     device=dev, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (1, 512), generator=gen,
                                     device=dev, dtype=torch.int32)}
    t = time.perf_counter()
    grads_card_vs_cpu(torch, f"{NEMO} 2 layers fp32 1 x 512",
                      lambda p, b: tfm.loss_fn(p, b, cfg), params, batch,
                      _tree_cpu(params), {k: v.cpu() for k, v in
                                          batch.items()})
    log(f"  ({time.perf_counter() - t:.1f} s)")
    reduced.append(f"{NEMO} card vs CPU: 2 layers, fp32, 1 x 512 tokens")
    del params
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    from repro_torch.train.tree import tensors
    return list(tensors(tree))


def _tree_cpu(tree):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def phase_train_dlrm(torch, dev, reduced: list, counters: dict,
                     main: dict) -> dict:
    """DLRM train_batch at MLPerf widths over tables capped at 4M rows:
    3 steps on ids uniform over each table, 1 on the smoke batch (every
    id below 3); then one step's grads card vs CPU on compact tables of
    a 4096-sample batch's rows."""
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.models import recsys as rm
    from repro_torch.models.bridge import train_tree

    cfg = dlrm_train_config()
    cell = build_cell("dlrm-mlperf", "train_batch", device=dev,
                      model_cfg=cfg)
    t = time.perf_counter()
    params = train_tree(rm.dlrm_init(cfg, seed=SEED + 23, device=dev))
    params, opt_state, hot, _ = make_smoke_args(cell, seed=SEED + 23,
                                                params=params)
    torch.cuda.synchronize()
    rows = sum(cfg.padded_table_sizes)
    log(f"  dlrm-mlperf train_batch: {rows} table rows "
        f"({rows * cfg.embed_dim * 4} bytes), params and AdamW state made "
        f"in {time.perf_counter() - t:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    b = hot["dense"].shape[0]

    def uniform(bsz):
        return {"dense": torch.rand((bsz, cfg.n_dense), generator=gen,
                                    device=dev),
                "sparse_ids": torch.stack([torch.randint(
                    0, v, (bsz, 1), generator=gen, device=dev,
                    dtype=torch.int32) for v in cfg.table_sizes], 1),
                "labels": torch.randint(0, 2, (bsz,), generator=gen,
                                        device=dev).float()}

    losses, hosts = train_steps(torch, "dlrm-mlperf train_batch", cell,
                                params, opt_state,
                                [uniform(b) for _ in range(3)], b, counters,
                                main)
    more, h2 = train_steps(torch, "dlrm-mlperf train_batch (smoke batch: "
                           "ids below 3)", cell, params, opt_state, [hot], b,
                           counters, main, first_step=3)
    out = dict(losses=losses + more, host_s=[h / 1e3 for h in hosts + h2],
               peak_gb=peak_gb(torch))
    reduced.append(f"dlrm-mlperf train_batch: tables capped at "
                   f"{TRAIN_DLRM_ROWS} rows ({rows} rows, "
                   f"{rows * cfg.embed_dim * 4 / 1e9:.1f} GB a copy)")

    # card vs CPU on compact tables of a 4096-sample batch's rows, over
    # the samples whose every ReLU unit is on or off alike on both: a
    # pre-activation within rounding of 0 may switch a unit on one side
    # only, and that sample's terms then differ whole (PERF.md section 2)
    batch = uniform(4096)
    cpu_tables, rows_of = {}, {}
    ids = batch["sparse_ids"]
    cpu_ids = []
    for f in range(cfg.n_sparse):
        name = f"table_{f}"
        uniq, inv = torch.unique(ids[:, f], return_inverse=True)
        cpu_tables[name] = params["tables"][name][uniq.long()].detach().cpu()
        rows_of[f"['tables']['{name}']"] = uniq.long()
        cpu_ids.append(inv.cpu())
    cpu_params = {"tables": cpu_tables, "bot": _tree_cpu(params["bot"]),
                  "top": _tree_cpu(params["top"])}
    cpu_batch = {"dense": batch["dense"].cpu(),
                 "sparse_ids": torch.stack(cpu_ids, 1).to(torch.int32),
                 "labels": batch["labels"].cpu()}
    signs = []
    for p, bb in ((params, batch), (cpu_params, cpu_batch)):
        with torch.no_grad(), relu_signs(torch) as r:
            rm.dlrm_forward(p, cfg, bb["dense"], bb["sparse_ids"])
        signs.append([m.cpu() for m in r.masks])
    keep = torch.stack([(a == c).all(-1) for a, c in zip(*signs)]).all(0)
    dropped = len(keep) - int(keep.sum())
    check(dropped <= DLRM_KINK_SHARE * len(keep),
          f"dlrm-mlperf card vs CPU: {dropped} of {len(keep)} samples "
          f"switch a ReLU unit on one side only")
    batch["keep"], cpu_batch["keep"] = keep.to(dev), keep

    def kept_loss(p, bb):
        logits = rm.dlrm_forward(p, cfg, bb["dense"], bb["sparse_ids"])
        return rm.bce_loss(logits[bb["keep"]], bb["labels"][bb["keep"]])

    what = (f"dlrm-mlperf 4096 samples ({dropped} dropped: a ReLU unit "
            f"switched on one side only)")
    args = (kept_loss, params, batch, cpu_params, cpu_batch, rows_of)
    grads_card_vs_cpu(torch, what, *args)
    # the control: TF32 matmuls on the card must fail the same rule
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, _, worst, at = card_vs_cpu(torch, *args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(worst > 1.0, f"dlrm-mlperf card vs CPU: TF32 matmuls pass the "
                       f"rule ({worst:.3g} x at {at}): it cannot tell")
    log(f"  control, TF32 matmuls on the card: {worst:.3g} x the limit at "
        f"{at} (must exceed 1)")
    del params, opt_state, hot, batch, cell
    torch.cuda.empty_cache()
    return out


def phase_train_bert4rec(torch, dev, reduced: list, counters: dict,
                         main: dict) -> dict:
    """BERT4Rec train_batch through ``build_cell``: 2 steps of
    BERT4REC_BATCH x 200 in microbatches of 256; then the resume check: a
    Trainer with a CheckpointManager, 4 steps straight against 2, a
    checkpoint, a fresh Trainer restored from it and 2 more, bit for
    bit."""
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_loop import Trainer
    from repro_torch.train.tree import leaves, tree_map

    cell = build_cell("bert4rec", "train_batch", device=dev,
                      accum=BERT4REC_ACCUM)
    params, opt_state, batch, _ = make_smoke_args(cell, seed=SEED + 25)
    batch = {k: v[:BERT4REC_BATCH] for k, v in batch.items()}
    b, s = batch["tokens"].shape
    p0 = tree_map(lambda t: t.detach().clone(), params)
    losses, hosts = train_steps(torch, "bert4rec train_batch", cell, params,
                                opt_state, [batch] * 2, b * s, counters,
                                main)
    reduced.append(f"bert4rec train_batch: global batch 65536 -> {b}, "
                   f"accum 16 -> {BERT4REC_ACCUM} (microbatch 4096 x 200 -> "
                   f"{b // BERT4REC_ACCUM} x 200: 6.2 GB of fp32 logits, not "
                   f"99 GB)")
    out = dict(losses=losses, host_s=[h / 1e3 for h in hosts],
               peak_gb=peak_gb(torch))
    del params, opt_state

    small = [{k: v[i * 128:(i + 1) * 128] for k, v in batch.items()}
             for i in range(4)]

    def fresh():
        return tree_map(lambda t: t.clone(), p0)

    one = Trainer(cell.loss, adamw(), fresh())
    one.run(small, n_steps=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ck-") as d:
        two = Trainer(cell.loss, adamw(), fresh(), d, checkpoint_every=2)
        two.run(small[:2], n_steps=2)              # an async save at 2
        three = Trainer(cell.loss, adamw(), fresh(), d)
        check(three.try_restore() and three.state.step == 2,
              "resume: no checkpoint at step 2")
        three.run(small[2:], n_steps=2)
    for a, b_ in ((one.state.params, three.state.params),
                  (one.state.opt_state, three.state.opt_state)):
        for (name, x), (_, y) in zip(leaves(a), leaves(b_)):
            check(torch.equal(x, y), f"resume: {name} differs from the "
                                     f"run without a restart")
    log(f"  resume (bert4rec, 4 steps of 128 x 200, AdamW): params and "
        f"state after 2 + checkpoint + restore + 2 equal those of 4 "
        f"straight, bit for bit; losses "
        f"{[round(h['loss'], 6) for h in one.history]}")
    del one, two, three, batch, small, p0
    torch.cuda.empty_cache()
    return out


def phase_train(torch, dev, kern: dict) -> dict:
    """Phase 10. Returns the launches of the forward and backward kernels
    on the train path: the three cells' steps (each step's counts read
    from 0), not the checks."""
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa

    t0 = time.perf_counter()
    reduced: list = []
    kern.update(phase_train_kernels(torch, dev))
    torch.cuda.empty_cache()
    counters = {"flash_attention": (fa, "launches"),
                "flash_attention_bwd": (fa, "bwd_launches"),
                "flash_attention_bwd_wgmma": (fa, "bwd_tc_launches"),
                "embedding_bag": (eb, "launches"),
                "embedding_bag_bwd": (eb, "bwd_launches")}
    main = {k: 0 for k in counters}
    cells = {"nemo": phase_train_nemo(torch, dev, reduced, counters, main),
             "dlrm": phase_train_dlrm(torch, dev, reduced, counters, main),
             "bert4rec": phase_train_bert4rec(torch, dev, reduced, counters,
                                              main)}
    log(json.dumps({"phase10": dict(cells, reduced=reduced)}))
    log(f"  launches on the train path (phase 10's steps): {main}; phase "
        f"10 took {time.perf_counter() - t0:.1f} s")
    for name, n in main.items():
        check(n > 0, f"{name} was never launched on the train path")
    return main


SCHNET = "schnet"
SCHNET_STEPS = 3
SCHNET_CHUNK_CHECK = 1 << 14     # card: minibatch_lg at this edge_chunk
# the kernel's check and times on ogb_products: the plan of the cell's
# first edge chunk (2^22 edges of the dst-sorted batch; its plan_ms is
# ``edge_chunks`` over the whole batch)
OGB_CHUNK = "ogb_products chunk 0"
# minibatch_lg on a sampled batch: a seeded graph of Reddit's 232,965
# nodes, out-degrees lognormal (sigma 1.5) with mean 50, dst uniform
REDDIT = dict(nodes=232_965, degree=50, sigma=1.5, seeds=1024,
              fanout=(15, 10))


def same_values(torch, a, b) -> bool:
    """Equal bit for bit where not NaN, NaN at the same places (the card
    gives its canonical NaN for arithmetic on a NaN, whatever the
    input's bits)."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0.0, a),
                            torch.where(b.isnan(), 0.0, b)))


class SegmentCheck:
    """``gather_segment_sum`` against its plain version on the card, bit
    for bit: the forward over the plan's dst order, the gradient of x
    over its src order, the gradient of w (two gathers and a product,
    the same code both ways) through autograd; two runs of each bit for
    bit; the largest |kernel - plain| over the non-NaN entries; times of
    the kernel, the plain version and the library
    (``out.index_add_(0, dst, x[src] * w)``: float atomics), and the
    bound (the bytes of w, of the gathered rows of x, of the indices and
    of out over 3.35 TB/s, an x of at most 50 MB counted at most its size
    once, as it stays in L2; 2 FLOPs an element, 1 without w)."""

    def __init__(self, torch, dev, seed: int):
        self.torch, self.dev = torch, dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.out = {"err": 0.0, "times": []}

    def randn(self, shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def case(self, what: str, make_plan, d: int, weighted: bool = True,
             iters: int = 20) -> None:
        """The check and the times over ``make_plan()``'s ``EdgePlan`` (its
        time is the row's plan_ms) with seeded x (n_src, d), w and the
        cotangent."""
        from repro_torch.kernels.segment_sum import (gather_segment_sum,
                                                     segment_sum,
                                                     segment_sum_plain,
                                                     weight_grad)

        torch = self.torch
        t = time.perf_counter()
        plan = make_plan()
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t) * 1e3
        n, n_out, e = plan.n_src, plan.n_out, plan.src.shape[0]
        x = self.randn((n, d))
        w = self.randn((e, d)) if weighted else None
        g = self.randn((n_out, d))
        xg = x.clone().requires_grad_(True)
        wg = None if w is None else w.clone().requires_grad_(True)
        out = gather_segment_sum(xg, None, None, n_out, wg, plan=plan)
        out.backward(g)
        fwd = segment_sum(x, w, plan.fwd)
        dx = segment_sum(g, w, plan.bwd)
        err = 0.0
        for name, got, want, again in (
                ("forward", out.detach(), segment_sum_plain(
                    x, w, plan.fwd), fwd),
                ("dx", xg.grad, segment_sum_plain(g, w, plan.bwd), dx)):
            check(same_values(torch, got, want),
                  f"gather_segment_sum {what}: {name} differs from plain")
            check(same_values(torch, got, again),
                  f"gather_segment_sum {what}: two runs of {name} differ")
            err = max(err, float(torch.where(
                got.isnan() | want.isnan(), 0.0, got - want).abs().max()))
        if w is not None:
            check(same_values(torch, wg.grad, weight_grad(x, g, plan)),
                  f"gather_segment_sum {what}: dw differs")
        self.out["err"] = max(self.out["err"], err)
        hot = int(plan.fwd["count"].max()) if len(plan.fwd["count"]) else 0
        parts = int((plan.fwd["part"] >= 0).sum())
        src, dst = plan.src.long(), plan.dst.long()
        check(bool(((src >= 0) & (dst >= 0)).all()),
              "library inputs out of range")
        top = int(torch.bincount(dst).max())
        del out, xg, wg, fwd, dx

        def library():
            rows = x[src]
            return torch.zeros((n_out, d), device=self.dev).index_add_(
                0, dst, rows if w is None else rows * w)

        def bwd():
            return segment_sum(g, w, plan.bwd)

        rows = e * d * 4
        x_bytes = min(n * d * 4, rows) if n * d * 4 <= L2_BYTES else rows
        in_bytes = x_bytes + (rows if weighted else 0) + e * 8
        tb = cuda_ms(torch, bwd, iters)
        tk = cuda_ms(torch, lambda: segment_sum(x, w, plan.fwd), iters)
        tp = cuda_ms(torch, lambda: segment_sum_plain(x, w, plan.fwd), 3,
                     1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, n_out * d * 4,
                         (2 if weighted else 1) * e * d)
        self.out["times"].append(dict(
            what=what, E=e, n_src=n, n_out=n_out, D=d, ms=tk, plain_ms=tp,
            library_ms=tl, bound_ms=b, bound_by=by, bwd_dx_ms=tb,
            plan_ms=plan_ms, most_edges_a_row=top, longest_chunk=hot,
            chunked_rows=parts, max_abs_err=err))
        del plan, x, w, g
        torch.cuda.empty_cache()

    def log_rows(self) -> None:
        for row in self.out["times"]:
            log("  gather_segment_sum: " + " ".join(
                f"{key}={val:.4g}" if isinstance(val, float) else
                f"{key}={val}" for key, val in row.items()))


def reddit_sampled_batch(torch, dev, cfg, seed: int) -> tuple[dict, dict]:
    """A minibatch_lg batch from the port's ``sample_subgraph``: 1,024
    seeds, fanout 15-10, over a seeded graph of 232,965 nodes whose
    out-degrees are lognormal with mean 50 (a heavy tail, as Reddit's;
    nodes with fewer than 15 or 10 neighbours leave padding edges (0, 0),
    so node 0 is a hot row). Features (602) and labels (41) of the graph
    are made on the card from ``seed``; labels are -1 off the seeds."""
    import numpy as np

    from repro_torch.data.sampler import make_csr, sample_subgraph

    r = REDDIT
    rng = np.random.default_rng(seed)
    n = r["nodes"]
    deg = rng.lognormal(math.log(r["degree"]) - r["sigma"] ** 2 / 2,
                        r["sigma"], n)
    deg = np.maximum(1, np.round(deg * r["degree"] * n / deg.sum())).astype(
        np.int64)
    edges = np.stack([np.repeat(np.arange(n), deg),
                      rng.integers(0, n, int(deg.sum()))])
    t = time.perf_counter()
    indptr, indices = make_csr(n, edges)
    seeds = rng.choice(n, r["seeds"], replace=False)
    sub = sample_subgraph(indptr, indices, seeds, r["fanout"], rng)
    host_s = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n, cfg.d_feat), generator=gen, device=dev)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen,
                           device=dev, dtype=torch.int32)
    ids = torch.from_numpy(sub.node_ids).to(dev)
    safe = ids.clamp(min=0)
    seed_mask = torch.from_numpy(sub.seed_mask).to(dev)
    batch = {"edge_index": torch.from_numpy(sub.edge_index).to(dev),
             "edge_dist": torch.from_numpy(sub.edge_dist).to(dev),
             "node_feat": torch.where(ids[:, None] >= 0, feats[safe], 0.0),
             "labels": torch.where(seed_mask, labels[safe], -1)}
    ei = sub.edge_index
    info = dict(graph_edges=int(deg.sum()), real_nodes=sub.n_real_nodes,
                real_edges=sub.n_real_edges,
                edges_into_node_0=int((ei[1] == 0).sum()),
                edges_from_node_0=int((ei[0] == 0).sum()),
                sample_host_s=host_s)
    del feats, labels
    return batch, info


def ogb_step_bound(cfg, n: int, e: int) -> tuple[float, float]:
    """(FLOPs, ms) of one ogb_products step at fp32's 67 TFLOP/s: per
    interaction the filter products forward (rbf @ filt_w1, @ filt_w2),
    again in the backward's recompute, and their backward (the gradients
    of filt_w1, of filt_w2 and of the ssp output; rbf takes none); the
    node products (in2f, f2out, atom_w) forward and backward (3 each);
    the input projection and the head forward and backward."""
    d, r = cfg.d_hidden, cfg.n_rbf
    filt = 2 * e * (r * d + d * d)
    per = 2 * filt + 2 * e * r * d + 2 * 2 * e * d * d + 3 * 3 * 2 * n * d * d
    head = 3 * 2 * n * (cfg.d_feat * d + d * (d // 2)
                        + (d // 2) * cfg.n_classes)
    flops = cfg.n_interactions * per + head
    return flops, flops / FP32_FLOPS * 1e3


def phase_schnet(torch, dev, kern: dict) -> dict:
    """Phase 11. Returns the launches of ``gather_segment_sum`` on the
    train path (the cells' steps, each step's count read from 0), not the
    checks."""
    from repro_torch.configs.schnet import SHAPES
    from repro_torch.kernels.segment_sum import EdgePlan
    from repro_torch.kernels.segment_sum import ops as ss
    from repro_torch.launch.steps import build_cell, smoke_batch
    from repro_torch.models import schnet as sm
    from repro_torch.testing import accumulating_ops
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_loop import (Trainer,
                                              grad_accum_value_and_grad)
    from repro_torch.train.tree import leaves, tree_map

    t0 = time.perf_counter()
    reduced: list = []
    counters = {"gather_segment_sum": (ss, "launches")}
    main = {"gather_segment_sum": 0}
    chk = SegmentCheck(torch, dev, SEED + 30)
    out: dict = {}

    def clone(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    def fresh(cell, seed):
        """Seeded params and AdamW's fresh state (the smoke args without
        a batch)."""
        params = sm.init_params(cell.model_cfg, seed=seed, device=dev)
        return params, adamw().init(params)

    # the kernel at the cells' shapes
    cells = {s: build_cell(SCHNET, s, device=dev) for s in SHAPES}
    batches = {s: smoke_batch(cells[s], seed=SEED + 31)
               for s in ("molecule", "full_graph_sm", "minibatch_lg")}
    mol = batches["molecule"]
    n_mol = mol["atom_z"].shape[0]
    chk.case("molecule", lambda: EdgePlan(
        mol["edge_index"][0], mol["edge_index"][1], n_mol, n_mol), 64)
    chk.case("molecule readout", lambda: EdgePlan(
        torch.arange(n_mol, device=dev), mol["graph_ids"], n_mol,
        SHAPES["molecule"]["graphs"]), 1, weighted=False)
    n_types = cells["molecule"].model_cfg.n_atom_types
    chk.case("molecule embedding gradient", lambda: EdgePlan(
        torch.arange(n_mol, device=dev), mol["atom_z"], n_mol, n_types), 64,
        weighted=False)
    mb = batches["minibatch_lg"]
    n_mb = mb["node_feat"].shape[0]
    chk.case("minibatch_lg", lambda: EdgePlan(
        mb["edge_index"][0], mb["edge_index"][1], n_mb, n_mb), 64)
    sampled, sinfo = reddit_sampled_batch(
        torch, dev, cells["minibatch_lg"].model_cfg, SEED + 32)
    log(f"  minibatch_lg sampled batch: {sinfo}")
    reduced.append(f"minibatch_lg sampled: Reddit's 114,615,892 edges -> "
                   f"{sinfo['graph_edges']} (a seeded graph of 232,965 "
                   f"nodes, lognormal out-degrees of mean 50; 602 seeded "
                   f"features, 41 classes)")
    si = sampled["edge_index"]
    chk.case("minibatch_lg sampled (hot node 0)",
             lambda: EdgePlan(si[0], si[1], n_mb, n_mb), 64)

    # the train cells at their published sizes: 3 AdamW steps each
    for shape in ("molecule", "full_graph_sm", "minibatch_lg"):
        cell = cells[shape]
        params, opt_state = fresh(cell, SEED + 33)
        batch = batches[shape]
        e = batch["edge_index"].shape[1]
        losses, hosts = train_steps(torch, f"{SCHNET} {shape}", cell,
                                    params, opt_state,
                                    [batch] * SCHNET_STEPS, e, counters,
                                    main)
        out[shape] = dict(losses=losses, host_s=[h / 1e3 for h in hosts],
                          edges_a_s=[e / h * 1e3 for h in hosts],
                          peak_gb=peak_gb(torch))
        if shape == "minibatch_lg":               # and one sampled step
            losses, hosts = train_steps(
                torch, f"{SCHNET} minibatch_lg sampled", cell, params,
                opt_state, [sampled], sampled["edge_index"].shape[1],
                counters, main, first_step=SCHNET_STEPS)
            out["minibatch_lg_sampled"] = dict(
                sinfo, loss=losses[0], host_s=hosts[0] / 1e3,
                peak_gb=peak_gb(torch))
        del params, opt_state

    # card vs CPU at full size, same weights
    for shape in ("molecule", "minibatch_lg"):
        cell = cells[shape]
        params = fresh(cell, SEED + 34)[0]
        t = time.perf_counter()
        grads_card_vs_cpu(torch, f"{SCHNET} {shape}", cell.loss, params,
                          batches[shape], _tree_cpu(params),
                          {k: v.cpu() for k, v in batches[shape].items()})
        log(f"  ({time.perf_counter() - t:.1f} s)")

    # the chunked path on the card: edge_chunk 2^14 against one chunk;
    # both, and a molecule step, run no aten op that adds at indices
    # (atomics on the card; the control: index_select's backward is one)
    x = torch.zeros((3, 2), device=dev, requires_grad=True)
    control = accumulating_ops(lambda: x.index_select(
        0, torch.tensor([0, 1, 1], device=dev)).sum().backward())
    check(control != [], "accumulating_ops missed index_select's backward")
    cell = cells["molecule"]
    params = fresh(cell, SEED + 35)[0]
    seen = accumulating_ops(lambda: grad_accum_value_and_grad(cell.loss)(
        params, mol))
    cell = cells["minibatch_lg"]
    cfg = cell.model_cfg
    params = fresh(cell, SEED + 35)[0]
    res = []
    seen += accumulating_ops(lambda: res.extend([
        grad_accum_value_and_grad(cell.loss)(params, mb),
        grad_accum_value_and_grad(
            lambda p, b: sm.node_class_loss(p, cfg, b,
                                            edge_chunk=SCHNET_CHUNK_CHECK))(
            params, mb)]))
    check(seen == [], f"{SCHNET}: ops that add at indices on the train "
                      f"path: {seen}")
    (one_l, one_g), (ch_l, ch_g) = res
    worst = abs(float(ch_l) - float(one_l)) / (1e-5 * max(1.0,
                                                          abs(float(one_l))))
    want = dict(leaves(one_g))
    for name, gch in leaves(ch_g):
        top = float(want[name].abs().max())
        worst = max(worst, float((gch - want[name]).abs().max())
                    / (1e-5 * max(top, 1e-30)))
    check(worst <= 1.0, f"{SCHNET} minibatch_lg: edge_chunk "
                        f"{SCHNET_CHUNK_CHECK} vs one chunk at {worst:.3g} "
                        f"x the limit")
    n_chunks = -(-mb["edge_index"].shape[1] // SCHNET_CHUNK_CHECK)
    log(f"  {SCHNET} minibatch_lg: {n_chunks} chunks of {SCHNET_CHUNK_CHECK} "
        f"edges against one: loss and every grad within {worst:.3g} x 1e-5 "
        f"of its largest; no op that adds at indices there or in a "
        f"molecule step (the control's: {control})")
    del params, one_g, ch_g, res

    # resume at molecule: 2 steps + checkpoint + restore + 2 = 4 straight
    cell = cells["molecule"]
    p0 = fresh(cell, SEED + 36)[0]
    four = [smoke_batch(cell, seed=SEED + 40 + i) for i in range(4)]
    one = Trainer(cell.loss, adamw(), clone(p0))
    one.run(four, n_steps=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ck-") as d:
        two = Trainer(cell.loss, adamw(), clone(p0), d, checkpoint_every=2)
        two.run(four[:2], n_steps=2)
        three = Trainer(cell.loss, adamw(), clone(p0), d)
        check(three.try_restore() and three.state.step == 2,
              "schnet resume: no checkpoint at step 2")
        three.run(four[2:], n_steps=2)
    for a, b in ((one.state.params, three.state.params),
                 (one.state.opt_state, three.state.opt_state)):
        for (name, x), (_, y) in zip(leaves(a), leaves(b)):
            check(torch.equal(x, y), f"schnet resume: {name} differs from "
                                     f"the run without a restart")
    log(f"  resume ({SCHNET} molecule, 4 steps, AdamW): params and state "
        f"after 2 + checkpoint + restore + 2 equal those of 4 straight, bit "
        f"for bit; losses {[round(h['loss'], 6) for h in one.history]}")
    del one, two, three, batches, sampled, mb, mol
    torch.cuda.empty_cache()

    # ogb_products at its published size
    cell = cells["ogb_products"]
    cfg = cell.model_cfg
    t = time.perf_counter()
    batch = smoke_batch(cell, seed=SEED + 37)
    torch.cuda.synchronize()
    n, e = batch["node_feat"].shape[0], batch["edge_index"].shape[1]
    log(f"  {SCHNET} ogb_products: {n} nodes, {e} edges, d_feat "
        f"{cfg.d_feat}, {cfg.n_classes} classes; batch made in "
        f"{time.perf_counter() - t:.1f} s, "
        f"{sum(v.numel() * v.element_size() for v in batch.values()) / 1e9:.2f}"
        f" GB")
    ei = batch["edge_index"]
    chk.case(OGB_CHUNK, lambda: sm.edge_chunks(ei, n)[0][2], 64, iters=5)
    params, opt_state = fresh(cell, SEED + 38)
    p0, o0 = clone(params), clone(opt_state)
    flops, bound = ogb_step_bound(cfg, n, e)
    losses, hosts = train_steps(torch, f"{SCHNET} ogb_products", cell,
                                params, opt_state, [batch] * SCHNET_STEPS, e,
                                counters, main)
    peak = peak_gb(torch)
    check(peak < 80.0, f"ogb_products peaked at {peak:.2f} GB")
    log(f"  {SCHNET} ogb_products bound: {bound:.1f} ms a step ({flops:.4g} "
        f"FLOPs of products at 67 TFLOP/s fp32, rbf recomputed per chunk of "
        f"{sm.EDGE_CHUNK} edges)")
    out["ogb_products"] = dict(losses=losses, host_s=[h / 1e3 for h in hosts],
                               edges_a_s=[e / h * 1e3 for h in hosts],
                               peak_gb=peak, step_bound_ms=bound,
                               step_flops=flops)
    del params, opt_state
    steps_again = []
    for _ in range(2):                     # two steps from the same state
        p, o = clone(p0), clone(o0)
        p, o, loss = cell.fn(p, o, batch, torch.tensor(0, dtype=torch.int32,
                                                       device=dev))
        steps_again.append((p, o, loss))
    (pa, oa, la), (pb, ob, lb) = steps_again
    check(torch.equal(la, lb) and float(la) == losses[0],
          f"ogb_products: two steps from one state: loss {float(la)} / "
          f"{float(lb)} / {losses[0]}")
    for a, b in ((pa, pb), (oa, ob)):
        for (name, x), (_, y) in zip(leaves(a), leaves(b)):
            check(torch.equal(x, y), f"ogb_products: two steps from one "
                                     f"state differ at {name}")
    log(f"  {SCHNET} ogb_products: two steps from one state equal bit for "
        f"bit (loss {float(la):.6f})")
    reduced.append("ogb_products: the published graph's sizes (2,449,029 "
                   "nodes padded to 2,449,056; 61,859,140 edges padded to "
                   "61,859,328; 100 features, 47 classes) over seeded edges, "
                   "features and labels (the graph is not in the repository)")
    del steps_again, pa, pb, oa, ob, p0, o0, batch, cells
    torch.cuda.empty_cache()

    chk.log_rows()
    kern["gather_segment_sum"] = chk.out
    log(json.dumps({"phase11": dict(out, reduced=reduced)}))
    log(f"  launches on the train path (phase 11's steps): {main}; phase 11 "
        f"took {time.perf_counter() - t0:.1f} s")
    check(main["gather_segment_sum"] > 0,
          "gather_segment_sum was never launched on the SchNet train path")
    return main


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit: phases 2 and "
                         "7 also hold each top-k and bag call against its "
                         "kernels, bit for bit, and time them")
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

    t0 = time.perf_counter()
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

    parent = ParentKernels(torch, args.parent) if args.parent else None

    start_phase(torch, "phase 2: kernels against their plain versions", t0)
    kern = phase_kernels(torch, dev, parent)
    kern.update(phase_attention(torch, dev))
    kern.update(phase_embedding_bag(torch, dev, parent))
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        start_phase(torch, "phase 3: temporal engine at scale", t0)
        phase_engine(torch, work)
        start_phase(torch, "phase 4: LiveVectorLake end to end", t0)
        launches, fp32_answers = phase_store(torch, work, quantized=False)
        launches_q8, _ = phase_store(torch, work, quantized=True,
                                     fp32_answers=fp32_answers)
        launches.update(launches_q8)
        start_phase(torch, "phase 5: the MiniLM embedder and stores that "
                           "embed with it", t0)
        emb, cpu_emb = phase_embedder(torch, dev)
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_decode import ops as fd
        fa.launches = fd.launches = 0
        roots = phase_rag_store(torch, work, emb, cpu_emb)
        start_phase(torch, "phase 6: RAG generation, Mistral-NeMo-12B at "
                           "full width", t0)
        phase_rag_generate(torch, roots[False], emb)
        launches["flash_attention"] = fa.launches
        launches["flash_decode"] = fd.launches
        log(f"  launches on the RAG path (phases 5-6): flash_attention "
            f"{fa.launches}, flash_decode {fd.launches}")
        for name in ("flash_attention", "flash_decode"):
            check(launches[name] > 0, f"{name} was never launched on the "
                                      f"RAG path")
        from repro_torch.configs.mistral_nemo_12b import CONFIG as NEMO
        phase_decode_vs_prefill(torch, dataclasses.replace(
            NEMO, n_layers=4, dtype=torch.float32), 256, 128,
            (SEED + 1, SEED + 4))
        start_phase(torch, "phase 7: the recsys family at full width", t0)
        launches["embedding_bag"], bag_rows = phase_recsys(torch, dev,
                                                           parent)
        kern["embedding_bag"]["times"].extend(bag_rows)
        check(launches["embedding_bag"] > 0,
              "embedding_bag was never launched on the DLRM serving path")
        start_phase(torch, "phase 8: the shard fabric on the card", t0)
        torch.cuda.empty_cache()
        fabric_launches = phase_fabric(torch, work, dev)
        phase_fanout(torch, dev, fabric_launches)
    start_phase(torch, "phase 9: the LM family's serving cells at full width",
                t0)
    torch.cuda.empty_cache()
    for name, n in phase_lm(torch, dev, kern).items():
        launches[name] += n
    for name in TILE_KERNELS:             # the store path: phases 4 and 8
        launches[name] += fabric_launches[name]
        check(fabric_launches[name] > 0,
              f"{name} was never launched on the fabric path")
    log(f"  launches of the four scans over phases 4 and 8: "
        f"{ {n: launches[n] for n in TILE_KERNELS} }")

    start_phase(torch, "phase 10: training on the card", t0)
    torch.cuda.empty_cache()
    train = phase_train(torch, dev, kern)
    for name, n in train.items():
        launches[name] = launches.get(name, 0) + n

    start_phase(torch, "phase 11: SchNet's train cells on the card", t0)
    torch.cuda.empty_cache()
    for name, n in phase_schnet(torch, dev, kern).items():
        launches[name] = launches.get(name, 0) + n

    rows = []
    main_shape = {"flash_attention": "nemo prefill 256",
                  "flash_decode": "engine cache 320",
                  "embedding_bag": "grouped serve_p99",
                  "flash_attention_bwd": "nemo train_4k",
                  "embedding_bag_bwd": "dlrm train_batch",
                  "gather_segment_sum": OGB_CHUNK}
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
