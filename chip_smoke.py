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
gather-segment-sum kernel; and the distribution layer: meshes, the
expert-parallel MoE block, DLRM's published 91.1 GB of tables as row
shards, and sharded retrieval; and the LM serving cells on a mesh:
tensor-parallel prefill and decode, the KV cache split by heads or by
sequence with the decode partials merged across ranks; and the LM and
recsys train cells on a mesh: tensor parallelism with its backward, a
vocab-parallel loss and ZeRO-1; and SchNet's train cells on a mesh with
edge-sharded message passing, and an elastic checkpoint of a sharded
train state.

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
     attention (the MiniLM encoder and BERT4Rec serve_p99 in fp32 on the
     3xTF32 body, each row's ``body=`` by the library's counts and its
     bound the 3xTF32 route, 3 x the FLOPs at 495 TFLOP/s, its FMA bound
     beside; Mistral-NeMo prefill at 256 and 4096 tokens in bf16),
     split-K decode (the engine's
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
     embedder, same weights) equivalent; every attention launch of the
     store phase on the 3xTF32 body, by the library's counts;
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
     shapes and BERT4Rec at serve_p99 (flash_attention, D = 32, every
     launch on the 3xTF32 body), card vs CPU; retrieval_cand (1 x
     1,000,448, k = 100) for the four through
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
     bf16 at D 64 and 128 on the tensor-core body and fp32 at D 32 on
     the 3xTF32 body, each by its own launch count, with its TFLOP/s;
     the fp32 rows' bound the 3xTF32 route), timed against the plain
     versions and the
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
     x 200 (every attention launch, forward and backward, on the 3xTF32
     bodies), then a resume check (a Trainer with checkpoints: 2 steps,
     save, restore, 2 more, equal to 4 straight bit for bit), and the
     same resume check of FM and Wide&Deep at full width (4 batches of
     4,096; their lookups' gradients on ``gather_segment_sum``), all with
     PyTorch's default nondeterministic algorithms. The cells'
     steps are the backward kernels' "launches" below, and add to the
     forward kernels'; a ``{"phase10": ...}`` line gives each cell's
     losses, step times, peak memory and cuts (``reduced``);
  11. SchNet's train cells on the card: ``gather_segment_sum`` against its
     plain versions (the forward kernel, and the backward kernel that
     gives the gradients of x and of w in one pass; bit for bit, signed
     zeros included, two runs bit for bit) at molecule (8,192 edges into
     3,840 atoms), its energy readout (D 1), minibatch_lg's smoke batch,
     a minibatch_lg batch from ``sample_subgraph`` (1,024 seeds, fanout
     15-10, over a seeded 232,965-node graph with lognormal out-degrees
     of mean 50: node 0, the padding edges' end, is hot) and a 2^22-edge
     slice of ogb_products, timed against the plain versions, the
     library (``index_add_``) and, for the backward, the parent's path
     (the forward kernel over the src order and ``weight_grad``); then
     the four cells through ``build_cell`` at their
     published sizes, three AdamW steps each (ogb_products: 2,449,056
     nodes, 61,859,328 edges, the filter network in chunks of 2^22
     edges under checkpoint), one step on the sampled batch, grads card
     vs CPU at molecule and minibatch_lg, minibatch_lg at edge_chunk
     2^14 against one chunk, a checkpointed resume at molecule and two
     ogb_products steps from one state, bit for bit; every cfconv
     backward of the cells' steps launches the backward kernel and none
     calls ``weight_grad``. The cells' steps are the two kernels'
     "launches" below; a ``{"phase11": ...}`` line gives
     each cell's losses, step times, edges a second, peak memory, the
     ogb_products step's bound and the cuts (``reduced``).
  12. distribution on the card: (a) the collective path at world
     ``torch.cuda.device_count()`` (NCCL, a ``FileStore``; one process a
     card): Qwen2-MoE-A2.7B's train_4k step at full width (2 of 24
     layers, 8 sequences of 4096 in 8 microbatches, expert-parallel) and
     a DLRM serve_p99 batch (MLPerf widths, tables capped at 25M rows as
     in phase 7, a NaN bag) through ``build_cell(..., mesh=
     make_host_mesh(1, world))`` against the no-mesh runs: in bf16 bit
     for bit at world 1 (loss, params and the AdamW first moments, so
     the gradients too), in fp32 by a 1e-5 rule beyond; with each path's
     ``collective_stats``; (b) Qwen2-MoE-A2.7B's MoE block at full width
     (64 padded experts, d_model 2048) as the 8 ranks of a 2 x 4 mesh run
     one after another (``moe_local``, partials summed as the collective
     would), bf16 and fp32, dropless and with capacity, against
     ``moe_block`` (fp32 1e-4, bf16 ``BF16_MOE``), the dropped pairs
     against ``moe_block``'s and the CPU's, two replays bit for bit, with
     the ranks' times; (c) DLRM at its published 91.1 GB of tables as 2
     row shards of 45.55 GB made one at a time, at serve_p99 and
     serve_bulk: each shard's one grouped bag, the sum, then the forward,
     bit for bit (NaN bags included) with a one-card forward over compact
     tables of the batch's rows, each shard's time and the peak memory;
     (d) retrieval_cand (1 x 1,000,448, k 100) as 8 candidate shards and
     a merge, held to one topk_search by phase 2's rule. No interconnect
     is measured: (b)-(d) replay a mesh's ranks on one card. A
     ``{"phase12": ...}`` line gives every number and cut.
  13. the LM family's serving cells on a mesh under repro's layouts
     (Megatron tensor parallelism over "model", ``models/tp``; the KV
     cache split by kv heads or by sequence), Mistral-NeMo-12B at full
     width with seeded bf16 weights made on the card: (a) at world
     ``torch.cuda.device_count()`` (NCCL; one process a card beyond one)
     prefill_32k (1 x 32,768), decode_32k (4 x 32,768) and long_500k (1 x
     524,288) at 2 layers, 3 decode steps each, through ``build_cell(...,
     mesh=make_host_mesh(1, world))`` against the no-mesh cells: bit for
     bit at world 1; (b) a mesh's ranks replayed one after another, layer
     by layer, each collective done by hand (``ServeReplay``):
     prefill_32k at batch 1 as the 4 ranks of 1 x 4, decode_32k at batch
     4 as the 16 ranks of 1 x 16 (the sequence over "model", wk / wv cut
     into half heads; 16 steps from cache_len 32,752 over a cache of
     seeded noise), long_500k as the 4 ranks of 2 x 2 (kv heads over
     "model", the sequence over "data"; 4 of 40 layers over the full
     524,288-entry cache, 4 steps from 262,142, so that the writing rank
     moves to the second block), each against the unsharded
     ``prefill`` / ``decode_step`` on the same weights, in bf16
     (``BF16_MOE``) and with the weights widened to fp32 (1e-4 of each
     row's largest, argmax equal), two bf16 replays bit for bit, the
     caches' unwritten rows untouched; with a rank's layer, its attention
     kernel and the merge timed (CUDA events) and each run's peak; (c)
     a rank's bytes and a token's bound for long_500k at all 40 layers
     on 2 x 2, by arithmetic. A ``{"phase13": ...}`` line gives every
     number and cut. ``--serve-long`` (a machine with 4 cards) runs only
     (d): long_500k at all 40 layers on 2 x 2, one process a card, ms a
     token, tokens/s, the peak and a profiled step.
  14. the LM and recsys train cells on a mesh under repro's layouts
     (Megatron tensor parallelism with its backward, the vocab-parallel
     loss, ZeRO-1's optimizer state, the recsys rule's row-sharded tables
     and column-parallel MLPs): (a) at world ``torch.cuda.device_count()``
     (NCCL; one ``--train-rank`` process a card beyond one) Mistral-NeMo-12B
     train_4k at full width (2 of 40 layers, 2 x 4096 in 2 microbatches,
     bf16) and DLRM train_batch (tables capped at 4M rows as in phase 10,
     4,096 samples) through ``build_cell(..., mesh=make_host_mesh(1,
     world))`` against the no-mesh steps: loss, params and AdamW m bit
     for bit at world 1, fp32 by ``DIST_FP32`` beyond; (b) a 2 x 2 mesh
     of 4 processes that share the card over gloo (NCCL takes one rank a
     card): Mistral-NeMo-12B at full width, 2 layers, fp32, 2 x 4096,
     each rank held to the no-mesh step made here (saved for them) by
     ``DIST_FP32``. Its mesh steps (a) are the forward and backward
     kernels' "launches" below; a ``{"phase14": ...}`` line gives every
     number and cut. ``--train-mesh`` (a machine with 4 cards) runs only
     (d): Mistral-NeMo-12B train_4k at all 40 layers on 2 x 2 (16 of 256
     sequences, accum 8, AdamW with ZeRO-1), one process a card: s a
     step, tokens/s, the peak a rank, the collectives of a step and a
     profiled step split into GEMMs, attention, NCCL and idle.
  15. SchNet's train cells on a mesh (the edges over every axis, the
     node rows over the data axes, an all-reduce of the aggregate a
     layer) and the elastic checkpoint of a sharded train state: (a) at
     world ``torch.cuda.device_count()`` (NCCL; one ``--gnn-rank``
     process a card beyond one) the four cells at their published sizes
     through ``build_cell(..., mesh=make_host_mesh(1, world))`` against
     the no-mesh steps: loss, params and AdamW m bit for bit at world 1,
     ``DIST_FP32`` beyond, with each step's ms, peak and collective
     record; (b) molecule and full_graph_sm on 2 x 2 as 4 gloo processes
     on the card, held to the no-mesh steps by ``DIST_FP32``; (c) the
     checkpoint round trip: 14(b)'s ranks save their 2 x 2 state
     (``CheckpointManager.save(mesh=, specs=, layout=)``) and take the
     run's step 2; this process restores it on one card (each rank's
     blocks cut from it against the rank's bit fingerprints; held to the
     no-mesh step it came from) and takes step 2, which the ranks' step
     2 must meet (``DIST_FP32`` or the order floor); (a) then restores
     it onto its world, every block bit for bit its cut of the whole
     arrays. A ``{"phase15": ...}``
     line gives every number and cut. ``--gnn-mesh`` (a machine with 4
     cards) runs only (d): ogb_products at its published size on 2 x 2,
     one NCCL process a card: the losses equal on the ranks and within
     ``DIST_FP32`` of one card's, s a step, the peak a rank and the
     collectives of a step.
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
import os
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
TF32_FLOPS = 495e12        # H100 SXM tf32 dense on the tensor cores: an
                           # fp32-accurate product there is three (3xTF32)
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
    # the fp32 forward's own body (3xTF32 on the tensor cores): MiniLM's
    # and BERT4Rec's attention
    "flash_attention_tf32": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:27 (fp32)"),
    # backward kernels: repro differentiates its references with XLA
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:27 (its "
        "backward; no Pallas counterpart)"),
    "flash_attention_bwd_tf32": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:27 (its fp32 "
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
    "gather_segment_sum_bwd": (
        "src/repro_torch/csrc/segment_sum.cu",
        "src/repro/models/schnet.py:99-100 (the VJP of jnp.take and "
        "jax.ops.segment_sum; no Pallas counterpart)"),
}
TILE_KERNELS = ("topk_search", "temporal_window_topk", "topk_search_q8",
                "temporal_window_topk_q8")
# the fp32 attention body's launches on the serving paths that run it, the
# MiniLM embedder (phase 5) and BERT4Rec (7), as the library counts them;
# phase 10 returns BERT4Rec training's with its other counts
TF32_PATH = {"flash_attention_tf32": 0, "flash_attention_bwd_tf32": 0}


# (source, kernel) whose registers, shared memory and spills phase 1 logs
PTXAS_REPORT = (("flash_attention", "fa_wgmma_kernel"),
                ("flash_attention", "fa_tf32_kernel"),
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
                ("flash_attention", "bwd_dkdv_tf32_kernel"),
                ("flash_attention", "bwd_dq_tf32_kernel"),
                ("embedding_bag", "bag_bwd_chunks"),
                ("embedding_bag", "bag_bwd_rows"),
                ("segment_sum", "gss_chunks"),
                ("segment_sum", "gss_rows"),
                ("segment_sum", "gss_bwd_chunks"))


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
               in_bytes, out_bytes, flops, iters, plain_iters, body=None):
        """``body``: the attention body that ran, by the library's counts;
        the fp32 tensor-core body's bound is the 3xTF32 route (3 x the
        FLOPs at 495 TFLOP/s: no fp32-accurate product is faster on the
        card), its FMA bound kept beside it."""
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
        extra = {}
        if body == "tf32":
            b, by = bound_ms(in_bytes, out_bytes, 3 * flops, TF32_FLOPS)
            extra["fma_bound_ms"] = bound_ms(in_bytes, out_bytes, flops,
                                             FP32_FLOPS)[0]
            extra["bound_share"] = b / t
        else:
            b, by = bound_ms(in_bytes, out_bytes, flops, self.peak[dtype])
        if body is not None:
            extra["body"] = body
        self.out[name]["times"].append(dict(
            what=what, dtype=str(dtype).removeprefix("torch."), ms=t,
            plain_ms=tp, library_ms=tl, bound_ms=b, bound_by=by,
            max_abs_err=err, median_abs_value=float(
                want.float().abs().median()), err_over_limit=ratio,
            **extra))

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
        torch = self.torch
        before = {n: getattr(fa, n) for n in ("launches", "tf32_launches")}
        got = fa.flash_attention(q, k, v, causal=causal)
        made = {n: getattr(fa, n) - before[n] for n in before}
        check(made["launches"] == 1, f"flash_attention {what}: "
                                     f"{made['launches']} launches")
        body = ("tf32" if made["tf32_launches"] else
                "wgmma" if dtype == torch.bfloat16 and d in (64, 128)
                else "cuda cores")
        check((body == "tf32") == (dtype == torch.float32 and d in (32, 64)),
              f"flash_attention {what}: the {body} body ran")
        want = flash_attention_plain(qp, k, v, causal)
        es = q.element_size()
        self.record("flash_attention", what, got[:, :, -qp.shape[2]:], want,
                    dtype, lambda: fa.flash_attention(q, k, v, causal=causal),
                    lambda: flash_attention_plain(qp, k, v, causal),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True),
                    (b * h * sq + 2 * b * kv * skv) * d * es,
                    b * h * sq * d * es,
                    4 * b * h * visible_pairs(sq, skv, causal) * d, iters, 2,
                    body=body)

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
    fa_before, tf_before = fa.launches, fa.tf32_launches
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
    tf32 = fa.tf32_launches - tf_before
    check(tf32 == fa.launches - fa_before,
          f"BERT4Rec: {tf32} of {fa.launches - fa_before} flash_attention "
          f"launches ran the 3xTF32 body")
    TF32_PATH["flash_attention_tf32"] += tf32
    log(f"  bert4rec: flash_attention launched {fa.launches - fa_before} "
        f"times ({B4R.n_layers} a forward), {tf32} on the 3xTF32 body")
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
TF32_BWD_DIMS = (32,)           # fp32 head dims whose backward is 3xTF32
LOOKUP_VOCAB = 65_536           # FM / Wide&Deep resume: rows a field


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
        tc0, tf0 = fa.bwd_tc_launches, fa.bwd_tf32_launches
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
        tc = fa.bwd_tc_launches - tc0
        tf32 = fa.bwd_tf32_launches - tf0
        check(tc == (bf16 and d in TC_BWD_DIMS),
              f"flash_attention_bwd {what}: {tc} tensor-core launches")
        check(tf32 == (not bf16 and d in TF32_BWD_DIMS),
              f"flash_attention_bwd {what}: {tf32} 3xTF32 launches")
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
        # what the body executes: 20 pairs x D on the bf16 tensor cores (P
        # and dS split in two), 3 x 14 in 3xTF32 and 14 on the CUDA cores
        # (S and dP recomputed)
        executed = (20 if tc else 42 if tf32 else 14) * pairs * d
        # the least work: 10 pairs x D, in fp32 on the 3xTF32 route
        least, peak = 10 * pairs * d, (BF16_FLOPS if bf16 else FP32_FLOPS)
        extra = {}
        if tf32:
            extra["fma_bound_ms"] = bound_ms(
                (3 * b * h * sq + 2 * b * kv * skv) * d * es + b * h * sq * 4,
                (b * h * sq + 2 * b * kv * skv) * d * es, least, peak)[0]
            least, peak = 3 * least, TF32_FLOPS
        self.row("flash_attention_bwd", what, err,
                 lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, causal),
                 lambda: flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                   causal),
                 lambda: torch.autograd.grad(out, leaves, do,
                                             retain_graph=True),
                 (3 * b * h * sq + 2 * b * kv * skv) * d * es + b * h * sq * 4,
                 (b * h * sq + 2 * b * kv * skv) * d * es, least, peak,
                 iters, 1, dtype=str(dtype).removeprefix("torch."),
                 body="wgmma" if tc else "tf32" if tf32 else "cuda cores",
                 executed_flops=executed, err_over_limit=worst,
                 chain_over_limit=chain, chain_without_bound=unbound,
                 lse_over_limit=lse_ratio, **extra)
        row = self.out["flash_attention_bwd"]["times"][-1]
        row["tflops"] = executed / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
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
    from repro_torch.train.tree import tree_map

    cell = build_cell("bert4rec", "train_batch", device=dev,
                      accum=BERT4REC_ACCUM)
    params, opt_state, batch, _ = make_smoke_args(cell, seed=SEED + 25)
    batch = {k: v[:BERT4REC_BATCH] for k, v in batch.items()}
    b, s = batch["tokens"].shape
    p0 = tree_map(lambda t: t.detach().clone(), params)
    names = ("flash_attention", "flash_attention_tf32",
             "flash_attention_bwd", "flash_attention_bwd_tf32")
    before = {n: main[n] for n in names}
    losses, hosts = train_steps(torch, "bert4rec train_batch", cell, params,
                                opt_state, [batch] * 2, b * s, counters,
                                main)
    made = {n: main[n] - before[n] for n in names}
    check(made["flash_attention"] > 0 and made["flash_attention_bwd"] > 0
          and made["flash_attention_tf32"] == made["flash_attention"]
          and made["flash_attention_bwd_tf32"] == made["flash_attention_bwd"],
          f"bert4rec train_batch: not every attention launch ran the 3xTF32 "
          f"bodies: {made}")
    reduced.append(f"bert4rec train_batch: global batch 65536 -> {b}, "
                   f"accum 16 -> {BERT4REC_ACCUM} (microbatch 4096 x 200 -> "
                   f"{b // BERT4REC_ACCUM} x 200: 6.2 GB of fp32 logits, not "
                   f"99 GB)")
    out = dict(losses=losses, host_s=[h / 1e3 for h in hosts],
               peak_gb=peak_gb(torch))
    del params, opt_state

    small = [{k: v[i * 128:(i + 1) * 128] for k, v in batch.items()}
             for i in range(4)]
    resume_check(torch, "bert4rec, 4 steps of 128 x 200", cell.loss, p0,
                 small)
    del batch, small, p0
    torch.cuda.empty_cache()
    return out


def resume_check(torch, what: str, loss, p0, batches: list) -> None:
    """The resume check: a Trainer with a CheckpointManager, 4 AdamW steps
    on ``batches`` straight against 2, a checkpoint, a fresh Trainer
    restored from it and 2 more, bit for bit (params and state), with
    PyTorch's default (nondeterministic) algorithms: no step adds with
    atomics."""
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_loop import Trainer
    from repro_torch.train.tree import leaves

    check(not torch.are_deterministic_algorithms_enabled(),
          "resume: deterministic algorithms are on")
    one = Trainer(loss, adamw(), _clone(p0))
    one.run(batches, n_steps=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ck-") as d:
        two = Trainer(loss, adamw(), _clone(p0), d, checkpoint_every=2)
        two.run(batches[:2], n_steps=2)            # an async save at 2
        three = Trainer(loss, adamw(), _clone(p0), d)
        check(three.try_restore() and three.state.step == 2,
              f"resume ({what}): no checkpoint at step 2")
        three.run(batches[2:], n_steps=2)
    for a, b in ((one.state.params, three.state.params),
                 (one.state.opt_state, three.state.opt_state)):
        for (name, x), (_, y) in zip(leaves(a), leaves(b)):
            check(torch.equal(x, y), f"resume ({what}): {name} differs from "
                                     f"the run without a restart")
    log(f"  resume ({what}, AdamW): params and state after 2 + checkpoint "
        f"+ restore + 2 equal those of 4 straight, bit for bit; losses "
        f"{[round(h['loss'], 6) for h in one.history]}")
    del one, two, three
    torch.cuda.empty_cache()


def phase_train_lookups(torch, dev, reduced: list) -> None:
    """FM and Wide&Deep train_batch at their published widths, each
    field's vocabulary cut to ``LOOKUP_VOCAB`` rows (a checkpoint of the
    full tables' state, 5–16 GB, would take the check most of a minute to
    write and read): the resume check on 4 batches of 4,096 of the smoke
    batch; their ``lookup`` gradients run ``gather_segment_sum``, in a
    fixed order."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment_sum import ops as ss
    from repro_torch.launch.steps import build_cell, make_smoke_args

    for arch in ("fm", "wide-deep"):
        cfg = dataclasses.replace(get_arch(arch).model_config(False),
                                  vocab_per_field=LOOKUP_VOCAB)
        cell = build_cell(arch, "train_batch", device=dev, model_cfg=cfg)
        params, _, batch, _ = make_smoke_args(cell, seed=SEED + 26)
        small = [{k: v[i * 4096:(i + 1) * 4096] for k, v in batch.items()}
                 for i in range(4)]
        before = ss.launches
        resume_check(torch, f"{arch}, 4 steps of 4096", cell.loss, params,
                     small)
        check(ss.launches > before, f"{arch}: lookup's gradient launched no "
                                    f"gather_segment_sum")
        reduced.append(f"{arch} resume: vocabulary 1,000,000 -> "
                       f"{LOOKUP_VOCAB} rows a field, batches of 4096")
        del params, batch, small
        torch.cuda.empty_cache()


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
                "flash_attention_tf32": (fa, "tf32_launches"),
                "flash_attention_bwd": (fa, "bwd_launches"),
                "flash_attention_bwd_wgmma": (fa, "bwd_tc_launches"),
                "flash_attention_bwd_tf32": (fa, "bwd_tf32_launches"),
                "embedding_bag": (eb, "launches"),
                "embedding_bag_bwd": (eb, "bwd_launches")}
    main = {k: 0 for k in counters}
    cells = {"nemo": phase_train_nemo(torch, dev, reduced, counters, main),
             "dlrm": phase_train_dlrm(torch, dev, reduced, counters, main),
             "bert4rec": phase_train_bert4rec(torch, dev, reduced, counters,
                                              main)}
    phase_train_lookups(torch, dev, reduced)
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
# the parent's ogb_products step with the dx kernel and weight_grad (NVIDIA
# H100 80GB HBM3, 700.00 W), for comparison
OGB_PARENT = "2.893-2.933 s a step, peak 25.58 GB"
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


def same_signed(torch, a, b) -> bool:
    """``same_values``, signed zeros too: fp32 equal bit for bit where
    not NaN."""
    na, nb = a.isnan(), b.isnan()
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                            torch.where(nb, 0.0, b).view(torch.int32)))


class SegmentCheck:
    """``gather_segment_sum`` against its plain versions on the card, bit
    for bit: the forward over the plan's dst order and the backward
    kernel's dx and dw over its src order (``segment_sum_bwd``: both
    gradients in one pass) against ``segment_sum_bwd_plain``, through
    autograd and alone, signed zeros included; two runs of each bit for
    bit; the largest |kernel - plain| over the non-NaN entries. Times of
    the forward, its plain version and the library
    (``out.index_add_(0, dst, x[src] * w)``: float atomics), and its
    bound (the bytes of w, of the gathered rows of x, of the indices and
    of out over 3.35 TB/s, an x of at most 50 MB counted at most its size
    once, as it stays in L2; 2 FLOPs an element, 1 without w). The
    backward the same way (``bwd_*``: the library
    ``dx.index_add_(0, src, g[dst] * w)`` plus ``x[src] * g[dst]``; the
    bound's bytes: the cotangent's rows (once, as x above), w, the
    indices, the rows of x the chunks read, dx and dw; 3 FLOPs an element
    of an edge, 1 without w), beside the parent's path: the forward body
    over the src order for dx (``parent_dx_ms``) plus ``weight_grad`` (two
    gathers and a product in PyTorch, ``weight_grad_ms``), ``parent_ms``
    their sum."""

    def __init__(self, torch, dev, seed: int):
        self.torch, self.dev = torch, dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.out = {"err": 0.0, "times": []}
        self.bwd = {"err": 0.0, "times": []}

    def randn(self, shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def case(self, what: str, make_plan, d: int, weighted: bool = True,
             iters: int = 20) -> None:
        """The check and the times over ``make_plan()``'s ``EdgePlan`` (its
        time is the row's plan_ms) with seeded x (n_src, d), w and the
        cotangent."""
        from repro_torch.kernels.segment_sum import (gather_segment_sum,
                                                     segment_sum,
                                                     segment_sum_bwd,
                                                     segment_sum_bwd_plain,
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
        want_dx, want_dw = segment_sum_bwd_plain(x, g, w, plan)
        dx, dw = segment_sum_bwd(x, g, w, plan)
        pairs = [("forward", out.detach(), segment_sum_plain(x, w, plan.fwd),
                  fwd, self.out), ("dx", xg.grad, want_dx, dx, self.bwd)]
        if w is not None:
            pairs.append(("dw", wg.grad, want_dw, dw, self.bwd))
        err = {}
        for name, got, want, again, into in pairs:
            check(same_signed(torch, got, want),
                  f"gather_segment_sum {what}: {name} differs from plain")
            check(same_signed(torch, got, again),
                  f"gather_segment_sum {what}: two runs of {name} differ")
            err[name] = float(torch.where(
                got.isnan() | want.isnan(), 0.0, got - want).abs().max()
                if got.numel() else 0.0)
            into["err"] = max(into["err"], err[name])
        hot = int(plan.fwd["count"].max()) if len(plan.fwd["count"]) else 0
        parts = int((plan.fwd["part"] >= 0).sum())
        src, dst = plan.src.long(), plan.dst.long()
        check(bool(((src >= 0) & (dst >= 0)).all()),
              "library inputs out of range")
        top = int(torch.bincount(dst).max())
        chunks = len(plan.bwd["start"])
        del out, xg, wg, fwd, dx, dw, want_dx, want_dw

        def library():
            rows = x[src]
            return torch.zeros((n_out, d), device=self.dev).index_add_(
                0, dst, rows if w is None else rows * w)

        def bwd_library():
            rows = g[dst]
            gx = torch.zeros((n, d), device=self.dev).index_add_(
                0, src, rows if w is None else rows * w)
            return gx, None if w is None else x[src] * rows

        rows = e * d * 4
        x_bytes = min(n * d * 4, rows) if n * d * 4 <= L2_BYTES else rows
        in_bytes = x_bytes + (rows if weighted else 0) + e * 8
        g_bytes = min(n_out * d * 4, rows) if n_out * d * 4 <= L2_BYTES \
            else rows
        tb = cuda_ms(torch, lambda: segment_sum_bwd(x, g, w, plan), iters)
        tbp = cuda_ms(torch, lambda: segment_sum_bwd_plain(x, g, w, plan), 3,
                      1)
        tbl = cuda_ms(torch, bwd_library, iters, 1)
        tdx = cuda_ms(torch, lambda: segment_sum(g, w, plan.bwd), iters)
        twg = cuda_ms(torch, lambda: weight_grad(x, g, plan), iters) \
            if weighted else None
        bb, bby = bound_ms(
            g_bytes + (rows if weighted else 0) + e * 8
            + (chunks * d * 4 if weighted else 0),
            n * d * 4 + (rows if weighted else 0),
            (3 if weighted else 1) * e * d)
        tk = cuda_ms(torch, lambda: segment_sum(x, w, plan.fwd), iters)
        tp = cuda_ms(torch, lambda: segment_sum_plain(x, w, plan.fwd), 3,
                     1)
        tl = cuda_ms(torch, library, iters, 1)
        b, by = bound_ms(in_bytes, n_out * d * 4,
                         (2 if weighted else 1) * e * d)
        shape = dict(what=what, E=e, n_src=n, n_out=n_out, D=d)
        self.out["times"].append(dict(
            shape, ms=tk, plain_ms=tp, library_ms=tl, bound_ms=b,
            bound_by=by, plan_ms=plan_ms, most_edges_a_row=top,
            longest_chunk=hot, chunked_rows=parts,
            max_abs_err=err["forward"]))
        self.bwd["times"].append(dict(
            shape, ms=tb, plain_ms=tbp, library_ms=tbl, bound_ms=bb,
            bound_by=bby, parent_ms=tdx + (twg or 0.0), parent_dx_ms=tdx,
            weight_grad_ms=twg, src_rows=chunks, gap=plan.bwd["gap"],
            max_abs_err=max(v for k, v in err.items() if k != "forward")))
        del plan, x, w, g
        torch.cuda.empty_cache()

    def log_rows(self) -> None:
        for name, r in (("gather_segment_sum", self.out),
                        ("gather_segment_sum_bwd", self.bwd)):
            for row in r["times"]:
                log(f"  {name}: " + " ".join(
                    f"{key}={val:.4g}" if isinstance(val, float) else
                    f"{key}={val}" for key, val in row.items()))


class CfconvBackwards:
    """Counts, over a block, the calls of ``segment_sum_bwd`` with a w
    (SchNet's cfconv backwards: the readout's has none) and all of them,
    and the calls of ``weight_grad``, which the card's backward must
    never make (its kernel gives dw)."""

    def __init__(self):
        from repro_torch.kernels.segment_sum import ops as ss
        from repro_torch.kernels.segment_sum import plain

        self.mods = ss, plain
        self.n = {"with_w": 0, "all": 0, "weight_grad": 0}

    def __enter__(self):
        ss, plain = self.mods
        self.real = ss.segment_sum_bwd, plain.weight_grad

        def bwd(x, g, w, plan, *args, **kwargs):
            self.n["all"] += 1
            self.n["with_w"] += w is not None
            return self.real[0](x, g, w, plan, *args, **kwargs)

        def wgrad(*args):
            self.n["weight_grad"] += 1
            return self.real[1](*args)

        ss.segment_sum_bwd, plain.weight_grad = bwd, wgrad
        return self

    def __exit__(self, *exc):
        ss, plain = self.mods
        ss.segment_sum_bwd, plain.weight_grad = self.real


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


def cfconv_steps(torch, what: str, cell, params, opt_state, batches: list,
                 counters: dict, main: dict, first_step: int = 0):
    """``train_steps`` of a SchNet cell, checking that every cfconv
    backward (an interaction and edge chunk a step) launched the backward
    kernel and that none called ``weight_grad``."""
    from repro_torch.models import schnet as sm

    e = batches[0]["edge_index"].shape[1]
    before = main["gather_segment_sum_bwd"]
    with CfconvBackwards() as cb:
        res = train_steps(torch, what, cell, params, opt_state, batches, e,
                          counters, main, first_step=first_step)
    want = (cell.model_cfg.n_interactions * max(1, -(-e // sm.EDGE_CHUNK))
            * len(batches))
    launched = main["gather_segment_sum_bwd"] - before
    check(cb.n["with_w"] == want and launched == cb.n["all"]
          and cb.n["weight_grad"] == 0,
          f"{what}: {cb.n['with_w']} cfconv backwards of {want}, "
          f"{launched} backward launches for {cb.n['all']} calls, "
          f"weight_grad called {cb.n['weight_grad']} times")
    log(f"  {what}: all {want} cfconv backwards launched "
        f"gather_segment_sum_bwd, weight_grad never called")
    return res


def phase_schnet(torch, dev, kern: dict) -> dict:
    """Phase 11. Returns the launches of ``gather_segment_sum`` and its
    backward kernel on the train path (the cells' steps, each step's
    count read from 0), not the checks."""
    from repro_torch.configs.schnet import SHAPES
    from repro_torch.kernels.segment_sum import EdgePlan
    from repro_torch.kernels.segment_sum import ops as ss
    from repro_torch.launch.steps import build_cell, smoke_batch
    from repro_torch.models import schnet as sm
    from repro_torch.testing import accumulating_ops
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves, tree_map

    t0 = time.perf_counter()
    reduced: list = []
    counters = {"gather_segment_sum": (ss, "launches"),
                "gather_segment_sum_bwd": (ss, "bwd_launches")}
    main = {k: 0 for k in counters}
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
        losses, hosts = cfconv_steps(torch, f"{SCHNET} {shape}", cell,
                                     params, opt_state,
                                     [batch] * SCHNET_STEPS, counters, main)
        out[shape] = dict(losses=losses, host_s=[h / 1e3 for h in hosts],
                          edges_a_s=[e / h * 1e3 for h in hosts],
                          peak_gb=peak_gb(torch))
        if shape == "minibatch_lg":               # and one sampled step
            losses, hosts = cfconv_steps(
                torch, f"{SCHNET} minibatch_lg sampled", cell, params,
                opt_state, [sampled], counters, main,
                first_step=SCHNET_STEPS)
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
    resume_check(torch, f"{SCHNET} molecule, 4 steps", cell.loss,
                 fresh(cell, SEED + 36)[0],
                 [smoke_batch(cell, seed=SEED + 40 + i) for i in range(4)])
    del batches, sampled, mb, mol
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
    losses, hosts = cfconv_steps(torch, f"{SCHNET} ogb_products", cell,
                                 params, opt_state, [batch] * SCHNET_STEPS,
                                 counters, main)
    peak = peak_gb(torch)
    check(peak < 80.0, f"ogb_products peaked at {peak:.2f} GB")
    log(f"  {SCHNET} ogb_products: steps {[round(h / 1e3, 4) for h in hosts]}"
        f" s, peak {peak:.2f} GB (the parent's dx kernel + weight_grad: "
        f"{OGB_PARENT})")
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
    kern["gather_segment_sum_bwd"] = chk.bwd
    log(json.dumps({"phase11": dict(out, reduced=reduced)}))
    log(f"  launches on the train path (phase 11's steps): {main}; phase 11 "
        f"took {time.perf_counter() - t0:.1f} s")
    for name, n in main.items():
        check(n > 0, f"{name} was never launched on the SchNet train path")
    return main


# ---------------------------------------------------------------------------
# phase 12: distribution on the card
# ---------------------------------------------------------------------------
DIST_QWEN = dict(layers=2, batch=8)   # 12(a): of 24 layers and 256 rows
# 12(a) beyond one card the mesh step sums the MoE's partial outputs over
# the model ranks, in another order than moe_block's k slots. In bf16 each
# such value moves by a rounding step, and the gradients' bf16 sums over
# tokens and microbatches, which cancel, carry that past any limit on a
# leaf's largest value that would still catch a wrong gradient. So there
# the step runs at the same widths in fp32 and is held as the CPU test of
# the 2 x 4 step holds it: the loss within 1e-5 relative, each leaf's
# AdamW first moment ((1 - b1) g after step 0) within 1e-5 of the leaf's
# largest, each param within 1e-5 + 2 lr_t
DIST_FP32 = dict(loss=1e-5, grad=1e-5, param=1e-5)
MOE_REPLAY = (2, 4)             # 12(b): the (data, model) mesh replayed
MOE_REPLAY_TOKENS = 2048        # 12(b): tokens a data rank
DLRM_SHARDS = 2                 # 12(c): model ranks of DLRM's tables
RETRIEVAL_SHARDS = 8            # 12(d): candidate shards
DIST_TIMEOUT = 300              # 12(a) with more than one card: rank timeout


class PathCounts:
    """Launch counts of the calls made through it: ``count(fn, *args)``
    reads each kernel's counter just before and just after ``fn`` and adds
    the difference (reference runs made beside the path go around it)."""

    def __init__(self, counters: dict):
        self.counters, self.n = counters, {k: 0 for k in counters}

    def __call__(self, fn, *args, **kwargs):
        before = {k: getattr(m, a) for k, (m, a) in self.counters.items()}
        res = fn(*args, **kwargs)
        for k, (m, a) in self.counters.items():
            self.n[k] += getattr(m, a) - before[k]
        return res


def dist_rank(torch, rank: int, world: int, store: str,
              dev_type: str = "cuda", count=None) -> dict:
    """12(a) on one rank of a NCCL process group of ``world`` ranks, one
    a card, met through a ``FileStore`` at ``store``: Qwen2-MoE-A2.7B's
    train_4k step at full width (``DIST_QWEN``'s cut of layers and
    batch, accum 8 kept), in its bf16 at world 1 and in fp32 beyond and a DLRM serve_p99 batch (MLPerf
    widths, tables capped at 25M rows, a NaN bag) through
    ``build_cell(..., mesh=make_host_mesh(1, world))``, each against the
    no-mesh run on the same card: at world 1 (every collective a copy)
    the loss, the params and the AdamW first moments after the step bit
    for bit, so the gradients too; beyond, by ``DIST_FP32``. The DLRM
    logits are bit for bit at any world (one rank's row plus zeros).
    Returns the losses, the times and each path's ``collective_stats``.
    ``count`` (a ``PathCounts``) wraps the mesh path's calls."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.configs.dlrm_mlperf import ONE_CARD
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.recsys import dlrm_init

    count = count or (lambda fn, *a, **k: fn(*a, **k))
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {"world": world, "device": dev_type}
    try:
        mesh = make_host_mesh(1, world, device_type=dev_type)
        cfg = dataclasses.replace(get_arch(QWEN_MOE).model_config(False),
                                  n_layers=DIST_QWEN["layers"])
        if world > 1:
            cfg = dataclasses.replace(cfg, dtype=torch.float32)
        one = build_cell(QWEN_MOE, "train_4k", device=dev, model_cfg=cfg)
        sharded = build_cell(QWEN_MOE, "train_4k", device=dev,
                             model_cfg=cfg, mesh=mesh)
        check(sharded.model_cfg.moe_mesh is mesh,
              "12(a): the Qwen2-MoE cell did not take the expert-parallel "
              "path")
        check(one.accum == sharded.accum == 8,
              f"12(a) Qwen2-MoE: accum {one.accum}, {sharded.accum} on the "
              f"mesh")

        def args_of(cell):
            params, opt, batch, step = make_smoke_args(cell, seed=SEED)
            n = DIST_QWEN["batch"]
            return params, opt, {k: v[:n] for k, v in batch.items()}, step

        torch.cuda.reset_peak_memory_stats()
        p1, o1, l1 = one.fn(*args_of(one))
        m1 = o1["m"]           # (1 - b1) g after step 0: the gradients
        del o1
        torch.cuda.empty_cache()
        args = args_of(sharded)
        col.take_records()
        torch.cuda.synchronize()
        t = time.perf_counter()
        p2, o2, l2 = count(sharded.fn, *args)
        torch.cuda.synchronize()
        out["qwen_step_ms"] = (time.perf_counter() - t) * 1e3
        out["qwen_collectives"] = col.collective_stats(col.take_records())
        out["qwen_peak_gb"] = peak_gb(torch)
        worst = {what: mesh_step_leaves(
            torch, f"12(a) Qwen2-MoE {what}", rank_blocks(
                sharded, want, opt=what == "m"), got, world == 1)
            for what, want, got in (("param", p1, p2), ("m", m1, o2["m"]))}
        if world == 1:
            check(torch.equal(l1, l2), f"12(a) Qwen2-MoE: loss {float(l2)} "
                                       f"on the mesh, {float(l1)} without")
        else:
            rel = abs(float(l1) - float(l2)) / abs(float(l1))
            worst["loss"] = rel / DIST_FP32["loss"]
            check(rel <= DIST_FP32["loss"],
                  f"12(a) Qwen2-MoE: loss {float(l2)} vs {float(l1)}")
            out["qwen_worst_ratio"] = worst
        out["qwen_loss"] = float(l2)
        del p1, p2, m1, o2, args
        torch.cuda.empty_cache()

        params = train_tree(dlrm_init(ONE_CARD, seed=SEED, device=dev))
        serve_one = build_cell("dlrm-mlperf", "serve_p99", device=dev,
                               model_cfg=ONE_CARD)
        serve = build_cell("dlrm-mlperf", "serve_p99", device=dev,
                           model_cfg=ONE_CARD, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)
        b = 512
        ids = torch.stack([torch.randint(0, v, (b,), generator=gen,
                                         device=dev, dtype=torch.int32)
                           for v in ONE_CARD.table_sizes], 1)[..., None]
        ids[0, 0, 0] = ONE_CARD.padded_table_sizes[0]      # a NaN bag
        batch = {"dense": torch.rand((b, ONE_CARD.n_dense), generator=gen,
                                     device=dev), "sparse_ids": ids}
        pspec, bspec = serve.executed_specs()
        with torch.no_grad():
            want = serve_one.fn(params, batch)
            # views of the rank's blocks: a copy of 58.3 GB would not fit
            p_loc = distribute_tree(params, pspec, mesh)
            b_loc = distribute_tree(batch, bspec, mesh)
            col.take_records()
            got = count(serve.fn, p_loc, b_loc)
        out["dlrm_collectives"] = col.collective_stats(col.take_records())
        check(bool(want[0].isnan()) and same_values(torch, got, want),
              "12(a) DLRM serve_p99: logits on the mesh differ from one "
              "card's")
        del params, p_loc
        torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_dist_collective(torch, work: str, dev_type: str,
                          count) -> dict:
    """12(a) at world ``torch.cuda.device_count()``: in this process on
    one card; with more, one process a card (this script with
    ``--dist-rank``), each held to its own no-mesh runs, killed after
    ``DIST_TIMEOUT`` s."""
    world = torch.cuda.device_count()
    store = str(Path(work) / "nccl-store")
    if world == 1:
        return dist_rank(torch, 0, 1, store, dev_type, count)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-rank",
         str(r), "--dist-world", str(world), "--dist-store", store],
        stdout=subprocess.PIPE, text=True) for r in range(1, world)]
    try:
        out = dist_rank(torch, 0, world, store, dev_type, count)
        for p in procs:
            p.communicate(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"12(a): a rank exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def phase_moe_replay(torch, dev) -> dict:
    """12(b): Qwen2-MoE-A2.7B's MoE block at full width (64 padded
    experts, 16 a model rank, d_model 2048) as the ranks of a 2 x 4
    mesh, one after another on the card: each rank's ``moe_local`` on its
    data rank's tokens and its experts, the partials summed over the
    model ranks in order as the collective would, the shared experts
    added; held to ``moe_block`` on each data rank's tokens (the same
    local capacity), fp32 at 1e-4 and bf16 by ``BF16_MOE``, dropless and
    with capacity (expert 0's router column x 3 so that some drop); the
    dropped pairs against ``moe_block``'s and against a CPU run of each
    rank's ``moe_local`` routing; two replays bit for bit. Times each
    rank's body and ``moe_block`` (CUDA events)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as pm
    from repro_torch.testing import rounding_agree

    cfg = get_arch(QWEN_MOE).model_config(False)
    m = cfg.moe
    n_data, n_model = MOE_REPLAY
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    p = pm.moe_params(gen, cfg.d_model, m, torch.bfloat16, dev)
    p["router"][:, 0] *= 3.0
    e_pad = p["w_in"].shape[0]
    e_loc = e_pad // n_model
    x = torch.randn((n_data, MOE_REPLAY_TOKENS, cfg.d_model), generator=gen,
                    device=dev, dtype=torch.bfloat16)
    out = {}

    def replay(pw, xw, dropless):
        outs, auxes = [], []
        for d in range(n_data):
            xd = xw[d:d + 1]
            total = None
            for r in range(n_model):
                sl = slice(r * e_loc, (r + 1) * e_loc)
                part, aux = pm.moe_local(xd, pw["router"], pw["w_in"][sl],
                                         pw["w_out"][sl], r, e_loc, m,
                                         dropless)
                total = part if total is None else total + part
            t = xd.shape[0] * xd.shape[1]
            outs.append(total + pm._shared_ffn(
                pw, xd.reshape(t, -1), m.act).reshape(xd.shape))
            auxes.append(aux)
        return outs, auxes

    with torch.no_grad():
        for dtype, rule in ((torch.bfloat16, BF16_MOE),
                            (torch.float32, dict(rel=1e-4, slack=1e-4))):
            name = str(dtype).removeprefix("torch.")
            pw = {k: (v if k == "router" else v.to(dtype))
                  for k, v in p.items()}
            xw = x.to(dtype)
            for dropless in (True, False):
                mode = "dropless" if dropless else "capacity"
                got, _ = replay(pw, xw, dropless)
                again, _ = replay(pw, xw, dropless)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"12(b) {name} {mode}: two replays differ")
                worst, n_drops = 0.0, 0
                for d in range(n_data):
                    xd = xw[d:d + 1]
                    want, _ = pm.moe_block(pw, xd, m, dropless)
                    ok, ratio = rounding_agree(got[d], want, **rule)
                    check(ok, f"12(b) {name} {mode} data rank {d}: "
                              f"{ratio:.3g} x the limit")
                    worst = max(worst, ratio)
                    ranks = [pm.local_dropped_pairs(
                        xd, pw["router"], r, e_loc, e_pad, m, dropless)
                        for r in range(n_model)]
                    mine = torch.cat(ranks)
                    mine = mine[torch.argsort(mine[:, 0] * e_pad
                                              + mine[:, 1])]
                    check(torch.equal(mine, pm.dropped_pairs(
                        pw, xd, m, dropless)),
                          f"12(b) {name} {mode}: the ranks' dropped pairs "
                          f"differ from moe_block's")
                    for r in range(n_model):
                        check(torch.equal(ranks[r].cpu(),
                                          pm.local_dropped_pairs(
                                              xd.cpu(), pw["router"].cpu(),
                                              r, e_loc, e_pad, m,
                                              dropless)),
                              f"12(b) {name} {mode} rank ({d}, {r}): dropped "
                              f"pairs card vs CPU")
                    n_drops += len(mine)
                check(dropless == (n_drops == 0),
                      f"12(b) {name} {mode}: {n_drops} dropped pairs")
                xd = xw[:1]
                rank_ms = [cuda_ms(torch, lambda r=r: pm.moe_local(
                    xd, pw["router"], pw["w_in"][r * e_loc:(r + 1) * e_loc],
                    pw["w_out"][r * e_loc:(r + 1) * e_loc], r, e_loc, m,
                    dropless), 3, 1) for r in range(n_model)]
                block_ms = cuda_ms(torch, lambda: pm.moe_block(
                    pw, xd, m, dropless), 3, 1)
                out[f"{name}_{mode}"] = dict(
                    ratio=worst, dropped=n_drops, rank_ms=rank_ms,
                    moe_block_ms=block_ms)
                log(f"  12(b) MoE block 2x4 replay, {name} {mode} "
                    f"(cap {pm.capacity(MOE_REPLAY_TOKENS, m, dropless)} a "
                    f"rank): {worst:.3g} x the limit against moe_block; "
                    f"{n_drops} pairs dropped, the same as moe_block's and "
                    f"as the CPU's; two replays bit for bit; a data rank's "
                    f"4 model-rank bodies {', '.join(f'{t:.3f}' for t in rank_ms)}"
                    f" ms (sum {sum(rank_ms):.3f}) against moe_block on its "
                    f"{MOE_REPLAY_TOKENS} tokens {block_ms:.3f} ms")
            del pw
    del p, x
    torch.cuda.empty_cache()
    return out


def phase_dlrm_shards(torch, dev, count) -> dict:
    """12(c): DLRM at its published 91.1 GB of tables as 2 row shards of
    45.55 GB, made one at a time on the card (``dlrm_shard_init``: each
    shard's rows from generators of its own, shard 0 freed before shard
    1 is made), at serve_p99 and serve_bulk: each shard's one grouped
    ``embedding_bag`` launch over its blocks (``RowShardedBag.local``,
    timed), the two partials summed over the row-sharded fields as the
    collective would, then the forward's rest; held bit for bit (NaN bags
    included) to a one-card forward over compact tables of the batch's
    rows gathered from the same shards."""
    from repro_torch.configs.dlrm_mlperf import CONFIG
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as rm

    cfg = CONFIG
    mesh = MeshShape((1, DLRM_SHARDS), ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    batches = {}
    for shape in ("serve_p99", "serve_bulk"):
        b = next(iter(build_cell("dlrm-mlperf", shape,
                                 device=dev).arg_specs[1].values())).shape[0]
        ids = torch.stack([torch.randint(0, v, (b,), generator=gen,
                                         device=dev, dtype=torch.int32)
                           for v in cfg.table_sizes], 1)[..., None]
        if shape == "serve_p99":
            ids[0, 0, 0] = cfg.padded_table_sizes[0]     # past a sharded one
            ids[1, 5, 0] = cfg.padded_table_sizes[5]     # past a whole one
        comp_ids = torch.empty_like(ids)
        uniq = []
        for i, vp in enumerate(cfg.padded_table_sizes):
            col = ids[:, i, 0]
            ok = (col >= 0) & (col < vp)
            u, inv = torch.unique(col[ok], return_inverse=True)
            c = torch.full_like(col, len(u))               # past: NaN
            c[ok] = inv.to(c.dtype)
            comp_ids[:, i, 0] = c
            uniq.append(u)
        batches[shape] = dict(
            dense=torch.rand((b, cfg.n_dense), generator=gen, device=dev),
            ids=ids, comp_ids=comp_ids, uniq=uniq,
            compact=[torch.empty((len(u), cfg.embed_dim), device=dev)
                     for u in uniq], partials=[], ms=[])
    torch.cuda.reset_peak_memory_stats()
    out = {"shards": []}
    mlps = None
    for shard in range(DLRM_SHARDS):
        t = time.perf_counter()
        params = rm.dlrm_shard_init(cfg, mesh, shard, seed=SEED, device=dev)
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t
        gb = sum(x.numel() * 4 for x in params["tables"].values()) / 1e9
        bag = rm.RowShardedBag(cfg, mesh, shard=shard)
        tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
        rec = {"shard": shard, "table_gb": gb, "make_s": make_s}
        with torch.no_grad():
            for shape, bt in batches.items():
                bt["partials"].append(count(bag.local, tables, bt["ids"]))
                ms = cuda_ms(torch, lambda: count(bag.local, tables,
                                                  bt["ids"]),
                             20 if shape == "serve_p99" else 3, 1)
                bt["ms"].append(ms)
                rec[f"{shape}_bag_ms"] = ms
                for i, (lo, hi) in enumerate(bag.rows):
                    whole = hi - lo == cfg.padded_table_sizes[i]
                    if whole and shard > 0:
                        continue                 # whole on every shard
                    u = bt["uniq"][i]
                    sel = (u >= lo) & (u < hi)
                    bt["compact"][i][sel] = tables[i][u[sel] - lo]
        torch.cuda.synchronize()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  12(c) DLRM shard {shard} of {DLRM_SHARDS}: {gb:.2f} GB of "
            f"tables made in {make_s:.1f} s; its grouped bag "
            + ", ".join(f"{s} {batches[s]['ms'][-1]:.4f} ms"
                        for s in batches)
            + f" (CUDA events); peak allocated {rec['peak_gb']:.2f} GB")
        out["shards"].append(rec)
        if mlps is None:
            mlps = {"bot": params["bot"], "top": params["top"]}
        del params, tables, bag
        torch.cuda.empty_cache()
    sharded = rm.RowShardedBag(cfg, mesh, shard=0).sharded
    with torch.no_grad():
        for shape, bt in batches.items():
            feats = bt["partials"][0].clone()
            for part in bt["partials"][1:]:
                feats[:, sharded] = feats[:, sharded] + part[:, sharded]

            def summed_bag(tables, ids, weights, combiner, out=None):
                return out.copy_(feats)

            compact = {"tables": {f"table_{i}": c for i, c in
                                  enumerate(bt["compact"])}, **mlps}
            got = rm.dlrm_forward(compact, cfg, bt["dense"], bt["ids"],
                                  bag=summed_bag)
            want = rm.dlrm_forward(compact, cfg, bt["dense"], bt["comp_ids"])
            nan = int(want.isnan().sum())
            check(same_values(torch, got, want),
                  f"12(c) DLRM {shape}: the shards' summed forward differs "
                  f"from the compact-table forward")
            check(nan == (2 if shape == "serve_p99" else 0),
                  f"12(c) DLRM {shape}: {nan} NaN logits")
            out[shape] = dict(b=int(bt["ids"].shape[0]), bag_ms=bt["ms"],
                              nan=nan)
            log(f"  12(c) DLRM {shape} (B={bt['ids'].shape[0]}): the 2 row "
                f"shards' summed forward equals the one-card forward over "
                f"compact tables of the batch's rows bit for bit ({nan} NaN "
                f"bags at the same samples)")
            del feats, bt["partials"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["table_gb"] = sum(r["table_gb"] for r in out["shards"])
    del batches, mlps
    torch.cuda.empty_cache()
    return out


def phase_retrieval_shards(torch, dev, count) -> dict:
    """12(d): retrieval_cand (1 x 1,000,448, k 100; DLRM's d = 128) as 8
    candidate shards: ``retrieval_shard_topk`` on each shard's rows, then
    the merge of the 8 (Q, k) blocks, held to one ``topk_search`` over
    all rows by phase 2's rule; times each."""
    from repro_torch.kernels.common import merge_candidates
    from repro_torch.launch.steps import (build_cell, retrieval_shard_topk,
                                          smoke_batch)
    from repro_torch.testing import topk_agree

    bundle = build_cell("dlrm-mlperf", "retrieval_cand", device=dev)
    batch = smoke_batch(bundle, seed=SEED)
    n = batch["candidates"].shape[0]
    n_loc = n // RETRIEVAL_SHARDS
    check(n % RETRIEVAL_SHARDS == 0, f"12(d): {n} rows over "
                                     f"{RETRIEVAL_SHARDS} shards")
    shards = [{k: (v if k == "query" else v[r * n_loc:(r + 1) * n_loc])
               for k, v in batch.items()} for r in range(RETRIEVAL_SHARDS)]

    def sharded():
        blocks = [retrieval_shard_topk(b, 100, r)
                  for r, b in enumerate(shards)]
        return merge_candidates(torch.stack([s for s, _ in blocks]),
                                torch.stack([i for _, i in blocks]), 100)

    with torch.no_grad():
        s, i = count(sharded)
        ws, wi = bundle.fn(batch)
        ok, err, why = topk_agree(s, i, ws, wi)
        check(ok, f"12(d) retrieval over {RETRIEVAL_SHARDS} shards: {why}")
        exact = bool(torch.equal(s, ws) and torch.equal(i, wi))
        shard_ms = cuda_ms(torch, lambda: count(
            retrieval_shard_topk, shards[0], 100, 0), 20, 2)
        all_ms = cuda_ms(torch, lambda: count(sharded), 20, 2)
        one_ms = cuda_ms(torch, lambda: bundle.fn(batch), 20, 2)
    log(f"  12(d) retrieval_cand (1 x {n}, k 100) over {RETRIEVAL_SHARDS} "
        f"shards of {n_loc}: equal to one topk_search by phase 2's rule "
        f"(max score diff {err:.3g}; bit for bit: {exact}); a shard "
        f"{shard_ms:.4f} ms, the 8 shards and the merge in turn "
        f"{all_ms:.4f} ms, one scan of all rows {one_ms:.4f} ms")
    return dict(exact=exact, shard_ms=shard_ms, replay_ms=all_ms,
                one_ms=one_ms)


def phase_distribution(torch, dev) -> dict:
    """Phase 12. Returns the launches of the kernels on its sharded paths
    (12(a), (c), (d): each call's counts read from just before it to just
    after), not those of the runs they are held to."""
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.topk_search import ops as kops

    t0 = time.perf_counter()
    count = PathCounts({"flash_attention": (fa, "launches"),
                        "flash_attention_bwd": (fa, "bwd_launches"),
                        "embedding_bag": (eb, "launches"),
                        "topk_search": (kops, "launches")})
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dist-") as work:
        a = phase_dist_collective(torch, work, dev.type, count)
    held = "in bf16 bit for bit, AdamW first moments included" \
        if a["world"] == 1 else \
        f"in fp32 by DIST_FP32 {json.dumps(a['qwen_worst_ratio'])}"
    log(f"  12(a) NCCL world {a['world']}: Qwen2-MoE train_4k at full width "
        f"({DIST_QWEN['layers']} layers, {DIST_QWEN['batch']} x 4096 "
        f"in 8 microbatches) through build_cell(mesh=) equal to the "
        f"no-mesh step {held} (loss {a['qwen_loss']:.6f}, "
        f"{a['qwen_step_ms']:.1f} ms, peak "
        f"{a['qwen_peak_gb']:.2f} GB); DLRM serve_p99 (tables capped at 25M "
        f"rows) bit for bit, NaN bag included")
    log(f"  12(a) collective_stats, Qwen2-MoE step: "
        f"{json.dumps(a['qwen_collectives'])}")
    log(f"  12(a) collective_stats, DLRM batch: "
        f"{json.dumps(a['dlrm_collectives'])}")
    torch.cuda.empty_cache()
    b = phase_moe_replay(torch, dev)
    c = phase_dlrm_shards(torch, dev, count)
    d = phase_retrieval_shards(torch, dev, count)
    main = count.n
    log(json.dumps({"phase12": dict(
        collective=a, moe_replay=b, dlrm_shards=c, retrieval=d,
        reduced=[f"12(a): Qwen2-MoE train_4k 24 -> {DIST_QWEN['layers']} "
                 f"layers; global batch 256 -> {DIST_QWEN['batch']} "
                 f"(accum 8 kept: microbatch 1 x 4096)", "12(a): DLRM "
                 "at MLPerf widths, tables capped at 25M rows (58.3 of "
                 "91.1 GB, as phase 7)", "12(b): one MoE layer, 2 x "
                 f"{MOE_REPLAY_TOKENS} tokens", "12(b)-(d): the ranks run "
                 f"one after another on one card: no interconnect is "
                 f"measured"])}))
    log(f"  launches on phase 12's paths: {main}; phase 12 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name, n in main.items():
        check(n > 0, f"{name} was never launched on phase 12's paths")
    return main


# ---------------------------------------------------------------------------
# phase 13: the LM family's serving cells on a mesh (tensor parallelism)
# ---------------------------------------------------------------------------
SERVE_LAYERS = dict(prefill_32k=2, decode_32k=2, long_500k=4)   # of 40
SERVE_MESH = dict(prefill_32k=(1, 4), decode_32k=(1, 16),
                  long_500k=(2, 2))      # 13(b): the (data, model) replayed
SERVE_BATCH = dict(prefill_32k=1, decode_32k=4, long_500k=1)
SERVE_STEPS = dict(decode_32k=16, long_500k=4)
# 13(b): decode_32k starts 16 rows before the cache's end; long_500k two
# rows before the edge of the first of its two 262,144-row blocks, so
# that the rank that writes moves to the second block
SERVE_START = dict(decode_32k=32_752, long_500k=262_142)
SERVE_FP32 = dict(rel=0.0, slack=1e-4)     # of each row's largest
SERVE_TIE = 1e-5                           # top-2 logit gap logged, not failed
SERVE_DIST_STEPS = 3                       # 13(a): decode steps a cell


def first_layers(tree: dict, n: int) -> dict:
    """A train tree cut to its first ``n`` layers (views)."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[:n]
    return dict(tree, layers=cut(tree["layers"]))


def widened(torch, tree):
    """The same weights in fp32 (the router and norms included)."""
    if isinstance(tree, dict):
        return {k: widened(torch, v) for k, v in tree.items()}
    return tree.float()


def logits_agree(torch, what: str, got, want, rule) -> tuple[float, list]:
    """Hold ``got`` (B, V) to ``want`` by ``rule`` (``rounding_agree``);
    with the fp32 rule also argmax equal, except where ``want``'s top two
    are within ``SERVE_TIE`` (logged). Returns (ratio, near ties)."""
    from repro_torch.testing import rounding_agree

    ok, ratio = rounding_agree(got, want, **rule)
    check(ok and bool(torch.isfinite(got).all()),
          f"{what}: {ratio:.3g} x the limit")
    ties = []
    if rule is SERVE_FP32:
        top = want.float().topk(2, -1).values
        gap = top[:, 0] - top[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        for r in (~same).nonzero()[:, 0].tolist():
            check(float(gap[r]) <= SERVE_TIE,
                  f"{what}: row {r}'s argmax differs (gap {float(gap[r])})")
        ties = [float(g) for g in gap[gap <= SERVE_TIE]]
    return ratio, ties


class ServeReplay:
    """The ranks of a (data, model) mesh serving Mistral-NeMo-12B,
    replayed one after another on one card, layer by layer, each
    collective done by hand in rank order: the params cut by
    ``models/tp.serving_blocks`` under ``lm_param_specs``, a decode
    cache cut by ``lm_batch_specs`` into each rank's contiguous block;
    each rank runs ``models/tp``'s bodies on its blocks: the embedding
    rows summed over "model", the projection columns gathered where its
    plan says so, attention on its heads (``flash_attention``) or its
    cache block (``flash_decode_block``, the partials concatenated over
    the ranks that split the sequence, in block order, and merged by
    ``merge_partials``), the row-parallel partials summed over "model",
    the logits' vocab blocks concatenated. ``count`` wraps the kernels'
    calls (the main path's launches)."""

    def __init__(self, torch, cfg, tree, shape: str, cache=None,
                 count=None):
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import MeshShape
        from repro_torch.launch.steps import build_cell
        from repro_torch.models import tp
        from repro_torch.models.transformer import layer_list

        self.torch, self.cfg, self.tp = torch, cfg, tp
        self.count = count or (lambda fn, *a, **k: fn(*a, **k))
        self.nd, self.nm = SERVE_MESH[shape]
        mesh = MeshShape(SERVE_MESH[shape], ("data", "model"))
        bundle = build_cell(NEMO, shape, device=tree["embed"].device,
                            model_cfg=cfg)
        bundle.mesh = mesh
        pspec, bspec = bundle.executed_specs()
        self.ranks = [{"data": d, "model": m} for d in range(self.nd)
                      for m in range(self.nm)]
        self.p = {m: tp.serving_blocks(tree, pspec, mesh, cfg.act,
                                       {"data": 0, "model": m})
                  for m in range(self.nm)}
        self.layers = {m: layer_list(self.p[m]["layers"])
                       for m in range(self.nm)}
        self.cache, self.seq_axes = {}, ()
        kv_loc = None
        if cache is not None:
            spec = bspec["cache_k"]
            self.seq_axes = shd._axes(spec[3])
            for c in self.ranks:
                self.cache[self.key(c)] = {
                    n: shd.distribute_tree(cache[n], spec, mesh, c,
                                           copy=True) for n in ("k", "v")}
            kv_loc = self.cache[self.key(self.ranks[0])]["k"].shape[2]
        self.plans = {m: tp.head_plan(cfg, self.layers[m][0]["attn"], m,
                                      self.nm, kv_loc,
                                      "model" in self.seq_axes)
                      for m in range(self.nm)}
        sizes = {"data": self.nd, "model": self.nm}
        self.n_blocks = 1
        for a in self.seq_axes:
            self.n_blocks *= sizes[a]
        self.spec = bspec

    @staticmethod
    def key(c) -> tuple:
        return c["data"], c["model"]

    def block(self, c) -> int:
        sizes = {"data": self.nd, "model": self.nm}
        out = 0
        for a in self.seq_axes:
            out = out * sizes[a] + c[a]
        return out

    def embed(self, tokens):
        x = None
        for m in range(self.nm):
            e = self.tp.embed_local(self.p[m]["embed"], tokens, m, self.nm,
                                    self.cfg.vocab)
            x = e if x is None else x + e
        return x

    def columns(self, i, h):
        """Each model rank's q, k, v columns of layer i, and all of them
        (the gather over "model", done once where a plan needs it)."""
        cols = [self.tp.qkv_local(self.layers[m][i]["attn"], h)
                for m in range(self.nm)]
        whole = [self.torch.cat([c[j] for c in cols], -1) for j in range(3)]
        return cols, whole

    def heads(self, m, cols, whole, positions):
        plan = self.plans[m]
        q = whole[0] if plan.gather_q else cols[m][0]
        k, v = (whole[1], whole[2]) if plan.gather_kv else cols[m][1:]
        return self.tp.attention_heads(q, k, v, plan, self.cfg, positions)

    def mlp_sum(self, i, x):
        from repro_torch.models.layers import rmsnorm

        h = rmsnorm(x, self.layers[0][i]["ln2"])
        out = None
        for m in range(self.nm):
            part = self.tp.mlp_local(self.layers[m][i]["mlp"], h,
                                     self.cfg.act)
            out = part if out is None else out + part
        return x + out

    def logits(self, x):
        from repro_torch.models.layers import rmsnorm

        hidden = rmsnorm(x, self.p[0]["final_ln"])
        return self.torch.cat([self.tp.logits_local(hidden,
                                                    self.p[m]["lm_head"])
                               for m in range(self.nm)], -1)[:, 0]

    def prefill(self, tokens):
        """The ranks' prefill of tokens (B, S): the logits (B, V)."""
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.models.layers import rmsnorm

        torch, cfg = self.torch, self.cfg
        b, s = tokens.shape
        x = self.embed(tokens)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :]
        for i in range(cfg.n_layers):
            h = rmsnorm(x, self.layers[0][i]["ln1"])
            cols, whole = self.columns(i, h)
            out = None
            for m in range(self.nm):
                q, k, v = self.heads(m, cols, whole, positions)
                o = self.count(flash_attention, q, k, v, causal=cfg.causal)
                o = o.transpose(1, 2).reshape(b, s, -1)
                part = self.tp.attn_out_local(o, self.layers[m][i]["attn"]
                                              ["wo"], self.plans[m],
                                              cfg.d_head)
                out = part if out is None else out + part
            x = self.mlp_sum(i, x + out)
        return self.logits(x[:, -1:])

    def decode(self, tokens, cache_len: int):
        """One decode step of every rank: tokens (B, 1) on each data rank
        (replicated, or their block), the new row written by the ranks
        whose block holds ``cache_len``. Returns each data rank's logits."""
        from repro_torch.kernels.flash_decode.ops import flash_decode_block
        from repro_torch.kernels.flash_decode.plain import merge_partials
        from repro_torch.models.layers import rmsnorm

        torch, cfg = self.torch, self.cfg
        b = tokens.shape[0]
        xs = {d: self.embed(tokens) for d in range(self.nd)}
        positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                               device=tokens.device)
        for i in range(cfg.n_layers):
            parts = {}
            for d in range(self.nd):
                h = rmsnorm(xs[d], self.layers[0][i]["ln1"])
                cols, whole = self.columns(i, h)
                for m in range(self.nm):
                    c = {"data": d, "model": m}
                    plan = self.plans[m]
                    q, k_new, v_new = self.heads(m, cols, whole, positions)
                    blk = self.block(c)
                    ck = self.cache[self.key(c)]["k"][i]
                    cv = self.cache[self.key(c)]["v"][i]
                    s_loc = ck.shape[2]
                    at = cache_len - blk * s_loc
                    if 0 <= at < s_loc:
                        ck[:, :, at:at + 1] = k_new
                        cv[:, :, at:at + 1] = v_new
                    r0, r1 = (x - plan.kv_heads[0] for x in plan.read_kv)
                    if (r0, r1) != (0, ck.shape[1]):
                        ck, cv = ck[:, r0:r1], cv[:, r0:r1]
                    parts[self.key(c)] = self.count(
                        flash_decode_block, q[:, :, 0], ck, cv,
                        cache_len + 1, blk, self.n_blocks)
            new, merges = {}, {}
            for d in range(self.nd):
                out = None
                for m in range(self.nm):
                    c = {"data": d, "model": m}
                    # the ranks that split the sequence with this one, in
                    # block order: the all-gather's; each merges alike
                    group = tuple(self.key(r) for r in sorted(
                        (r for r in self.ranks if all(
                            r[a] == c[a] for a in ("data", "model")
                            if a not in self.seq_axes)), key=self.block))
                    if group not in merges:
                        merges[group] = merge_partials(*(torch.cat(
                            [parts[r][j] for r in group], 2)
                            for j in range(3))).to(cfg.dtype)
                    merged = merges[group]
                    part = self.tp.attn_out_local(
                        merged.reshape(b, 1, -1),
                        self.layers[m][i]["attn"]["wo"], self.plans[m],
                        cfg.d_head)
                    out = part if out is None else out + part
                new[d] = self.mlp_sum(i, xs[d] + out)
            xs = new
        return [self.logits(xs[d]) for d in range(self.nd)]

    def time_rank(self, shape: str, cache_len: int, tokens):
        """CUDA-event ms of model rank 0's layer-0 body (data rank 0) on
        its blocks, of its attention kernel call alone, and of a merge."""
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.flash_decode.ops import flash_decode_block
        from repro_torch.kernels.flash_decode.plain import merge_partials
        from repro_torch.models.layers import rmsnorm

        torch, cfg = self.torch, self.cfg
        lay = self.layers[0][0]
        c = {"data": 0, "model": 0}
        b = tokens.shape[0]
        x = self.embed(tokens)
        if shape == "prefill_32k":
            s = tokens.shape[1]
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None, :]
        else:
            positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                                   device=x.device)
        plan = self.plans[0]
        h = rmsnorm(x, lay["ln1"])
        cols, whole = self.columns(0, h)
        q, k, v = self.heads(0, cols, whole, positions)
        if shape == "prefill_32k":
            def attn():
                return flash_attention(q, k, v, causal=cfg.causal)
            o = attn().transpose(1, 2).reshape(b, s, -1)
            merge_ms = None
        else:
            blk = self.block(c)
            ck = self.cache[self.key(c)]["k"][0]
            cv = self.cache[self.key(c)]["v"][0]

            def attn():
                return flash_decode_block(q[:, :, 0], ck, cv, cache_len + 1,
                                          blk, self.n_blocks)
            part = attn()
            # the merge at its size: the block's partials as every block's
            gathered = [torch.cat([part[j]] * self.n_blocks, 2)
                        for j in range(3)]
            merge_ms = cuda_ms(torch, lambda: merge_partials(*gathered),
                               20, 2)
            o = merge_partials(*gathered).to(cfg.dtype).reshape(b, 1, -1)

        def body():          # the rank's compute; a gather's result given
            cc = self.tp.qkv_local(lay["attn"], rmsnorm(x, lay["ln1"]))
            self.tp.attention_heads(whole[0] if plan.gather_q else cc[0],
                                    *(whole[1:] if plan.gather_kv
                                      else cc[1:]), plan, cfg, positions)
            attn()
            y = x + self.tp.attn_out_local(o, lay["attn"]["wo"], plan,
                                           cfg.d_head)
            return self.tp.mlp_local(lay["mlp"], rmsnorm(y, lay["ln2"]),
                                     cfg.act)

        iters = 3 if shape == "prefill_32k" else 20
        return dict(rank_layer_ms=cuda_ms(torch, body, iters, 1),
                    rank_attention_ms=cuda_ms(torch, attn, iters, 1),
                    merge_ms=merge_ms)


def serve_weights(torch, dev, n_layers: int) -> tuple:
    """Mistral-NeMo-12B at full width, ``n_layers`` layers, seeded bf16
    weights made on the card, as a train tree; and its config."""
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=n_layers)
    tree = train_tree(init_params(cfg, seed=SEED + 13, device=dev))
    torch.cuda.empty_cache()
    return cfg, tree


def noise_cache(torch, dev, cfg, b: int, s: int, seed: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.n_layers, b, cfg.n_kv, s, cfg.d_head)
    return {n: torch.randn(shape, generator=gen, device=dev,
                           dtype=cfg.dtype) for n in ("k", "v")}


def phase_serve_replay(torch, dev, shape: str, cfg, tree, count) -> dict:
    """13(b) for one cell: the mesh's ranks replayed (``ServeReplay``)
    against the unsharded ``prefill`` / ``decode_step`` on the same
    weights, in bf16 (``BF16_MOE``) and with the weights widened to fp32
    (``SERVE_FP32``, argmax equal); the bf16 replay twice, bit for bit;
    the ranks' times and the peak."""
    from repro_torch.models import transformer as tfm

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.testing import rounding_agree

    b, layers = SERVE_BATCH[shape], SERVE_LAYERS[shape]
    specs = get_arch(NEMO).input_specs(shape)
    seq = specs["tokens"].shape[1] if shape == "prefill_32k" else \
        specs["cache_k"].shape[3]
    cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    if shape == "prefill_32k":
        toks = [torch.randint(4, cfg.vocab, (b, seq), generator=gen,
                              device=dev, dtype=torch.int32)]
    else:
        toks = [torch.randint(4, cfg.vocab, (b, 1), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(SERVE_STEPS[shape])]
    out = {"mesh": "x".join(map(str, SERVE_MESH[shape])), "layers": layers,
           "batch": b, "seq": seq}
    for dtype, rule in ((torch.bfloat16, BF16_MOE),
                        (torch.float32, SERVE_FP32)):
        name = str(dtype).removeprefix("torch.")
        c = dataclasses.replace(cfg, dtype=dtype)
        t = first_layers(tree, layers)
        if dtype == torch.float32:
            t = widened(torch, t)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = None
        if shape != "prefill_32k":
            cache = noise_cache(torch, dev, c, b, seq, SEED + 19)
        rep = ServeReplay(torch, c, t, shape, cache, count
                          if dtype == torch.bfloat16 else None)
        rec = {"plan_model_rank_0": str(rep.plans[0])}
        with torch.no_grad():
            if shape == "prefill_32k":
                want, _, _ = tfm.prefill(t, toks[0], c, cache_size=seq)
                got = rep.prefill(toks[0])
                ratio, ties = logits_agree(torch, f"13(b) {shape} {name}",
                                           got, want, rule)
                rec.update(ratio=ratio, near_ties=ties)
                if dtype == torch.bfloat16:
                    rep.count = lambda fn, *a, **k: fn(*a, **k)
                    check(torch.equal(rep.prefill(toks[0]), got),
                          f"13(b) {shape}: two replays differ")
                timing = rep.time_rank(shape, 0, toks[0])
            else:
                start = SERVE_START[shape]
                ref = cache         # the replay's blocks are copies of it
                ratios, ties = [], []
                for step, tok in enumerate(toks):
                    n = start + step
                    want, _, _ = tfm.decode_step(t, tok, ref, n, c)
                    got = rep.decode(tok, n)
                    for d, g in enumerate(got[1:], 1):
                        check(torch.equal(g, got[0]),
                              f"13(b) {shape}: data rank {d} differs")
                    r, tie = logits_agree(torch, f"13(b) {shape} {name} "
                                          f"step {step}", got[0], want, rule)
                    ratios.append(r)
                    ties += tie
                    if step == 0 and dtype == torch.bfloat16:
                        count_fn, rep.count = rep.count, \
                            (lambda fn, *a, **k: fn(*a, **k))
                        # the replay again at the same cache_len: the row
                        # it writes is the one it wrote
                        check(torch.equal(rep.decode(tok, n)[0], got[0]),
                              f"13(b) {shape}: two replays differ")
                        rep.count = count_fn
                # every rank's final block against the unsharded cache:
                # the rows no step wrote bit for bit, the written rows by
                # the rule (the hidden states' partial sums round apart)
                mesh = MeshShape(SERVE_MESH[shape], ("data", "model"))
                for cd in rep.ranks:
                    lo = rep.block(cd) * rep.cache[rep.key(cd)]["k"].shape[3]
                    for nm in ("k", "v"):
                        got = rep.cache[rep.key(cd)][nm]
                        blk = distribute_tree(ref[nm], rep.spec["cache_k"],
                                              mesh, cd)
                        rows = torch.arange(got.shape[3], device=dev) + lo
                        new = (rows >= start) & (rows < start + len(toks))
                        check(torch.equal(got[:, :, :, ~new],
                                          blk[:, :, :, ~new]),
                              f"13(b) {shape} {name}: rank {cd}'s {nm} "
                              f"block changed outside the written rows")
                        ok, r = rounding_agree(got[:, :, :, new],
                                               blk[:, :, :, new], **rule)
                        check(ok, f"13(b) {shape} {name}: rank {cd}'s "
                                  f"written {nm} rows {r:.3g} x the limit")
                rec.update(ratio=max(ratios), ratios=ratios, near_ties=ties,
                           steps=len(toks), start=start)
                rep.count = lambda fn, *a, **k: fn(*a, **k)
                timing = rep.time_rank(shape, start + len(toks) - 1,
                                       toks[-1])
                del ref
        torch.cuda.synchronize()
        rec.update(timing, peak_gb=peak_gb(torch))
        out[name] = rec
        log(f"  13(b) {shape} as the {len(rep.ranks)} ranks of "
            f"{out['mesh']}, {name}, {layers} layers, batch {b}: logits "
            f"{rec['ratio']:.3g} x the limit against the unsharded run"
            + (" (two replays bit for bit)" if dtype == torch.bfloat16
               else f", argmax equal, {len(rec['near_ties'])} near ties")
            + f"; a rank's layer {rec['rank_layer_ms']:.4f} ms, its "
            f"attention kernel {rec['rank_attention_ms']:.4f} ms"
            + ("" if rec["merge_ms"] is None else
               f", the merge {rec['merge_ms']:.4f} ms")
            + f"; peak {rec['peak_gb']:.2f} GB")
        del rep, cache, t
        torch.cuda.empty_cache()
    return out


def long_bound(cfg) -> dict:
    """By arithmetic, not measured: a rank's bytes of long_500k at all
    40 layers on 2 x 2 (its 4 kv heads of half the 524,288 rows; its
    blocks of the weights: wq, wk, wv, win by columns, wo, wout by rows,
    the embedding and head by vocab) and one token's least time, those
    bytes at the data sheet's 3.35 TB/s."""
    d, dh, f = cfg.d_model, cfg.d_head, cfg.d_ff
    nd, nm = SERVE_MESH["long_500k"]
    seq = 524_288
    cache = cfg.n_layers * (cfg.n_kv // nm) * (seq // nd) * dh * 2 * 2
    layer = (d * dh * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * dh * d
             + 3 * d * f) // nm * 2 + 2 * d * 2
    weights = cfg.n_layers * layer + 2 * cfg.vocab * d * 2 // nm + d * 2
    return dict(cache_gb=cache / 1e9, weights_gb=weights / 1e9,
                rank_gb=(cache + weights) / 1e9,
                token_bound_ms=(cache + weights) / HBM_BYTES_PER_S * 1e3,
                by="arithmetic, not measured")


def serve_dist_rank(torch, rank: int, world: int, store: str,
                    dev_type: str = "cuda", count=None) -> dict:
    """13(a) on one rank of a NCCL process group of ``world`` ranks:
    Mistral-NeMo-12B at full width, 2 layers, prefill_32k (1 x 32,768),
    decode_32k (4 x 32,768, ``SERVE_DIST_STEPS`` steps from the cache's
    end) and long_500k (1 x 524,288, steps across the first block's
    edge) through ``build_cell(..., mesh=make_host_mesh(1, world))``
    against the no-mesh cells on the same weights and caches of seeded
    noise: bit for bit at world 1, by ``BF16_MOE`` beyond. ``count`` (a
    ``PathCounts``) wraps the mesh cells' calls."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.testing import rounding_agree

    count = count or (lambda fn, *a, **k: fn(*a, **k))
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {"world": world}
    try:
        mesh = make_host_mesh(1, world, device_type=dev_type)
        cfg, tree = serve_weights(torch, dev, 2)
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            one = build_cell(NEMO, shape, device=dev, model_cfg=cfg)
            sh = build_cell(NEMO, shape, device=dev, model_cfg=cfg,
                            mesh=mesh)
            local, _ = shard_args(sh, (tree, {}))
            bspec = sh.executed_specs()[1]
            specs = one.arg_specs[1]
            if shape == "prefill_32k":
                toks = torch.randint(4, cfg.vocab,
                                     (1, specs["tokens"].shape[1]),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
                with torch.no_grad():
                    want = one.fn(tree, {"tokens": toks})[0]
                    got = count(sh.fn, local, {"tokens": toks})[0]
                outs = [(want, got)]
            else:
                b = 4 if shape == "decode_32k" else 1
                s = specs["cache_k"].shape[3]
                cache = noise_cache(torch, dev, cfg, b, s, SEED + 29)
                blocks = {n: shd.distribute_tree(
                    cache[n], bspec[f"cache_{n}"], mesh, copy=True)
                    for n in ("k", "v")}
                start = s - SERVE_DIST_STEPS if shape == "decode_32k" else \
                    s // 2 - 1
                outs = []
                with torch.no_grad():
                    for step in range(SERVE_DIST_STEPS):
                        toks = torch.randint(4, cfg.vocab, (b, 1),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
                        n = torch.tensor(start + step, dtype=torch.int32)
                        want = one.fn(tree, {"tokens": toks,
                                             "cache_k": cache["k"],
                                             "cache_v": cache["v"],
                                             "cache_len": n})[0]
                        t_loc = shd.distribute_tree(toks, bspec["tokens"],
                                                    mesh)
                        got = count(sh.fn, local, {
                            "tokens": t_loc, "cache_k": blocks["k"],
                            "cache_v": blocks["v"], "cache_len": n})[0]
                        outs.append((shd.distribute_tree(
                            want, shd.P(bspec["tokens"][0], None), mesh),
                            got))
                del cache, blocks
            worst = 0.0
            for want, got in outs:
                if world == 1:
                    check(torch.equal(want, got),
                          f"13(a) {shape}: the mesh's logits differ from "
                          f"the no-mesh cell's")
                else:
                    ok, ratio = rounding_agree(got, want, **BF16_MOE)
                    check(ok, f"13(a) {shape}: {ratio:.3g} x BF16_MOE")
                    worst = max(worst, ratio)
            out[shape] = dict(seq_axes=list(sh.model_cfg.tp_seq_axes),
                              worst=worst)
            del local
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_serve_dist(torch, work: str, dev_type: str, count) -> dict:
    """13(a) at world ``torch.cuda.device_count()``: in this process on
    one card; with more, one ``--serve-rank`` process a card."""
    world = torch.cuda.device_count()
    store = str(Path(work) / "nccl-serve-store")
    if world == 1:
        return serve_dist_rank(torch, 0, 1, store, dev_type, count)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--serve-rank",
         str(r), "--dist-world", str(world), "--dist-store", store])
        for r in range(1, world)]
    try:
        out = serve_dist_rank(torch, 0, world, store, dev_type, count)
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"13(a): a rank exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def phase_serving_mesh(torch, dev) -> dict:
    """Phase 13. Returns the launches of the two attention kernels on its
    sharded paths (13(a)'s mesh cells, 13(b)'s bf16 replays; each call's
    count read from just before it to just after), not those of the runs
    they are held to."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd

    t0 = time.perf_counter()
    count = PathCounts({"flash_attention": (fa, "launches"),
                        "flash_decode": (fd, "launches")})
    with tempfile.TemporaryDirectory(prefix="chip_smoke-serve-") as work:
        a = phase_serve_dist(torch, work, dev.type, count)
    log(f"  13(a) NCCL world {a['world']}: Mistral-NeMo-12B at full width, "
        f"2 layers, prefill_32k (1 x 32768), decode_32k and long_500k "
        f"({SERVE_DIST_STEPS} steps each) through build_cell(mesh=) "
        + ("bit for bit with the no-mesh cells" if a["world"] == 1 else
           "within BF16_MOE of the no-mesh cells")
        + f"; the caches' sequence axes: "
        f"{ {s: a[s]['seq_axes'] for s in SERVE_LAYERS} }")
    after_a = dict(count.n)
    cfg, tree = serve_weights(torch, dev, max(SERVE_LAYERS.values()))
    b = {}
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        before = dict(count.n)
        b[shape] = phase_serve_replay(torch, dev, shape, cfg, tree, count)
        b[shape]["launches"] = {k: count.n[k] - before[k] for k in before}
    del tree
    torch.cuda.empty_cache()
    bound = long_bound(dataclasses.replace(cfg, n_layers=40))
    log(f"  13(c) long_500k at all 40 layers on 2 x 2, by arithmetic (not "
        f"measured): a rank holds {bound['cache_gb']:.2f} GB of cache and "
        f"{bound['weights_gb']:.2f} GB of weights, {bound['rank_gb']:.2f} "
        f"GB; a token's bound {bound['token_bound_ms']:.2f} ms at 3.35 TB/s")
    log(json.dumps({"phase13": dict(
        collective=a, replays=b, long_500k_40_layers=bound,
        launches_13a=after_a,
        reduced=[f"13(a): 40 -> 2 layers; prefill_32k batch 32 -> 1, "
                 f"decode_32k batch 128 -> 4, {SERVE_DIST_STEPS} decode "
                 f"steps", "13(b): prefill_32k 40 -> 2 layers, batch 1 of "
                 "32; decode_32k 40 -> 2 layers, batch 4 of 128; "
                 "long_500k 40 -> 4 layers (the full 524,288-entry "
                 "cache)", "13(b): the ranks run one after another on one "
                 "card: no interconnect is measured"])}))
    log(f"  launches on phase 13's paths: {count.n}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name, n in count.n.items():
        check(n > 0, f"{name} was never launched on phase 13's paths")
    return count.n


SERVE_LONG_STEPS = 8        # 13(d): decode steps timed


def serve_long_rank(torch, rank: int, world: int, store: str) -> dict:
    """13(d), outside the default run (``--serve-long``, on a machine
    with 4 cards): long_500k at all 40 layers of Mistral-NeMo-12B on a
    2 x 2 mesh, one NCCL process a card, through ``build_cell(...,
    mesh=make_host_mesh(2, 2))``: each rank makes the seeded weights
    whole on its card and keeps its blocks (``shard_args``), and a block
    of seeded noise as its cache (4 kv heads of 262,144 rows, 21.47 GB);
    ``SERVE_LONG_STEPS`` decode steps from cache_len 262,142 (the
    writing rank moves to the second data block), each timed on the host
    clock between synchronizes, then one more under ``torch.profiler``
    (every rank runs it; rank 0 reads the device's busy time, the
    collectives of the step and its busiest kernels). The logits must be
    finite and equal on every rank. Returns ms a token, tokens/s, the
    rank's peak GB and the profile."""
    import torch.distributed as dist
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.launch import collectives as col
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, 2)
        cell = build_cell(NEMO, "long_500k", device=dev, mesh=mesh)
        tree = train_tree(init_params(CONFIG, seed=SEED + 13, device=dev))
        torch.cuda.empty_cache()
        local, _ = shard_args(cell, (tree, {}))
        del tree
        torch.cuda.empty_cache()
        spec = cell.executed_specs()[1]["cache_k"]
        shape = shd.local_shape(tuple(cell.arg_specs[1]["cache_k"].shape),
                                spec, mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED + 31 + rank)
        ck, cv = (torch.randn(shape, generator=gen, device=dev,
                              dtype=CONFIG.dtype) for _ in range(2))
        toks = torch.randint(4, CONFIG.vocab, (SERVE_LONG_STEPS + 1, 1, 1),
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED + 37), device=dev,
                             dtype=torch.int32)
        torch.cuda.reset_peak_memory_stats()
        times, start = [], SERVE_START["long_500k"]

        def step(i):
            return cell.fn(local, {
                "tokens": toks[i], "cache_k": ck, "cache_v": cv,
                "cache_len": torch.tensor(start + i, dtype=torch.int32)})

        with torch.no_grad():
            for i in range(SERVE_LONG_STEPS):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = step(i)[0]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                check(bool(torch.isfinite(logits.float()).all()),
                      f"13(d) step {i}: logits not finite")
                first = logits.clone()
                dist.broadcast(first, 0)
                check(torch.equal(first, logits),
                      f"13(d) step {i}: rank {rank}'s logits differ "
                      f"from rank 0's")
            peak = peak_gb(torch)
            dist.barrier()
            col.take_records()
            _, wall, kern = profiled(torch, lambda: step(SERVE_LONG_STEPS))
            stats = col.collective_stats(col.take_records())
        warm = sorted(times[1:])
        out = dict(rank=rank, cache_block=list(shape),
                   step_ms=times, median_ms=warm[len(warm) // 2],
                   tokens_per_s=1e3 / warm[len(warm) // 2], peak_gb=peak,
                   profiled_step_ms=wall * 1e3,
                   collectives={op: stats[op]["count"] for op in
                                ("all-gather", "all-reduce")})
        if kern:
            # the kernels; "nccl:*" are the profiler's annotations of the
            # NCCL kernels, whose time also counts a wait for the peers
            kern = [e for e in kern if not e.key.startswith("nccl:")]
            kern.sort(key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            nccl = sum(e.self_device_time_total for e in kern
                       if e.key.startswith("ncclDevKernel")) / 1e3
            out.update(device_busy_ms=busy, nccl_kernels_ms=nccl,
                       other_kernels_ms=busy - nccl,
                       idle_share=1 - busy / (wall * 1e3),
                       kernels_run=sum(e.count for e in kern),
                       busiest=[(e.key[:60], e.self_device_time_total / 1e3,
                                 e.count) for e in kern[:6]])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_serve_long(torch, work: str) -> dict:
    """13(d) on 4 cards: this process is rank 0, one ``--serve-long-rank``
    process a further card."""
    world = torch.cuda.device_count()
    check(world == 4, f"13(d) needs 4 cards, the machine has {world}")
    store = str(Path(work) / "nccl-long-store")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--serve-long-rank", str(r), "--dist-world", str(world),
         "--dist-store", store]) for r in range(1, world)]
    try:
        out = serve_long_rank(torch, 0, world, store)
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"13(d): a rank exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


# ---------------------------------------------------------------------------
# phase 14: the LM and recsys train cells on a mesh (TP, ZeRO-1)
# ---------------------------------------------------------------------------
TRAIN_MESH_NEMO = dict(layers=2, batch=2, accum=2)  # 14(a): of 40, 256 rows
TRAIN_MESH_DLRM_BATCH = 4096    # 14(a): DLRM rows of train_batch's 65,536
TRAIN_REPLAY = (2, 2)           # 14(b): (data, model), processes on one card
TRAIN_REPLAY_BATCH = 2          # 14(b): sequences of 4096, one a data rank
TRAIN_LONG = dict(batch=16, accum=8, steps=3)   # 14(d): of 256 sequences
# 14(b): a norm gain's gradient is one sum over every token (2 x 4096
# here) of terms of either sign, each itself a sum over the hidden units
# or heads (K up to 14,336) that the mesh cuts over "model" and adds in
# another order: against DIST_FP32's 1e-5 of the leaf's largest, the
# gains read 1.00-1.02 x in the first chip runs. So each leaf's m is also
# allowed this many times its distance between two orders of the same
# no-mesh step (``flipped``: the heads and hidden units in reverse), where
# that is the larger
FLOOR_TIMES = 2.0


def mesh_step_leaves(torch, what: str, want, got, exact: bool,
                     floor: dict = None, plain: dict = None) -> float:
    """Each leaf of ``got`` (a rank's mesh step, 12(a) or 14: its param
    blocks, or its AdamW m at its ZeRO blocks; ``what`` names which)
    against ``want`` (the same blocks of the no-mesh step's, on the host
    or the card): bit for bit when ``exact``, else by ``DIST_FP32``
    (params within 1e-5 + 2 lr_t, m within 1e-5 of the leaf's largest),
    or within ``FLOOR_TIMES`` x ``floor[leaf]`` where that is larger
    (14(b): the distance between two orders of the same no-mesh sums,
    ``replay_reference``). Returns the largest ratio of an error to its
    limit; ``plain`` gets each leaf's ratio to ``DIST_FP32`` alone."""
    from repro_torch.train.tree import leaves

    lr_t = 1e-4 / 100                          # AdamW's warmup at step 0
    worst = 0.0
    for (name, a), (_, b) in zip(leaves(want), leaves(got)):
        b = b.detach()
        a = a.detach().to(b.device)
        if exact:
            check(torch.equal(a, b), f"{what}: {name} differs")
            continue
        a, b = a.float(), b.float()
        err = (a - b).abs()
        rule = DIST_FP32["param"] + 2 * lr_t if "param" in what \
            else DIST_FP32["grad"] * float(a.abs().max())
        lim = max(rule, FLOOR_TIMES * (floor or {}).get(name, 0.0))
        ratio = float(torch.where(err == 0, 0.0, err / lim).max())
        if plain is not None:
            plain[name] = float(err.max()) / rule
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"{what}: {name} at {ratio:.3g} x its limit")
    return worst


def rank_blocks(cell, tree, opt: bool = False):
    """The rank of ``cell.mesh``'s blocks of a whole tree (views): its
    param blocks (a gated leaf's as ``[gate_r | up_r]``), or with ``opt``
    their ZeRO-1 blocks (where its optimizer state lies)."""
    from repro_torch.launch.steps import zero_layout
    from repro_torch.models.tp import serving_blocks
    from repro_torch.train.tree import tree_map_with_path

    out = serving_blocks(tree, cell.executed_specs()[0], cell.mesh,
                         getattr(cell.model_cfg, "act", ""), copy=False)
    if not opt:
        return out
    lay = zero_layout(cell)
    return tree_map_with_path(lambda p, t: lay.leaf(p).zero_block(t), out)


def flipped(tree, cfg) -> dict:
    """A transformer train tree (params, or a state of their shape) with
    its heads and hidden units in reverse order: the q heads, the kv
    heads (q head h reads kv head h // G, so reversing both keeps the
    groups), ``wo``'s rows with them, the MLP's hidden units (``win``'s
    gate and up halves each, ``wout``'s rows). The same function, its
    sums over heads and units in another order; applied twice, the tree
    itself."""
    out = dict(tree, layers=dict(tree["layers"]))
    attn = dict(tree["layers"]["attn"])
    mlp = dict(tree["layers"]["mlp"])
    dh = cfg.d_head

    def heads(t, dim):                    # reverse blocks of dh along dim
        n = t.shape[dim] // dh
        shape = t.shape[:dim] + (n, dh) + t.shape[dim + 1:]
        return t.reshape(shape).flip(dim).reshape(t.shape)

    for k in ("wq", "wk", "wv"):
        attn[k] = heads(attn[k], 2)
    attn["wo"] = heads(attn["wo"], 1)
    f = mlp["wout"].shape[1]
    mlp["win"] = _flip_halves(mlp["win"], f)
    mlp["wout"] = mlp["wout"].flip(1)
    out["layers"]["attn"], out["layers"]["mlp"] = attn, mlp
    return out


def _flip_halves(win, f: int):
    """``win`` (L, D, 2F) with its gate and up halves each reversed."""
    import torch
    return torch.cat([win[..., :f].flip(-1), win[..., f:].flip(-1)], -1)


def _host(tree):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def mesh_nemo(torch, dev, mesh, world: int, count) -> dict:
    """14(a) Mistral-NeMo-12B: train_4k at full width, ``TRAIN_MESH_NEMO``'s
    cut, through ``build_cell(..., mesh=)`` (the tensor-parallel bodies,
    the loss, ZeRO-1) against the no-mesh step on the same card."""
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.launch import collectives as col
    from repro_torch.launch.steps import build_cell, shard_args, smoke_batch
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(CONFIG, n_layers=TRAIN_MESH_NEMO["layers"])
    if world > 1:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    acc = TRAIN_MESH_NEMO["accum"]
    one = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg, accum=acc)
    cell = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg,
                      accum=acc, mesh=mesh)
    check(cell.model_cfg.tp_mesh is mesh, "14(a): Mistral-NeMo did not take "
                                          "the tensor-parallel path")
    tree = train_tree(init_params(cfg, seed=SEED + 51, device=dev))
    batch = {k: v[:TRAIN_MESH_NEMO["batch"]]
             for k, v in smoke_batch(one, SEED + 51).items()}
    step0 = torch.tensor(0, dtype=torch.int32, device=dev)
    args = shard_args(cell, (tree, None, batch, step0))
    torch.cuda.reset_peak_memory_stats()
    col.take_records()
    torch.cuda.synchronize()
    t = time.perf_counter()
    p2, o2, l2 = count(cell.fn, *args)
    torch.cuda.synchronize()
    out = dict(step_ms=(time.perf_counter() - t) * 1e3, loss=float(l2),
               collectives=col.collective_stats(col.take_records()),
               peak_gb=peak_gb(torch))
    m2 = o2["m"]
    del o2, args
    torch.cuda.empty_cache()
    p1, o1, l1 = one.fn(tree, one.opt.init(tree), batch, step0)
    m1 = o1["m"]
    del o1
    exact = world == 1
    out["worst"] = {
        "param": mesh_step_leaves(torch, "14(a) Mistral-NeMo param",
                                  rank_blocks(cell, p1), p2, exact),
        "m": mesh_step_leaves(torch, "14(a) Mistral-NeMo m",
                              rank_blocks(cell, m1, opt=True), m2, exact)}
    if exact:
        check(torch.equal(l1, l2), f"14(a) Mistral-NeMo: loss {float(l2)} "
                                   f"on the mesh, {float(l1)} without")
    else:
        rel = abs(float(l1) - float(l2)) / abs(float(l1))
        out["worst"]["loss"] = rel / DIST_FP32["loss"]
        check(rel <= DIST_FP32["loss"], f"14(a) Mistral-NeMo: loss "
                                        f"{float(l2)} vs {float(l1)}")
    del p1, p2, m1, m2, tree
    torch.cuda.empty_cache()
    return out


def mesh_dlrm(torch, dev, mesh, world: int, count) -> dict:
    """14(a) DLRM: train_batch at MLPerf widths over phase 10's tables
    (capped at 4M rows), ``TRAIN_MESH_DLRM_BATCH`` samples, through
    ``build_cell(..., mesh=)`` (row-sharded tables, column-parallel
    MLPs, ZeRO-1) against the no-mesh step on the same card; the no-mesh
    step's params and m wait on the host (two copies of 11.5 GB of
    tables and their state would not fit beside the second step)."""
    from repro_torch.launch import collectives as col
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models import recsys as rm
    from repro_torch.models.bridge import train_tree

    cfg = dlrm_train_config()
    one = build_cell("dlrm-mlperf", "train_batch", device=dev, model_cfg=cfg)
    cell = build_cell("dlrm-mlperf", "train_batch", device=dev,
                      model_cfg=cfg, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    b = TRAIN_MESH_DLRM_BATCH
    batch = {"dense": torch.rand((b, cfg.n_dense), generator=gen,
                                 device=dev),
             "sparse_ids": torch.stack([torch.randint(
                 0, v, (b, 1), generator=gen, device=dev,
                 dtype=torch.int32) for v in cfg.table_sizes], 1),
             "labels": torch.randint(0, 2, (b,), generator=gen,
                                     device=dev).float()}
    step0 = torch.tensor(0, dtype=torch.int32, device=dev)
    tree = train_tree(rm.dlrm_init(cfg, seed=SEED + 53, device=dev))
    p1, o1, l1 = one.fn(tree, one.opt.init(tree), batch, step0)
    want_p, want_m = _host(p1), _host(o1["m"])
    del tree, p1, o1
    torch.cuda.empty_cache()
    tree = train_tree(rm.dlrm_init(cfg, seed=SEED + 53, device=dev))
    args = shard_args(cell, (tree, None, batch, step0))
    del tree
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    col.take_records()
    torch.cuda.synchronize()
    t = time.perf_counter()
    p2, o2, l2 = count(cell.fn, *args)
    torch.cuda.synchronize()
    out = dict(step_ms=(time.perf_counter() - t) * 1e3, loss=float(l2),
               collectives=col.collective_stats(col.take_records()),
               peak_gb=peak_gb(torch))
    exact = world == 1
    out["worst"] = {                 # a leaf at a time to the card
        "param": mesh_step_leaves(torch, "14(a) DLRM param",
                                  rank_blocks(cell, want_p), p2, exact),
        "m": mesh_step_leaves(torch, "14(a) DLRM m",
                              rank_blocks(cell, want_m, opt=True),
                              o2["m"], exact)}
    check(torch.equal(l1, l2) if exact else
          abs(float(l1) - float(l2)) <= DIST_FP32["loss"] * abs(float(l1)),
          f"14(a) DLRM: loss {float(l2)} on the mesh, {float(l1)} without")
    del p2, o2, args, want_p, want_m
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(torch, rank: int, world: int, store: str,
                    dev_type: str = "cuda", count=None) -> dict:
    """14(a) on one rank of a NCCL process group of ``world`` ranks, one a
    card, met through a ``FileStore`` at ``store``: ``mesh_nemo`` and
    ``mesh_dlrm`` on ``make_host_mesh(1, world)``, bf16 and bit for bit
    at world 1 (every collective a copy, the loss the one-card loss, no
    ZeRO split), fp32 by ``DIST_FP32`` beyond. ``count`` (a
    ``PathCounts``) wraps the mesh steps."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    count = count or (lambda fn, *a, **k: fn(*a, **k))
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(1, world, device_type=dev_type)
        out = {"world": world, "nemo": mesh_nemo(torch, dev, mesh, world,
                                                 count)}
        out["dlrm"] = mesh_dlrm(torch, dev, mesh, world, count)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_train_mesh_collective(torch, work: str, dev_type: str,
                                count) -> dict:
    """14(a) at world ``torch.cuda.device_count()``: in this process on
    one card; with more, one ``--train-rank`` process a card."""
    world = torch.cuda.device_count()
    store = str(Path(work) / "nccl-train-store")
    if world == 1:
        return train_mesh_rank(torch, 0, 1, store, dev_type, count)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train-rank",
         str(r), "--dist-world", str(world), "--dist-store", store])
        for r in range(1, world)]
    try:
        out = train_mesh_rank(torch, 0, world, store, dev_type, count)
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"14(a): a rank exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def replay_config(torch):
    """14(b)'s Mistral-NeMo-12B: full width, 2 layers, fp32."""
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    return dataclasses.replace(CONFIG, n_layers=TRAIN_MESH_NEMO["layers"],
                               dtype=torch.float32)


def replay_reference(torch, dev, ref: str) -> dict:
    """14(b)'s no-mesh step on the card (fp32, ``TRAIN_REPLAY_BATCH``
    sequences of 4096, one microbatch), saved to ``ref`` for the ranks:
    its loss, params and AdamW m; and each m leaf's largest distance
    from the same step on ``flipped`` params, flipped back (the same
    function, its sums over heads and hidden units in another order: the
    floor of ``FLOOR_TIMES``)."""
    from repro_torch.launch.steps import build_cell, smoke_batch
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params
    from repro_torch.train.tree import leaves

    cfg = replay_config(torch)
    one = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg, accum=1)
    tree = train_tree(init_params(cfg, seed=SEED + 55, device=dev))
    batch = {k: v[:TRAIN_REPLAY_BATCH]
             for k, v in smoke_batch(one, SEED + 55).items()}
    step0 = torch.tensor(0, dtype=torch.int32, device=dev)
    t = time.perf_counter()
    p, o, loss = one.fn(tree, one.opt.init(tree), batch, step0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    want = {"loss": loss.cpu(), "param": _host(p), "m": _host(o["m"]),
            "batch": _host(batch)}
    del tree, p, o
    torch.cuda.empty_cache()
    tree = flipped(train_tree(init_params(cfg, seed=SEED + 55,
                                          device=dev)), cfg)
    o, flip_loss = one.fn(tree, one.opt.init(tree), batch, step0)[1:]
    check(abs(float(flip_loss) - float(loss)) <= DIST_FP32["loss"] * abs(
        float(loss)), f"14(b): the flipped step's loss {float(flip_loss)} "
                      f"is not the step's {float(loss)}")
    ref_m = dict(leaves(want["m"]))
    floor = {name: float((ref_m[name].to(dev) - t).abs().max())
             for name, t in leaves(flipped(o["m"], cfg))}
    del tree, o
    torch.cuda.empty_cache()
    torch.save(dict(want, floor=floor), ref)
    return dict(step_ms=ms, loss=float(loss), floor=floor)


def train_replay_rank(torch, rank: int, world: int, store: str,
                      ref: str, dev_type: str = "cuda",
                      ckpt: str = None) -> dict:
    """14(b) on one of ``world`` processes that share the one card, a
    gloo process group (NCCL takes one rank a card) on a
    ``TRAIN_REPLAY`` mesh: Mistral-NeMo's fp32 step at full width
    through ``build_cell(..., mesh=)`` (the ranks make the seeded weights
    one at a time and keep their blocks), held to ``replay_reference``'s
    step by ``DIST_FP32``; then, given ``ckpt``, 15(c)'s part
    (``ckpt_save_rank``). Returns the rank's loss, step ms, peak, worst
    ratios and collective tally."""
    import torch.distributed as dist
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*TRAIN_REPLAY, device_type=dev_type)
        cfg = replay_config(torch)
        cell = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg,
                          accum=1, mesh=mesh)
        want = torch.load(ref, mmap=True)
        batch = {k: v.to(dev) for k, v in want["batch"].items()}
        step0 = torch.tensor(0, dtype=torch.int32, device=dev)
        args = None
        for r in range(world):              # one whole tree at a time
            if r == rank:
                tree = train_tree(init_params(cfg, seed=SEED + 55,
                                              device=dev))
                args = shard_args(cell, (tree, None, batch, step0))
                del tree
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        col.take_records()
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, loss = cell.fn(*args)
        torch.cuda.synchronize()
        out = dict(rank=rank, step_ms=(time.perf_counter() - t) * 1e3,
                   loss=float(loss), peak_gb=peak_gb(torch),
                   collectives=col.collective_stats(col.take_records()))
        rel = abs(float(loss) - float(want["loss"])) / abs(
            float(want["loss"]))
        check(rel <= DIST_FP32["loss"], f"14(b) rank {rank}: loss "
                                        f"{float(loss)} vs "
                                        f"{float(want['loss'])}")
        plain = {}
        out["worst"] = {
            "loss": rel / DIST_FP32["loss"],
            "param": mesh_step_leaves(torch, f"14(b) rank {rank} param",
                                      rank_blocks(cell, want["param"]), p,
                                      False),
            "m": mesh_step_leaves(torch, f"14(b) rank {rank} m",
                                  rank_blocks(cell, want["m"], opt=True),
                                  o["m"], False, want["floor"], plain)}
        out["m_vs_dist_fp32"] = plain
        if ckpt:
            out["checkpoint"] = ckpt_save_rank(
                torch, rank, cell, mesh, {"params": p, "opt_state": o},
                batch, ckpt)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_train_replay(torch, dev, work: str, ckpt: str) -> dict:
    """14(b): the reference step here, then ``TRAIN_REPLAY``'s ranks as
    ``--train-replay-rank`` processes on this card (killed after
    ``DIST_TIMEOUT`` s), each printing its result as one JSON line; with
    15(c): the ranks save their state to ``ckpt`` and take step 2 before
    exiting (``ckpt_save_rank``), then this process restores it on one
    card and holds its step 2 to theirs (``ckpt_one_card``)."""
    ref = str(Path(work) / "train-replay-ref.pt")
    out = {"reference": replay_reference(torch, dev, ref)}
    world = TRAIN_REPLAY[0] * TRAIN_REPLAY[1]
    store = str(Path(work) / "gloo-train-store")
    # the 4 ranks' steps fill the card: segments that grow in place keep
    # their cached blocks from fragmenting it
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--train-replay-rank", str(r), "--dist-world", str(world),
         "--dist-store", store, "--replay-ref", ref, "--replay-ckpt", ckpt],
        stdout=subprocess.PIPE, text=True, env=env) for r in range(world)]
    ranks = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"14(b): a rank exited {p.returncode}")
            ranks.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["ranks"] = ranks
    out["checkpoint"] = ckpt_one_card(torch, dev, ckpt,
                                      torch.load(ref, mmap=True))
    return out


def phase_train_mesh(torch, dev, ckpt: str) -> tuple[dict, dict]:
    """Phase 14, with 15(c)'s checkpoint of 14(b)'s state written to
    ``ckpt``. Returns the launches of the forward and backward kernels
    on its mesh steps (14(a): each mesh step's counts read from just
    before it to just after), not those of the runs they are held to,
    and 14(b)'s results (15(c)'s among them)."""
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa

    t0 = time.perf_counter()
    count = PathCounts({"flash_attention": (fa, "launches"),
                        "flash_attention_bwd": (fa, "bwd_launches"),
                        "embedding_bag": (eb, "launches"),
                        "embedding_bag_bwd": (eb, "bwd_launches")})
    with tempfile.TemporaryDirectory(prefix="chip_smoke-train-") as work:
        a = phase_train_mesh_collective(torch, work, dev.type, count)
        held = "bf16, bit for bit (loss, params, AdamW m)" \
            if a["world"] == 1 else \
            f"fp32 by DIST_FP32 {json.dumps(a['nemo']['worst'])}"
        log(f"  14(a) NCCL world {a['world']}: Mistral-NeMo-12B train_4k at "
            f"full width ({TRAIN_MESH_NEMO['layers']} layers, "
            f"{TRAIN_MESH_NEMO['batch']} x 4096 in "
            f"{TRAIN_MESH_NEMO['accum']} microbatches, "
            f"{a['nemo']['step_ms']:.1f} ms, peak "
            f"{a['nemo']['peak_gb']:.2f} GB) and DLRM train_batch "
            f"({TRAIN_MESH_DLRM_BATCH} samples, tables capped at "
            f"{TRAIN_DLRM_ROWS} rows, {a['dlrm']['step_ms']:.1f} ms, peak "
            f"{a['dlrm']['peak_gb']:.2f} GB) through build_cell(mesh=) "
            f"equal to the no-mesh steps: {held}")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        b = phase_train_replay(torch, dev, work, ckpt)
        b["seconds"] = time.perf_counter() - t
    worst = {k: max(r["worst"][k] for r in b["ranks"])
             for k in ("loss", "param", "m")}
    over = {}                # m leaves past DIST_FP32 alone, and by how far
    for r in b["ranks"]:
        for name, x in r["m_vs_dist_fp32"].items():
            if x > 1.0:
                over[name] = max(over.get(name, 0.0), x)
    log(f"  14(b) {TRAIN_REPLAY[0]} x {TRAIN_REPLAY[1]} (gloo, "
        f"{len(b['ranks'])} processes on the card): Mistral-NeMo-12B fp32 "
        f"at full width, {TRAIN_MESH_NEMO['layers']} layers, "
        f"{TRAIN_REPLAY_BATCH} x 4096, against the no-mesh step "
        f"({b['reference']['step_ms']:.1f} ms) by DIST_FP32 or "
        f"{FLOOR_TIMES} x the no-mesh step's own order floor: worst "
        f"{json.dumps(worst)}; m leaves past DIST_FP32 alone: "
        f"{json.dumps(over)}; rank steps "
        f"{[round(r['step_ms'], 1) for r in b['ranks']]} ms, peaks "
        f"{[round(r['peak_gb'], 2) for r in b['ranks']]} GB "
        f"({b['seconds']:.1f} s, 15(c)'s checkpoint work included)")
    log(json.dumps({"phase14": dict(
        collective=a, replay=b, launches_14a=count.n,
        reduced=[f"14(a): Mistral-NeMo train_4k 40 -> "
                 f"{TRAIN_MESH_NEMO['layers']} layers; global batch 256 -> "
                 f"{TRAIN_MESH_NEMO['batch']} (accum "
                 f"{TRAIN_MESH_NEMO['accum']}: microbatch 1 x 4096)",
                 f"14(a): DLRM tables capped at {TRAIN_DLRM_ROWS} rows "
                 f"(as phase 10), batch 65,536 -> {TRAIN_MESH_DLRM_BATCH}",
                 f"14(b): Mistral-NeMo 40 -> {TRAIN_MESH_NEMO['layers']} "
                 f"layers, fp32, batch {TRAIN_REPLAY_BATCH} x 4096 in one "
                 f"microbatch; the ranks share one card over gloo: no "
                 f"interconnect is measured"])}))
    log(f"  launches on phase 14's mesh steps: {count.n}; phase 14 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name, n in count.n.items():
        check(n > 0, f"{name} was never launched on phase 14's mesh steps")
    return count.n, b


def train_long_rank(torch, rank: int, world: int, store: str,
                    dev_type: str = "cuda") -> dict:
    """14(d), outside the default run (``--train-mesh``, on a machine with
    4 cards): Mistral-NeMo-12B train_4k at all 40 layers on a 2 x 2 mesh,
    one NCCL process a card, bf16, AdamW with ZeRO-1, through
    ``build_cell(..., mesh=make_host_mesh(2, 2), accum=8)``: each rank
    makes the seeded weights whole on its card and keeps its blocks
    (``shard_args``: its optimizer state made at its ZeRO-1 blocks),
    ``TRAIN_LONG``'s batch (16 of 256 sequences: 8 a data rank in 8
    microbatches) and steps, each timed on the host clock between
    synchronizes, then one more under ``torch.profiler`` (rank 0 splits
    its device time into GEMMs, the attention kernels, NCCL and the
    rest). The loss must be finite and equal on the model ranks of each
    data group. Returns s a step, tokens/s, the peak, the collectives of
    a step and the profile."""
    import torch.distributed as dist
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import coordinate, make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args, smoke_batch
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, 2, device_type=dev_type)
        cell = build_cell(NEMO, "train_4k", device=dev, mesh=mesh,
                          accum=TRAIN_LONG["accum"])
        check(cell.optimizer == "adamw" and cell.model_cfg.remat,
              f"14(d): {cell.optimizer}, remat {cell.model_cfg.remat}")
        batch = {k: v[:TRAIN_LONG["batch"]]
                 for k, v in smoke_batch(cell, SEED + 57).items()}
        tree = train_tree(init_params(CONFIG, seed=SEED + 57, device=dev))
        torch.cuda.empty_cache()
        params, opt, local, _ = shard_args(cell, (tree, None, batch, None))
        del tree
        torch.cuda.empty_cache()
        held = dict(
            params_gb=sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 1e9,
            opt_gb=sum(t.numel() * t.element_size()
                       for t in _leaves(opt)) / 1e9)
        coord = coordinate(mesh)
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []

        def step(i):
            return cell.fn(params, opt, local, torch.tensor(
                i, dtype=torch.int32, device=dev))

        for i in range(TRAIN_LONG["steps"]):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == TRAIN_LONG["steps"] - 1:
                col.take_records()
            loss = step(i)[2]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
            check(math.isfinite(losses[-1]), f"14(d) step {i}: loss "
                                             f"{losses[-1]}")
            first = loss.clone()
            dist.broadcast(first, coord["data"] * 2,
                           group=mesh.get_group("model"))
            check(torch.equal(first, loss), f"14(d) step {i}: rank {rank}'s "
                                            f"loss differs from its data "
                                            f"group's")
        stats = col.collective_stats(col.take_records())
        peak = peak_gb(torch)
        dist.barrier()
        _, wall, kern = profiled(torch, lambda: step(TRAIN_LONG["steps"]))
        tokens = TRAIN_LONG["batch"] * 4096
        out = dict(rank=rank, coord=coord, step_s=times, losses=losses,
                   tokens_per_s=tokens / times[-1], peak_gb=peak,
                   profiled_step_s=wall, **held,
                   collectives={op: {k: stats[op][k] for k in
                                     ("count", "bytes", "wire_bytes")}
                                for op in ("all-gather", "all-reduce")})
        if kern:
            kern = [e for e in kern if not e.key.startswith("nccl:")]
            groups = {"gemm": 0.0, "flash_attention": 0.0,
                      "flash_attention_bwd": 0.0, "nccl": 0.0, "other": 0.0}
            for e in kern:
                k, ms = e.key, e.self_device_time_total / 1e3
                if "nccl" in k.lower():
                    groups["nccl"] += ms
                elif "bwd_tc::" in k or "bwd::" in k:  # csrc/flash_attention.cu
                    groups["flash_attention_bwd"] += ms
                elif "fa_wgmma_kernel" in k or "flash_attention_kernel" in k:
                    groups["flash_attention"] += ms
                elif any(s in k.lower() for s in ("gemm", "xmma", "nvjet",
                                                  "cutlass", "cublas")):
                    groups["gemm"] += ms
                else:
                    groups["other"] += ms
            busy = sum(groups.values())
            kern.sort(key=lambda e: -e.self_device_time_total)
            out.update(device_ms=groups, device_busy_ms=busy,
                       idle_ms=wall * 1e3 - busy,
                       idle_share=1 - busy / (wall * 1e3),
                       kernels_run=sum(e.count for e in kern),
                       busiest=[(e.key[:60], e.self_device_time_total / 1e3,
                                 e.count) for e in kern[:8]])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def train_long_bound(cfg, tokens: int) -> dict:
    """14(d)'s step bound: the FLOPs of a step (6 N a token, the causal
    attention forward and backward, and the layers' forward once more
    for remat) over 989 TFLOP/s x 4 cards."""
    seq = 4096
    pairs = cfg.n_heads * visible_pairs(seq, seq, True) * (tokens // seq)
    dense = 6 * cfg.n_params() * tokens + 14 * pairs * cfg.d_head \
        * cfg.n_layers
    layers = cfg.n_params() - 2 * cfg.vocab * cfg.d_model
    remat = 2 * layers * tokens + 4 * pairs * cfg.d_head * cfg.n_layers
    flops = dense + remat
    return dict(flops=flops, bound_s=flops / (BF16_FLOPS * 4),
                flops_without_remat=dense)


def phase_train_long(torch, work: str) -> dict:
    """14(d) on 4 cards: this process is rank 0, one ``--train-long-rank``
    process a further card; each rank prints its result as a JSON line
    (stdout), rank 0's is returned with the others'."""
    from repro_torch.configs.mistral_nemo_12b import CONFIG

    world = torch.cuda.device_count()
    check(world == 4, f"14(d) needs 4 cards, the machine has {world}")
    store = str(Path(work) / "nccl-train-long-store")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--train-long-rank", str(r), "--dist-world", str(world),
         "--dist-store", store], stdout=subprocess.PIPE, text=True)
        for r in range(1, world)]
    try:
        out = train_long_rank(torch, 0, world, store)
        others = []
        for p in procs:
            text, _ = p.communicate(timeout=DIST_TIMEOUT + 600)
            check(p.returncode == 0, f"14(d): a rank exited {p.returncode}")
            others.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bound = train_long_bound(CONFIG, TRAIN_LONG["batch"] * 4096)
    return dict(rank0=out, others=others, bound=bound,
                reduced=[f"14(d): global batch 256 -> {TRAIN_LONG['batch']} "
                         f"sequences of 4096 (8 a data rank, accum "
                         f"{TRAIN_LONG['accum']}: microbatch 1 x 4096); "
                         f"{TRAIN_LONG['steps']} timed steps and one "
                         f"profiled"])


# ---------------------------------------------------------------------------
# phase 15: SchNet's train cells on a mesh, and the elastic checkpoint
# ---------------------------------------------------------------------------
GNN_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg", "ogb_products")
GNN_REPLAY = (2, 2)             # 15(b): (data, model), processes on one card
GNN_REPLAY_SHAPES = ("molecule", "full_graph_sm")
GNN_LONG = dict(mesh=(2, 2), steps=3)   # 15(d): ogb_products on 4 cards


def gnn_batch(torch, cell, dev, seed: int) -> dict:
    """A seeded batch of SchNet ``cell``'s shape made on the card with
    ``steps.smoke_batch``'s distributions (edges uniform over the nodes,
    distances in [0, 9), features N(0, 1), labels uniform over the
    classes; molecules: atom numbers in [1, 50), each graph a block of
    nodes, energies N(0, 1)), drawn by torch: ogb_products' 61.9M edges
    in milliseconds, not seconds on the host. The same seed gives the
    same batch on every card."""
    specs = cell.arg_specs[2]
    gen = torch.Generator(device=dev).manual_seed(seed)
    node = next(k for k in ("node_feat", "atom_z") if k in specs)
    n, e = specs[node].shape[0], specs["edge_dist"].shape[0]

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    out = {"edge_index": ints(0, n, (2, e)),
           "edge_dist": torch.rand((e,), generator=gen, device=dev) * 9}
    if node == "atom_z":
        g = specs["energy"].shape[0]
        out.update(atom_z=ints(1, 50, (n,)),
                   graph_ids=torch.arange(g, device=dev, dtype=torch.int32)
                   .repeat_interleave(n // g),
                   energy=torch.randn((g,), generator=gen, device=dev))
    else:
        out.update(node_feat=torch.randn(specs[node].shape, generator=gen,
                                         device=dev),
                   labels=ints(0, cell.model_cfg.n_classes, (n,)))
    return out


def _clone(tree):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def _meta(tree):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.new_empty(t.shape, device="meta"), tree)


def edge_order_floor(torch, one, params, batch, loss1, m1,
                     world: int) -> dict:
    """Each AdamW m leaf's largest distance between the no-mesh step
    (``loss1``, ``m1``: SchNet cell ``one``'s from ``params``, which stay
    unchanged) and the same step with the batch's edges in another order
    (a seeded permutation) and cut into chunks of E / ``world`` edges: the
    filter products at a rank's shapes, each node's sum over its edges in
    another order and its chunks' sums added, as a mesh's ranks sum their
    own blocks of the edges and add the partial aggregates; the function
    is the same, and its loss must be within ``DIST_FP32``. The order
    floor of ``mesh_step_leaves`` for a SchNet mesh step."""
    from repro_torch.models import schnet as sm
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves

    dev = batch["edge_dist"].device
    e = batch["edge_dist"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 66)
    perm = torch.randperm(e, generator=gen, device=dev)
    permuted = dict(batch, edge_index=batch["edge_index"][:, perm],
                    edge_dist=batch["edge_dist"][perm])
    chunk, cfg = -(-e // world), one.model_cfg
    if "energy" in batch:
        permuted["n_graphs"] = batch["energy"].shape[0]

        def loss_fn(p, b):
            return sm.energy_loss(p, cfg, b, edge_chunk=chunk)
    else:
        def loss_fn(p, b):
            return sm.node_class_loss(p, cfg, b, edge_chunk=chunk)
    p = _clone(params)
    loss, grads = grad_accum_value_and_grad(loss_fn)(p, permuted)
    check(abs(float(loss) - float(loss1)) <= DIST_FP32["loss"] * abs(
        float(loss1)), f"the step on reordered edges: loss {float(loss)}, "
                       f"not the step's {float(loss1)}")
    opt = adamw()
    st = opt.init(p)
    opt.update(grads, st, p, torch.tensor(0, dtype=torch.int32, device=dev))
    want = dict(leaves(m1))
    return {name: float((want[name].to(dev) - t).abs().max())
            for name, t in leaves(st["m"])}


def gnn_mesh_cell(torch, dev, shape: str, mesh, world: int, count) -> dict:
    """15(a), one SchNet cell at its published size: phase 11's no-mesh
    step and ``build_cell(..., mesh=)``'s step (through ``shard_args``:
    the rank's blocks of the edges and node rows) from the same seeded
    params and batch on this card, bit for bit at world 1 (loss, params,
    AdamW m), by ``DIST_FP32`` beyond (each m leaf, or ``FLOOR_TIMES`` x
    its ``edge_order_floor`` where that is larger). Returns the mesh
    step's ms, peak and collective tally."""
    from repro_torch.launch import collectives as col
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models import schnet as sm

    one = build_cell(SCHNET, shape, device=dev)
    cell = build_cell(SCHNET, shape, device=dev, mesh=mesh)
    params = sm.init_params(one.model_cfg, seed=SEED + 60, device=dev)
    batch = gnn_batch(torch, one, dev, SEED + 61)
    step0 = torch.tensor(0, dtype=torch.int32, device=dev)
    p = _clone(params)
    p1, o1, l1 = one.fn(p, one.opt.init(p), batch, step0)
    m1 = o1["m"]
    exact = world == 1
    floor = None if exact else edge_order_floor(torch, one, params, batch,
                                                l1, m1, world)
    args = shard_args(cell, (params, None, batch, step0))
    del o1, params, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    col.take_records()
    torch.cuda.synchronize()
    t = time.perf_counter()
    p2, o2, l2 = count(cell.fn, *args)
    torch.cuda.synchronize()
    out = dict(step_ms=(time.perf_counter() - t) * 1e3,
               peak_gb=peak_gb(torch), loss=float(l2),
               collectives=col.collective_stats(col.take_records()))
    out["worst"] = {
        "param": mesh_step_leaves(torch, f"15(a) {shape} param", p1, p2,
                                  exact),
        "m": mesh_step_leaves(torch, f"15(a) {shape} m", m1, o2["m"], exact,
                              floor)}
    if exact:
        check(torch.equal(l1, l2), f"15(a) {shape}: loss {float(l2)} on "
                                   f"the mesh, {float(l1)} without")
    else:
        rel = abs(float(l1) - float(l2)) / abs(float(l1))
        out["worst"]["loss"] = rel / DIST_FP32["loss"]
        check(rel <= DIST_FP32["loss"],
              f"15(a) {shape}: loss {float(l2)} vs {float(l1)}")
    del p1, m1, p2, o2, args
    torch.cuda.empty_cache()
    return out


def replay_specs(cell, mesh) -> tuple:
    """The spec tree of 14(b)'s train state ({"params", "opt_state"}:
    the cell's repro specs) and the rank's ZeRO layout."""
    from repro_torch.launch.steps import zero_layout
    return (dict(zip(("params", "opt_state"), cell.sharding_fn(mesh)[:2])),
            zero_layout(cell))


def ckpt_onto_world(torch, dev, mesh, ckpt: str) -> dict:
    """15(c), last: 14(b)'s checkpoint restored onto 14(a)'s world
    (``make_host_mesh(1, world)``) as the blocks of the same fp32 replay
    cell there, each equal bit for bit to its cut of the whole arrays
    (restored on the card without a mesh, cut as the step cuts them:
    ``rank_blocks``, m and v at the ZeRO blocks)."""
    from repro_torch.launch.sharding import local_shape
    from repro_torch.launch.steps import build_cell, param_shapes
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.tree import leaves, tree_map_with_path

    cfg = replay_config(torch)
    cell = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg, accum=1,
                      mesh=mesh)
    specs, layout = replay_specs(cell, mesh)
    flat = dict(leaves(specs["params"]))
    shapes = param_shapes(NEMO, cfg)
    target = {"params": tree_map_with_path(lambda path, t: t.new_empty(
        local_shape(tuple(t.shape), flat[path], mesh), device="meta"),
        shapes), "opt_state": layout.state_blocks("meta")}
    mgr = CheckpointManager(ckpt)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got, step, _ = mgr.restore(target, device=dev, mesh=mesh, specs=specs,
                               layout=layout, verify=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    check(step == 1, f"15(c): the checkpoint holds step {step}")
    whole, _, _ = mgr.restore({"params": shapes,
                               "opt_state": adamw().init(shapes)},
                              device=dev, verify=False)
    want = {"params": rank_blocks(cell, whole["params"]),
            "opt_state": {k: rank_blocks(cell, whole["opt_state"][k],
                                         opt=True) for k in ("m", "v")}}
    n = 0
    for (name, a), (_, b) in zip(leaves(want), leaves(got)):
        check(torch.equal(a, b), f"15(c): {name} restored onto the world's "
                                 f"mesh is not its block")
        n += 1
    del got, whole, want
    torch.cuda.empty_cache()
    return dict(restore_s=secs, leaves=n)


def gnn_mesh_rank(torch, rank: int, world: int, store: str,
                  dev_type: str = "cuda", count=None,
                  ckpt: str = None) -> dict:
    """15(a) on one rank of a NCCL process group of ``world`` ranks, one a
    card, met through a ``FileStore`` at ``store``: SchNet's four cells
    (``gnn_mesh_cell``) on ``make_host_mesh(1, world)``, then, given
    14(b)'s checkpoint ``ckpt``, ``ckpt_onto_world``. ``count`` (a
    ``PathCounts``) wraps the mesh steps."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    count = count or (lambda fn, *a, **k: fn(*a, **k))
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(1, world, device_type=dev_type)
        out = {"world": world,
               "cells": {s: gnn_mesh_cell(torch, dev, s, mesh, world, count)
                         for s in GNN_SHAPES}}
        if ckpt:
            out["restore"] = ckpt_onto_world(torch, dev, mesh, ckpt)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_gnn_mesh_collective(torch, work: str, dev_type: str, count,
                              ckpt: str) -> dict:
    """15(a) at world ``torch.cuda.device_count()``: in this process on
    one card; with more, one ``--gnn-rank`` process a card."""
    world = torch.cuda.device_count()
    store = str(Path(work) / "nccl-gnn-store")
    if world == 1:
        return gnn_mesh_rank(torch, 0, 1, store, dev_type, count, ckpt)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--gnn-rank",
         str(r), "--dist-world", str(world), "--dist-store", store,
         "--replay-ckpt", ckpt]) for r in range(1, world)]
    try:
        out = gnn_mesh_rank(torch, 0, world, store, dev_type, count, ckpt)
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"15(a): a rank exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def gnn_replay_reference(torch, dev, ref: str) -> dict:
    """15(b)'s no-mesh steps on the card: molecule and full_graph_sm at
    their published sizes from seeded params and batches, saved to
    ``ref`` (loss, params, AdamW m, the batch, m's ``edge_order_floor``)
    for the ranks."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import schnet as sm

    out = {}
    step0 = torch.tensor(0, dtype=torch.int32, device=dev)
    for shape in GNN_REPLAY_SHAPES:
        one = build_cell(SCHNET, shape, device=dev)
        params = sm.init_params(one.model_cfg, seed=SEED + 62, device=dev)
        batch = gnn_batch(torch, one, dev, SEED + 63)
        p = _clone(params)
        p, o, loss = one.fn(p, one.opt.init(p), batch, step0)
        out[shape] = {"loss": loss.cpu(), "param": _host(p),
                      "m": _host(o["m"]), "batch": _host(batch),
                      "floor": edge_order_floor(
                          torch, one, params, batch, loss, o["m"],
                          GNN_REPLAY[0] * GNN_REPLAY[1])}
    torch.save(out, ref)
    return {s: float(out[s]["loss"]) for s in out}


def gnn_replay_rank(torch, rank: int, world: int, store: str, ref: str,
                    dev_type: str = "cuda") -> dict:
    """15(b) on one of ``world`` processes that share the one card, a
    gloo process group on a ``GNN_REPLAY`` mesh: each of
    ``GNN_REPLAY_SHAPES`` through ``build_cell(..., mesh=)`` (the rank's
    edges and node rows), held to ``gnn_replay_reference``'s step by
    ``DIST_FP32`` (each m leaf, or ``FLOOR_TIMES`` x its
    ``edge_order_floor`` where that is larger). Returns the rank's losses, step ms, peaks, worst
    ratios, collective tallies and the launches of ``gather_segment_sum``
    and its backward kernel."""
    import torch.distributed as dist
    from repro_torch.kernels.segment_sum import ops as ss
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models import schnet as sm

    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    names = {"gather_segment_sum": "launches",
             "gather_segment_sum_bwd": "bwd_launches"}
    out = {"rank": rank, "cells": {}, "launches": dict.fromkeys(names, 0)}
    try:
        mesh = make_host_mesh(*GNN_REPLAY, device_type=dev_type)
        want_all = torch.load(ref)
        step0 = torch.tensor(0, dtype=torch.int32, device=dev)
        for shape in GNN_REPLAY_SHAPES:
            want = want_all[shape]
            cell = build_cell(SCHNET, shape, device=dev, mesh=mesh)
            params = sm.init_params(cell.model_cfg, seed=SEED + 62,
                                    device=dev)
            batch = {k: v.to(dev) for k, v in want["batch"].items()}
            args = shard_args(cell, (params, None, batch, step0))
            torch.cuda.reset_peak_memory_stats()
            col.take_records()
            before = {k: getattr(ss, a) for k, a in names.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, o, loss = cell.fn(*args)
            torch.cuda.synchronize()
            res = dict(step_ms=(time.perf_counter() - t) * 1e3,
                       loss=float(loss), peak_gb=peak_gb(torch),
                       collectives=col.collective_stats(col.take_records()))
            for k, a in names.items():
                out["launches"][k] += getattr(ss, a) - before[k]
            rel = abs(float(loss) - float(want["loss"])) / abs(
                float(want["loss"]))
            check(rel <= DIST_FP32["loss"], f"15(b) rank {rank} {shape}: "
                                            f"loss {float(loss)} vs "
                                            f"{float(want['loss'])}")
            plain = {}
            res["worst"] = {
                "loss": rel / DIST_FP32["loss"],
                "param": mesh_step_leaves(torch, f"15(b) rank {rank} {shape} "
                                          f"param", want["param"], p, False),
                "m": mesh_step_leaves(torch, f"15(b) rank {rank} {shape} m",
                                      want["m"], o["m"], False,
                                      want["floor"], plain)}
            res["m_vs_dist_fp32"] = max(plain.values())
            out["cells"][shape] = res
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_gnn_replay(torch, dev, work: str) -> dict:
    """15(b): the reference steps here, then ``GNN_REPLAY``'s ranks as
    ``--gnn-replay-rank`` processes on this card (killed after
    ``DIST_TIMEOUT`` s), each printing its result as one JSON line."""
    ref = str(Path(work) / "gnn-replay-ref.pt")
    out = {"reference": gnn_replay_reference(torch, dev, ref)}
    world = GNN_REPLAY[0] * GNN_REPLAY[1]
    store = str(Path(work) / "gloo-gnn-store")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--gnn-replay-rank", str(r), "--dist-world", str(world),
         "--dist-store", store, "--replay-ref", ref],
        stdout=subprocess.PIPE, text=True) for r in range(world)]
    ranks = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"15(b): a rank exited {p.returncode}")
            ranks.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["ranks"] = ranks
    return out


FINGERPRINT_CHUNK = 1 << 26     # elements of one fingerprint pass


def bits_fingerprint(torch, t) -> int:
    """A 64-bit fingerprint of a tensor's bits: each element's bits read
    as an integer times a weight of its position, summed with 64-bit
    wraparound. Integer sums are exact in any order, so equal tensors give
    equal fingerprints, and a block and the same bits cut from another
    copy compare without moving either."""
    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view(torch.int32 if flat.element_size() == 4
                     else torch.int16)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for lo in range(0, bits.numel(), FINGERPRINT_CHUNK):
        v = bits[lo:lo + FINGERPRINT_CHUNK].to(torch.int64)
        w = torch.arange(lo, lo + v.numel(), device=v.device,
                         dtype=torch.int64) * 40503 % 2147483629 + 1
        total += (v * w).sum()
    return int(total)


def ckpt_save_rank(torch, rank: int, cell, mesh, state: dict, batch,
                   ckpt: str) -> dict:
    """15(c) on a 14(b) rank, after its step: save the train state
    ({"params", "opt_state"}: the rank's blocks) with the mesh, then the
    run's next step, step 2. The blocks' ``bits_fingerprint``s (taken
    before step 2 updates them in place), step 2's loss and its AdamW m
    blocks go to ``ckpt/step2_rank<r>.pt`` for ``ckpt_one_card``."""
    from repro_torch.launch.mesh import coordinate
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves

    specs, layout = replay_specs(cell, mesh)
    torch.cuda.empty_cache()      # step 1's cached blocks: 4 ranks share
    torch.cuda.synchronize()      # the card, and step 2 needs them back
    t = time.perf_counter()
    CheckpointManager(ckpt).save(1, state, mesh=mesh, specs=specs,
                                 layout=layout)
    out = {"save_s": time.perf_counter() - t}
    prints = {name: bits_fingerprint(torch, a) for name, a in leaves(state)}
    step1 = torch.tensor(1, dtype=torch.int32, device=batch["tokens"].device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    o, loss = cell.fn(state["params"], state["opt_state"], batch,
                      step1)[1:]
    torch.cuda.synchronize()
    out.update(step2_ms=(time.perf_counter() - t) * 1e3,
               step2_peak_gb=peak_gb(torch))
    torch.save({"loss": loss.cpu(), "m": _host(o["m"]),
                "coord": coordinate(mesh), "fingerprints": prints},
               Path(ckpt) / f"step2_rank{rank}.pt")
    return out


def ckpt_one_card(torch, dev, ckpt: str, ref: dict) -> dict:
    """15(c) on the card once 14(b)'s ranks have saved, taken step 2 and
    exited: the checkpoint restored without a mesh (checksums verified);
    each rank's blocks cut from it as the step cuts them (the params by
    ``tp.serving_blocks``, m and v at the ZeRO blocks of those) with
    the ``bits_fingerprint`` the rank took of its own blocks (the
    restored state is the ranks' blocks laid back whole, bit for bit);
    the state held to the no-mesh step 1 it came from (``DIST_FP32`` or
    the order floor); then step 2 on one card, and the same step on a
    copy of the state, ``flipped``, for step 2's order floor; each
    rank's step 2 (``step2_rank<r>.pt``) held to it by ``DIST_FP32``
    (loss) and ``DIST_FP32`` or ``FLOOR_TIMES`` x that floor (each m
    block)."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_cell, param_shapes, zero_layout
    from repro_torch.models.tp import serving_blocks
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.tree import leaves, tree_map, tree_map_with_path

    cfg = replay_config(torch)
    one = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg, accum=1)
    shapes = param_shapes(NEMO, cfg)
    target = {"params": shapes, "opt_state": adamw().init(shapes)}
    mgr = CheckpointManager(ckpt)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, step, _ = mgr.restore(target, device=dev)
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t,
           "bytes": sum(x.numel() * x.element_size()
                        for x in _leaves(state))}
    check(step == 1, f"15(c): the checkpoint holds step {step}")
    mesh = MeshShape(TRAIN_REPLAY, ("data", "model"))
    meta = build_cell(NEMO, "train_4k", device="meta", model_cfg=cfg,
                      accum=1)
    pspec = meta.sharding_fn(mesh)[0]
    ranks = [torch.load(Path(ckpt) / f"step2_rank{r}.pt", mmap=True)
             for r in range(TRAIN_REPLAY[0] * TRAIN_REPLAY[1])]

    def blocks(tree, coord, zero: bool):
        """The rank at ``coord``'s blocks of a whole tree shaped as the
        params (views)."""
        cut = serving_blocks(tree, pspec, mesh, cfg.act, coord, copy=False)
        if not zero:
            return cut
        lay = zero_layout(meta, "adamw", mesh, coord)
        return tree_map_with_path(lambda p, x: lay.leaf(p).zero_block(x),
                                  cut)

    for r, got in enumerate(ranks):
        cut = {"params": blocks(state["params"], got["coord"], False),
               "opt_state": {k: blocks(v, got["coord"], True)
                             for k, v in state["opt_state"].items()}}
        for name, x in leaves(cut):
            check(bits_fingerprint(torch, x) == got["fingerprints"][name],
                  f"15(c): rank {r}'s {name} is not its block of the "
                  f"restored state")
    out["worst_restored"] = {
        "param": mesh_step_leaves(torch, "15(c) restored param",
                                  ref["param"], state["params"], False),
        "m": mesh_step_leaves(torch, "15(c) restored m", ref["m"],
                              state["opt_state"]["m"], False, ref["floor"])}
    batch = {k: v.to(dev) for k, v in ref["batch"].items()}
    step1 = torch.tensor(1, dtype=torch.int32, device=dev)
    flip = {"params": flipped(state["params"], cfg),
            "opt_state": {k: flipped(v, cfg)
                          for k, v in state["opt_state"].items()}}
    flip = _clone(flip)                  # a copy: the step runs in place
    t2 = time.perf_counter()
    o, loss = one.fn(state["params"], state["opt_state"], batch, step1)[1:]
    m2 = _host(o["m"])
    out["step2_s"] = time.perf_counter() - t2
    del state, o
    torch.cuda.empty_cache()
    o, flip_loss = one.fn(flip["params"], flip["opt_state"], batch,
                          step1)[1:]
    check(abs(float(flip_loss) - float(loss)) <= DIST_FP32["loss"] * abs(
        float(loss)), f"15(c): the flipped step 2's loss {float(flip_loss)} "
                      f"is not step 2's {float(loss)}")
    ref_m = dict(leaves(m2))
    floor = {name: float((ref_m[name].to(dev) - x).abs().max())
             for name, x in leaves(flipped(o["m"], cfg))}
    del flip, o, batch
    torch.cuda.empty_cache()
    m2 = tree_map(lambda x: x.to(dev), m2)
    out["worst_step2"] = {"loss": 0.0, "m": 0.0}
    for r, got in enumerate(ranks):       # each rank's step 2, on the card
        rel = abs(float(got["loss"]) - float(loss)) / abs(float(loss))
        check(rel <= DIST_FP32["loss"], f"15(c) rank {r}: step 2's loss "
                                        f"{float(got['loss'])} vs "
                                        f"{float(loss)} on one card")
        out["worst_step2"] = {
            "loss": max(out["worst_step2"]["loss"], rel / DIST_FP32["loss"]),
            "m": max(out["worst_step2"]["m"], mesh_step_leaves(
                torch, f"15(c) rank {r} step 2 m",
                blocks(m2, got["coord"], True),
                tree_map(lambda x: x.to(dev), got["m"]), False, floor))}
    del m2
    torch.cuda.empty_cache()
    out.update(step2_loss=float(loss), seconds=time.perf_counter() - t)
    return out


def gnn_long_rank(torch, rank: int, world: int, store: str,
                  dev_type: str = "cuda") -> dict:
    """15(d), outside the default run (``--gnn-mesh``, on a machine with 4
    cards): SchNet ogb_products at its published size on a 2 x 2 mesh,
    one NCCL process a card, through ``build_cell(..., mesh=)``: each
    rank makes the same seeded params and batch on its card and keeps
    its blocks (a quarter of the edges, half the node rows); rank 0
    first takes the no-mesh step on its card (the others wait). Then
    ``GNN_LONG``'s steps, each timed on the host clock between
    synchronizes; the losses must be equal on the 4 ranks and the first
    within ``DIST_FP32`` of the one-card step's. Returns s a step, the
    peak, the collectives of a step."""
    import torch.distributed as dist
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import coordinate, make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models import schnet as sm

    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*GNN_LONG["mesh"], device_type=dev_type)
        one = build_cell(SCHNET, "ogb_products", device=dev)
        cell = build_cell(SCHNET, "ogb_products", device=dev, mesh=mesh)
        params = sm.init_params(one.model_cfg, seed=SEED + 64, device=dev)
        batch = gnn_batch(torch, one, dev, SEED + 65)
        step0 = torch.tensor(0, dtype=torch.int32, device=dev)
        one_loss = torch.zeros((), device=dev)
        if rank == 0:
            p = _clone(params)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, one_loss = one.fn(p, one.opt.init(p), batch, step0)
            torch.cuda.synchronize()
            one_s, one_peak = time.perf_counter() - t, peak_gb(torch)
            del p
            torch.cuda.empty_cache()
        dist.barrier()
        args = list(shard_args(cell, (params, None, batch, step0)))
        del params, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses, stats = [], [], None
        for i in range(GNN_LONG["steps"]):
            args[3] = torch.tensor(i, dtype=torch.int32, device=dev)
            dist.barrier()
            torch.cuda.synchronize()
            col.take_records()
            t = time.perf_counter()
            args[0], args[1], loss = cell.fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            stats = col.collective_stats(col.take_records())
            every = [torch.empty_like(loss) for _ in range(world)]
            dist.all_gather(every, loss.detach().clone())
            check(all(torch.equal(x, loss) for x in every),
                  f"15(d) step {i}: the ranks' losses differ: "
                  f"{[float(x) for x in every]}")
            losses.append(float(loss))
            if i == 0:
                first = loss.detach().clone()
        dist.broadcast(one_loss, 0)
        rel = abs(float(first) - float(one_loss)) / abs(float(one_loss))
        check(rel <= DIST_FP32["loss"], f"15(d): loss {float(first)} on 2 x 2,"
                                        f" {float(one_loss)} on one card")
        out = dict(rank=rank, coord=coordinate(mesh), step_s=times,
                   losses=losses, peak_gb=peak_gb(torch),
                   loss_vs_one_card=rel / DIST_FP32["loss"],
                   collectives={op: {k: stats[op][k] for k in
                                     ("count", "bytes", "wire_bytes")}
                                for op in ("all-gather", "all-reduce")})
        if rank == 0:
            out.update(one_card_s=one_s, one_card_peak_gb=one_peak,
                       one_card_loss=float(one_loss))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def phase_gnn_long(torch, work: str) -> dict:
    """15(d) on 4 cards: this process is rank 0, one ``--gnn-long-rank``
    process a further card; each prints its result as a JSON line."""
    world = torch.cuda.device_count()
    check(world == 4, f"15(d) needs 4 cards, the machine has {world}")
    store = str(Path(work) / "nccl-gnn-long-store")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--gnn-long-rank", str(r), "--dist-world", str(world),
         "--dist-store", store], stdout=subprocess.PIPE, text=True)
        for r in range(1, world)]
    try:
        out = gnn_long_rank(torch, 0, world, store)
        others = []
        for p in procs:
            text, _ = p.communicate(timeout=DIST_TIMEOUT)
            check(p.returncode == 0, f"15(d): a rank exited {p.returncode}")
            others.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(rank0=out, others=others,
                reduced=[f"15(d): {GNN_LONG['steps']} timed steps; seeded "
                         f"edges, features and labels at the published "
                         f"graph's sizes (as phase 11)"])


def phase_gnn_mesh(torch, dev, ckpt: str, replay: dict) -> dict:
    """Phase 15. (a) SchNet's four cells at world ``device_count()``,
    then 14(b)'s checkpoint onto that world; (b) molecule and
    full_graph_sm on 2 x 2 as 4 gloo processes on the card; (c) the
    checkpoint round trip run beside 14(b) (``replay``: its results).
    Returns the launches of ``gather_segment_sum`` and its backward
    kernel on the mesh steps."""
    from repro_torch.kernels.segment_sum import ops as ss

    t0 = time.perf_counter()
    count = PathCounts({"gather_segment_sum": (ss, "launches"),
                        "gather_segment_sum_bwd": (ss, "bwd_launches")})
    with tempfile.TemporaryDirectory(prefix="chip_smoke-gnn-") as work:
        a = phase_gnn_mesh_collective(torch, work, dev.type, count, ckpt)
        held = "bit for bit (loss, params, AdamW m)" if a["world"] == 1 \
            else "fp32 by DIST_FP32"
        log(f"  15(a) NCCL world {a['world']}: SchNet's four cells at their "
            f"published sizes through build_cell(mesh=make_host_mesh(1, "
            f"{a['world']})) equal to the no-mesh steps, {held}; mesh steps "
            + ", ".join(f"{s} {c['step_ms']:.1f} ms ({c['peak_gb']:.2f} GB, "
                        f"{c['collectives']['all-reduce']['count']} "
                        f"all-reduces, {c['collectives']['all-gather']['count']}"
                        f" all-gathers)" for s, c in a["cells"].items()))
        log(f"  15(c) 14(b)'s checkpoint restored onto 14(a)'s world: "
            f"{a['restore']['leaves']} leaves, each its block of the whole "
            f"arrays bit for bit ({a['restore']['restore_s']:.1f} s)")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        b = phase_gnn_replay(torch, dev, work)
        b["seconds"] = time.perf_counter() - t
    worst = {k: max(r["cells"][s]["worst"][k] for r in b["ranks"]
                    for s in GNN_REPLAY_SHAPES) for k in ("loss", "param", "m")}
    log(f"  15(b) {GNN_REPLAY[0]} x {GNN_REPLAY[1]} (gloo, {len(b['ranks'])} "
        f"processes on the card): SchNet {', '.join(GNN_REPLAY_SHAPES)} at "
        f"their published sizes against the no-mesh steps by DIST_FP32 or "
        f"{FLOOR_TIMES} x the edge-order floor: worst {json.dumps(worst)}; "
        f"m against DIST_FP32 alone "
        + json.dumps({s: max(r["cells"][s]["m_vs_dist_fp32"]
                             for r in b["ranks"]) for s in GNN_REPLAY_SHAPES})
        + "; rank steps "
        + json.dumps({s: [round(r["cells"][s]["step_ms"], 1)
                          for r in b["ranks"]] for s in GNN_REPLAY_SHAPES})
        + f" ms ({b['seconds']:.1f} s)")
    c = replay["checkpoint"]
    saved = [r["checkpoint"] for r in replay["ranks"]]
    log(f"  15(c) 14(b)'s 2 x 2 state ({c['bytes'] / 1e9:.2f} GB) saved from "
        f"the ranks' blocks in {max(r['save_s'] for r in saved):.1f} s; "
        f"restored on one card in {c['restore_s']:.1f} s (checksums "
        f"verified), each rank's blocks cut from it with the rank's own "
        f"bit fingerprints, within DIST_FP32 or the floor of the no-mesh "
        f"step it came from "
        f"{json.dumps(c['worst_restored'])}; step 2 on one card "
        f"({c['step2_s']:.1f} s) against the 2 x 2 run's step 2 "
        f"({[round(r['step2_ms'], 1) for r in saved]} ms): worst "
        f"{json.dumps(c['worst_step2'])} ({c['seconds']:.1f} s on one card)")
    launches = {k: n + sum(r["launches"][k] for r in b["ranks"])
                for k, n in count.n.items()}
    log(json.dumps({"phase15": dict(collective=a, replay=b, checkpoint=dict(
        c, ranks=[r["checkpoint"] for r in replay["ranks"]]),
        launches=launches, reduced=[
            "15(a), 15(b): seeded edges, features and labels at the "
            "published graphs' sizes; one step each",
            "15(c): 14(b)'s cut (Mistral-NeMo 2 of 40 layers, fp32, 2 x "
            "4096); the ranks share one card over gloo"])}))
    log(f"  launches on phase 15's mesh steps: {launches}; phase 15 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on phase 15's mesh steps")
    return launches


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit: phases 2 and "
                         "7 also hold each top-k and bag call against its "
                         "kernels, bit for bit, and time them")
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # phase 12(a)'s other ranks
    ap.add_argument("--dist-world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # phase 13(a)'s other ranks
    ap.add_argument("--serve-long", action="store_true",
                    help="on a machine with 4 cards, run only 13(d): "
                         "long_500k at all 40 layers of Mistral-NeMo-12B "
                         "on 2 x 2, one process a card")
    ap.add_argument("--serve-long-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 13(d)'s other ranks
    ap.add_argument("--train-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 14(a)'s other ranks
    ap.add_argument("--train-replay-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 14(b)'s ranks
    ap.add_argument("--replay-ref", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--train-mesh", action="store_true",
                    help="on a machine with 4 cards, run only 14(d): "
                         "Mistral-NeMo-12B train_4k at all 40 layers on "
                         "2 x 2 (TP, ZeRO-1), one process a card")
    ap.add_argument("--train-long-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 14(d)'s other ranks
    ap.add_argument("--replay-ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gnn-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 15(a)'s other ranks
    ap.add_argument("--gnn-replay-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 15(b)'s ranks
    ap.add_argument("--gnn-mesh", action="store_true",
                    help="on a machine with 4 cards, run only 15(d): "
                         "SchNet ogb_products at its published size on "
                         "2 x 2, one process a card")
    ap.add_argument("--gnn-long-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # 15(d)'s other ranks
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

    ranks = {"dist_rank": dist_rank, "serve_rank": serve_dist_rank,
             "serve_long_rank": serve_long_rank,
             "train_rank": train_mesh_rank,
             "train_long_rank": train_long_rank,
             "train_replay_rank": lambda torch, r, w, store: train_replay_rank(
                 torch, r, w, store, args.replay_ref, ckpt=args.replay_ckpt),
             "gnn_rank": lambda torch, r, w, store: gnn_mesh_rank(
                 torch, r, w, store, ckpt=args.replay_ckpt),
             "gnn_replay_rank": lambda torch, r, w, store: gnn_replay_rank(
                 torch, r, w, store, args.replay_ref),
             "gnn_long_rank": gnn_long_rank}
    for flag, fn in ranks.items():
        if getattr(args, flag) is not None:  # a rank of 12-14 on a card
            torch.backends.cuda.matmul.allow_tf32 = False
            for name in build.sources():
                build.load(name)
            res = fn(torch, getattr(args, flag), args.dist_world,
                     args.dist_store)
            if flag in ("train_long_rank", "train_replay_rank",
                        "gnn_replay_rank", "gnn_long_rank"):
                print(json.dumps(res))
            return 0
    for flag, title, phase in (
            ("serve_long", "phase13d", phase_serve_long),
            ("train_mesh", "phase14d", phase_train_long),
            ("gnn_mesh", "phase15d", phase_gnn_long)):
        if not getattr(args, flag):
            continue
        torch.backends.cuda.matmul.allow_tf32 = False
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip())
        build.build()
        for name in build.sources():
            build.load(name)
        with tempfile.TemporaryDirectory(prefix="chip_smoke-long-") as work:
            log(json.dumps({title: phase(torch, work)}))
        return 0
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
        fa.launches = fd.launches = fa.tf32_launches = 0
        roots = phase_rag_store(torch, work, emb, cpu_emb)
        check(fa.launches > 0 and fa.tf32_launches == fa.launches,
              f"MiniLM: {fa.tf32_launches} of {fa.launches} fp32 attention "
              f"launches ran the 3xTF32 body")
        TF32_PATH["flash_attention_tf32"] += fa.tf32_launches
        log(f"  launches of the MiniLM embedder (phase 5): flash_attention "
            f"{fa.launches}, on the 3xTF32 body {fa.tf32_launches}")
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

    start_phase(torch, "phase 12: distribution on the card", t0)
    torch.cuda.empty_cache()
    for name, n in phase_distribution(torch, dev).items():
        launches[name] = launches.get(name, 0) + n

    start_phase(torch, "phase 13: the LM family's serving cells on a mesh",
                t0)
    torch.cuda.empty_cache()
    for name, n in phase_serving_mesh(torch, dev).items():
        launches[name] = launches.get(name, 0) + n

    with tempfile.TemporaryDirectory(prefix="chip_smoke-ckpt-") as ckpt:
        start_phase(torch, "phase 14: the LM and recsys train cells on a "
                           "mesh", t0)
        torch.cuda.empty_cache()
        train_launches, replay = phase_train_mesh(torch, dev, ckpt)
        for name, n in train_launches.items():
            launches[name] = launches.get(name, 0) + n

        start_phase(torch, "phase 15: SchNet's train cells on a mesh, the "
                           "elastic checkpoint", t0)
        torch.cuda.empty_cache()
        for name, n in phase_gnn_mesh(torch, dev, ckpt, replay).items():
            launches[name] = launches.get(name, 0) + n

    # the fp32 bodies' own rows: their launches by the library's counts on
    # phases 5, 7 and 10, their times from phases 2 and 10
    for name, whole in (("flash_attention_tf32", "flash_attention"),
                        ("flash_attention_bwd_tf32", "flash_attention_bwd")):
        launches[name] = launches.get(name, 0) + TF32_PATH[name]
        times = [r for r in kern[whole]["times"] if r.get("body") == "tf32"]
        kern[name] = {"err": max(r["max_abs_err"] for r in times),
                      "times": times}
    log(f"  launches of the 3xTF32 bodies on the main paths (phases 5, 7, "
        f"10): { {n: launches[n] for n in TF32_PATH} }")
    for name in TF32_PATH:
        check(launches[name] > 0, f"{name} was never launched on the main "
                                  f"paths")
    rows = []
    main_shape = {"flash_attention": "nemo prefill 256",
                  "flash_attention_tf32": "minilm encode 256x128",
                  "flash_decode": "engine cache 320",
                  "embedding_bag": "grouped serve_p99",
                  "flash_attention_bwd": "nemo train_4k",
                  "flash_attention_bwd_tf32": "bert4rec train 256x200",
                  "embedding_bag_bwd": "dlrm train_batch",
                  "gather_segment_sum": OGB_CHUNK,
                  "gather_segment_sum_bwd": OGB_CHUNK}
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
