"""Time and profile a train cell on the card as ``chip_smoke.py`` runs it,
through ``launch/steps.build_cell`` with seeded weights made on the card
and AdamW:

  - ``--arch mistral-nemo-12b`` (the default): train_4k as phase 10 runs
    it, full width, 8 of the 40 layers, 8 sequences of 4096 in 8
    microbatches, remat;
  - ``--arch schnet``: a SchNet cell as phase 11 runs it, at its
    published size (``--shape``, ogb_products by default: 2,449,056
    nodes, 61,859,328 edges, the filter network in chunks of 2^22 edges
    under checkpoint) on the seeded smoke batch.

    python -m repro_torch.launch.train_bench [--arch schnet] \
        [--shape ogb_products] [--steps 2] [--seed 0]

After a warm step it times ``--steps`` steps and the loss and gradients
alone (host s, synchronized; SchNet: also the batch's edge plans alone,
``models/schnet.edge_chunks``), then runs one step under torch.profiler
and sums its CUDA kernels' device time into the arch's groups (Mistral:
the attention backward and each of its kernels, the attention forward,
GEMMs; SchNet: ``gather_segment_sum`` and each of its kernels, GEMMs,
sorts, elementwise kernels) and the rest. The optimizer's share is a
step's host time less that of the loss and gradients. Prints one JSON
object, with the card's name and power limit. To compare two checkouts
in one run, copy this file into the other's ``src/repro_torch/launch/``
and run it there too, alternating the two."""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import time

import torch

from ..train.train_loop import grad_accum_value_and_grad
from .steps import build_cell, make_smoke_args

NEMO = "mistral-nemo-12b"
LAYERS = 8      # of 40, as chip_smoke.py's phase 10: one card's cut
BATCH = 8       # sequences of 4096 a step (of 256), one a microbatch
GEMM = ("gemm", ("gemm", "nvjet", "xmma", "cutlass"))
# an arch's groups: parts of a CUDA kernel's name -> its group in the
# step's split; the first group is also split by kernel (``KERNEL``)
GROUPS = {
    NEMO: (("attention_bwd", ("bwd_delta", "bwd_dkdv", "bwd_dq", "bwd_prep")),
           ("attention_fwd", ("fa_wgmma", "flash_attention_kernel")), GEMM),
    "schnet": (("gather_segment_sum", ("gss_",)), GEMM,
               ("sort", ("radix", "sort")),
               ("elementwise", ("elementwise",)))}
KERNEL = {NEMO: r"bwd_\w*kernel", "schnet": r"gss_\w+"}


def group(groups, kernel: str) -> str:
    name = kernel.lower()
    for g, parts in groups:
        if any(p in name for p in parts):
            return g
    return "other"


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def _nemo(dev, args):
    """(cell, params, opt state, batch, {unit: its count in the batch},
    {name: (module, its launch count)}, fields to print, {name: a call
    to time alone})."""
    from ..configs.mistral_nemo_12b import CONFIG
    from ..kernels.flash_attention import ops as fa

    cfg = dataclasses.replace(CONFIG, n_layers=LAYERS)
    cell = build_cell(NEMO, "train_4k", device=dev, model_cfg=cfg)
    params, opt_state, batch, _ = make_smoke_args(cell, seed=args.seed)
    batch = {k: v[:BATCH] for k, v in batch.items()}
    units = {"tokens": batch["tokens"].numel()}
    counters = {"attention_bwd_calls": (fa, "bwd_launches"),
                "on_wgmma": (fa, "bwd_tc_launches")}
    return (cell, params, opt_state, batch, units, counters,
            dict(layers=LAYERS, batch=BATCH), {})


def _schnet(dev, args):
    from ..kernels.segment_sum import ops as ss
    from ..models import schnet as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = build_cell("schnet", args.shape, device=dev)
    params, opt_state, batch, _ = make_smoke_args(cell, seed=args.seed)
    ei = batch["edge_index"]
    nodes = next(batch[k].shape[0] for k in ("node_feat", "atom_z")
                 if k in batch)
    extra = dict(shape=args.shape, nodes=nodes, edge_chunk=sm.EDGE_CHUNK)
    timers = {"plans_s": lambda: sm.edge_chunks(ei, nodes)}
    return (cell, params, opt_state, batch, {"edges": ei.shape[1]},
            {"segment_sum_calls": (ss, "launches"),
             "segment_sum_bwd_calls": (ss, "bwd_launches")}, extra, timers)


SETUP = {NEMO: _nemo, "schnet": _schnet}


def main(argv=None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(SETUP), default=NEMO)
    ap.add_argument("--shape", default="ogb_products",
                    help="SchNet's shape (Mistral runs train_4k)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    (cell, params, opt_state, batch, units, counters, extra,
     timers) = SETUP[args.arch](dev, args)
    state = {"params": params, "opt": opt_state, "step": 0}
    del params, opt_state

    def step():
        s = torch.tensor(state["step"], dtype=torch.int32, device=dev)
        state["params"], state["opt"], loss = cell.fn(
            state["params"], state["opt"], batch, s)
        state["step"] += 1
        return loss

    step()                                           # warm
    torch.cuda.reset_peak_memory_stats()
    steps = [timed(step)[1] for _ in range(args.steps)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    vg = grad_accum_value_and_grad(cell.loss, cell.accum)
    grads_s = timed(lambda: vg(state["params"], batch)[0])[1]
    extra.update({k: timed(fn)[1] for k, fn in timers.items()})
    before = {k: getattr(m, a) for k, (m, a) in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(step)
    groups = GROUPS[args.arch]
    split = {g: 0.0 for g, _ in groups}
    split["other"] = 0.0
    first = {}                         # the first group's kernels by name, ms
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            g = group(groups, e.key)
            ms = e.self_device_time_total / 1e3
            split[g] += ms
            if g == groups[0][0]:
                name = re.search(KERNEL[args.arch], e.key).group(0)
                first[name] = first.get(name, 0.0) + ms
    busy = sum(split.values())
    step_s = statistics.median(steps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    out = dict(card=card, arch=args.arch, **extra, accum=cell.accum,
               step_s=steps,
               **{f"{u}_per_s": n / step_s for u, n in units.items()},
               peak_gb=peak, grads_s=grads_s, optimizer_s=step_s - grads_s,
               profiled=dict(host_ms=wall * 1e3, device_busy_ms=busy,
                             idle_share=1 - busy / (wall * 1e3),
                             split_ms=split,
                             **{f"{groups[0][0]}_ms": first},
                             **{k: getattr(m, a) - before[k]
                                for k, (m, a) in counters.items()}))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
