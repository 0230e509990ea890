"""Time and profile Mistral-NeMo-12B train_4k on the card as
``chip_smoke.py`` phase 10 runs it: full width, 8 of the 40 layers, 8
sequences of 4096 in 8 microbatches, AdamW, remat, seeded weights made
on the card, through ``launch/steps.build_cell``.

    python -m repro_torch.launch.train_bench [--steps 2] [--seed 0]

After a warm step it times ``--steps`` steps and the loss and gradients
alone (host s, synchronized), then runs one step under torch.profiler
and sums its CUDA kernels' device time into the attention backward (and
each of its kernels), the attention forward, GEMMs and the rest. The
optimizer's share is a step's host time less that of the loss and
gradients. Prints one JSON object, with the card's name and power limit.
To compare two checkouts in one run, copy this file into the other's
``src/repro_torch/launch/`` and run it there too, alternating the two;
in a checkout from before the tensor-core backward (no
``fa.bwd_tc_launches``), drop ``on_wgmma`` and the line that sets
``tc0``."""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import time

import torch

from ..configs.mistral_nemo_12b import CONFIG
from ..kernels.flash_attention import ops as fa
from ..models import transformer as tfm
from ..models.bridge import train_tree
from ..train.train_loop import grad_accum_value_and_grad
from .steps import build_cell, make_smoke_args

ARCH = "mistral-nemo-12b"
LAYERS = 8      # of 40, as chip_smoke.py's phase 10: one card's cut
BATCH = 8       # sequences of 4096 a step (of 256), one a microbatch
# parts of a CUDA kernel's name -> its group in the step's split
GROUPS = (("attention_bwd", ("bwd_delta", "bwd_dkdv", "bwd_dq", "bwd_prep")),
          ("attention_fwd", ("fa_wgmma", "flash_attention_kernel")),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def group(kernel: str) -> str:
    name = kernel.lower()
    for g, parts in GROUPS:
        if any(p in name for p in parts):
            return g
    return "other"


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def main(argv=None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(CONFIG, n_layers=LAYERS)
    cell = build_cell(ARCH, "train_4k", device=dev, model_cfg=cfg)
    params = train_tree(tfm.init_params(cfg, seed=args.seed, device=dev))
    params, opt_state, batch, _ = make_smoke_args(cell, seed=args.seed,
                                                  params=params)
    batch = {k: v[:BATCH] for k, v in batch.items()}
    state = {"params": params, "opt": opt_state, "step": 0}
    del params, opt_state

    def step():
        s = torch.tensor(state["step"], dtype=torch.int32, device=dev)
        state["params"], state["opt"], loss = cell.fn(
            state["params"], state["opt"], batch, s)
        state["step"] += 1
        return loss

    step()                                           # warm
    steps = [timed(step)[1] for _ in range(args.steps)]
    vg = grad_accum_value_and_grad(cell.loss, cell.accum)
    grads_s = timed(lambda: vg(state["params"], batch)[0])[1]
    b0 = fa.bwd_launches
    tc0 = fa.bwd_tc_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(step)
    split = {g: 0.0 for g, _ in GROUPS}
    split["other"] = 0.0
    attention_bwd = {}                 # its kernels by name, ms
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            g = group(e.key)
            ms = e.self_device_time_total / 1e3
            split[g] += ms
            if g == "attention_bwd":
                name = re.search(r"bwd_\w*kernel", e.key).group(0)
                attention_bwd[name] = attention_bwd.get(name, 0.0) + ms
    busy = sum(split.values())
    step_s = statistics.median(steps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    out = dict(card=card, layers=LAYERS, batch=BATCH,
               accum=cell.accum, step_s=steps,
               tokens_per_s=batch["tokens"].numel() / step_s,
               grads_s=grads_s, optimizer_s=step_s - grads_s,
               profiled=dict(host_ms=wall * 1e3, device_busy_ms=busy,
                             idle_share=1 - busy / (wall * 1e3),
                             split_ms=split,
                             attention_bwd_ms=attention_bwd,
                             attention_bwd_calls=fa.bwd_launches - b0,
                             on_wgmma=fa.bwd_tc_launches - tc0))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
