"""Time the four top-k scans on the card through their public wrappers,
at the shapes of ``chip_smoke.py`` phase 2: the hot tier's fused block
(N = 8192 unit rows, 70% alive, D = 384) and a resident history of 2^20
rows (every row in window), at Q = 2, 32 and 256, on the list path (k =
10; int8 pool k' = 40) and the select path (k = 500).

    python -m repro_torch.launch.scan_bench [--iters 20] [--seed 0]

Prints one JSON object: the card's name and power limit and, per (scan,
Q, N, k), the mean ms of a call between CUDA events over ``--iters``
calls after a warm-up (at N = 8192 the calls are host-bound: the events
then time the host's enqueue), and ``device_ms``: the device time of a
call's kernels (the scan's and the torch ops around it), summed by
torch.profiler over another ``--iters`` calls (null where the trace
holds no kernel). The data is made on the card from the seed, so two
checkouts time the same inputs. To compare two checkouts, copy this
file into the other's ``src/repro_torch/launch/`` and run it there too,
alternating the two."""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..kernels.temporal_mask_score import ops as tops
from ..kernels.topk_search import ops as kops

D = 384


def _ms(fn, iters: int) -> float:
    for _ in range(2):
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


def _device_ms(fn, iters: int) -> float | None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sum(kern) / 1e3 / iters if kern else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def unit(n):
        x = torch.randn((n, D), generator=gen, device="cuda")
        return x / x.norm(dim=1, keepdim=True)

    scale = torch.full((D,), 1 / 127, device="cuda")

    def q8(x):
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)

    rows = []

    def time_all(n, calls):
        for nq in (2, 32, 256):
            q = unit(nq)
            for name, k, fn in calls(q, nq):
                iters = max(1, args.iters // (4 if nq == 256 else 1))
                rows.append(dict(
                    scan=name, Q=nq, N=n, k=k,
                    ms=_ms(lambda: fn(q, k), iters),
                    device_ms=_device_ms(lambda: fn(q, k), iters)))

    n = 8192
    c = unit(n)
    c8 = q8(c)
    alive = torch.rand(n, generator=gen, device="cuda") < 0.7
    time_all(n, lambda q, nq: [
        ("topk_search", k, lambda q, k: kops.topk_search(q, c, alive, k))
        for k in (10, 500)] + [
        ("topk_search_q8", k,
         lambda q, k: kops.topk_search_q8(q, c8, scale, alive, k))
        for k in (40, 500)])
    n = 1 << 20
    c = unit(n)
    c8 = q8(c)
    vf = torch.zeros(n, dtype=torch.int64, device="cuda")
    vt = torch.full((n,), 1 << 62, dtype=torch.int64, device="cuda")
    time_all(n, lambda q, nq: [
        ("temporal_window_topk", k,
         lambda q, k: tops.temporal_window_topk(q, c, vf, vt, 1, 2, k))
        for k in (10, 500)] + [
        ("temporal_window_topk_q8", k,
         lambda q, k: tops.temporal_window_topk_q8(q, c8, scale, vf, vt, 1,
                                                   2, k))
        for k in (40, 500)])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    res = {"card": card, "rows": rows}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
