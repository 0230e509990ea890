"""Time DLRM serving on the card: MLPerf widths over the one-card tables
(``configs/dlrm_mlperf.ONE_CARD``, 58.3 GB fp32, seeded), through
``launch/steps.build_cell``'s serve function, at ``serve_p99`` (batch
512) or another recsys serve shape.

    python -m repro_torch.launch.recsys_bench [--shape serve_p99]
        [--reps 200] [--seed 0]

Prints one JSON object: the card's name and power limit, host ms a
batch (synchronized, median and quartiles), device ms a batch between
CUDA events over back-to-back batches, samples/s, the bags of a
forward as DLRM calls them (one grouped call over the 26 tables into
the feature stack) with their launches, and the one-table bag alone
(one field of the (B, 26, 1) ids, no weights; and contiguous ids with
explicit unit weights), each in ms a call between CUDA events. Ids are
drawn over each table, as a serving caller's are. To compare two
checkouts in one run, run each checkout's own ``recsys_bench``,
alternating the two: the host and device keys are common to both."""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..configs.dlrm_mlperf import ONE_CARD
from ..kernels.embedding_bag import ops as eb
from ..kernels.embedding_bag.ops import embedding_bag
from ..models.recsys import dlrm_init
from .steps import build_cell


def cuda_ms(fn, reps: int) -> float:
    """ms a call between CUDA events over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="serve_p99")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    cfg = ONE_CARD
    params = dlrm_init(cfg, seed=args.seed, device=dev)
    bundle = build_cell("dlrm-mlperf", args.shape, device=dev)
    b = bundle.arg_specs[1]["dense"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batches = [{
        "dense": torch.rand((b, cfg.n_dense), generator=gen, device=dev),
        "sparse_ids": torch.stack([
            torch.randint(0, v, (b,), generator=gen, device=dev,
                          dtype=torch.int32) for v in cfg.table_sizes],
            dim=1)[..., None]} for _ in range(20)]
    turn = {"i": 0}

    def nxt() -> dict:
        turn["i"] = (turn["i"] + 1) % len(batches)
        return batches[turn["i"]]

    with torch.no_grad():
        host = []
        for _ in range(args.reps):
            x = nxt()
            torch.cuda.synchronize()
            t = time.perf_counter()
            bundle.fn(params, x)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        dev_ms = cuda_ms(lambda: bundle.fn(params, nxt()), args.reps)
    host.sort()
    tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
    feats = torch.empty((b, cfg.n_sparse + 1, cfg.embed_dim), device=dev)

    def bags():
        eb.embedding_bag_grouped(tables, nxt()["sparse_ids"], None, "sum",
                                 out=feats[:, 1:])

    before = eb.launches
    bags()
    launches = eb.launches - before
    bags_ms = cuda_ms(bags, args.reps)
    table = tables[0]
    ones = torch.ones((b, 1), device=dev)
    for x in batches:
        x["flat"] = x["sparse_ids"][:, 0].contiguous()
    field = cuda_ms(lambda: embedding_bag(table, nxt()["sparse_ids"][:, 0]),
                    args.reps)
    explicit = cuda_ms(lambda: embedding_bag(table, nxt()["flat"], ones),
                       args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    q = len(host) // 4
    out = {"card": card, "shape": args.shape, "batch": b,
           "reps": args.reps, "host_ms_median": host[len(host) // 2],
           "host_ms_q1": host[q], "host_ms_q3": host[3 * q],
           "device_ms": dev_ms, "samples_per_s": b / dev_ms * 1e3,
           "bags_ms": bags_ms, "bag_launches_per_forward": launches,
           "bag_field_no_weights_ms": field,
           "bag_contiguous_unit_weights_ms": explicit}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
