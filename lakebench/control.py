"""The controls of a cell's correctness check: the reference put in the
program's place at the nearest precision below the configuration's
(TF32 for an fp32 scan or rescore, an int4 pool for the int8 hot tier;
each check's ``CONTROLS``), at the cell's own size and traffic, on
several seeds. Each has to fail one of the cell's limits; the limits
were set between the controls' numbers and the program's own readings.

    python3 -m lakebench.control --workload <name> --seeds 11 12 13

prints one JSON line a seed and control with its numbers beside the
limits. It needs no store: only the generated history and requests.
"""
from __future__ import annotations

import argparse
import json
import sys

from .run import ROOT, Cell, Sample, card


def control_numbers(cell: Cell, seed: int, dev, control: str) -> dict:
    import torch

    from . import generator
    from .checks import load_check

    cfg, mix = cell.config, cell.mix
    hist = generator.make_history(cfg, seed, dev)
    rows = hist.emb.cpu().numpy()
    traffic = generator.Traffic(mix, hist.instants, seed)
    samples = [Sample(*traffic.next(), None)
               for _ in range(int(mix["check_sample"]))]
    check = load_check(cell.limits["check"])
    ctx = check.context(hist, torch.as_tensor(rows, device=dev), rows, cfg,
                        mix)
    nums = check.numbers(ctx, samples, control=control)
    return {name: {"value": nums[name], "limit": float(lim)}
            for name, lim in cell.limits["limits"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    cell = Cell.load(args.workload)
    dev = card(torch, int(cell.entry["chips"]))
    sys.path.insert(0, str(ROOT / "src"))
    from .checks import load_check

    for control in load_check(cell.limits["check"]).CONTROLS:
        for seed in args.seeds:
            nums = control_numbers(cell, seed, dev, control)
            failed = [n for n, v in nums.items() if v["value"] > v["limit"]]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control, "fails": failed,
                              "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
