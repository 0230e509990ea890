"""Training launcher of the port (repro's ``launch/train.py`` in PyTorch).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \
      --shape train_4k --reduced --steps 20 --device cpu \
      [--checkpoint-dir DIR [--resume]] [--compress-grads]

Builds the cell with ``launch/steps.build_cell`` (``--reduced``: the
small config of the same family, as the CPU tests run it; without it the
full widths, which need the card), makes seeded params and a fresh
synthetic batch each step (``steps.smoke_batch``, seed = step), and runs
the cell's step: loss, gradients (accumulated over the cell's
microbatches) and the optimizer's in-place update. ``--device`` is where
it runs (default: the card). It prints the loss every 5 steps and, last,
repro's closing JSON line.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradients with error feedback between the "
                         "backward and the optimizer")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the card)")
    args = ap.parse_args(argv)

    from ..launch.steps import (build_cell, grad_accum_value_and_grad,
                                make_smoke_args, smoke_batch)
    from ..train import grad_compress
    from ..train.checkpoint import CheckpointManager
    from ..train.optimizer import get_optimizer

    bundle = build_cell(args.arch, args.shape, reduced=args.reduced,
                        device=args.device)
    if bundle.kind != "train":
        raise SystemExit(f"{args.arch}/{args.shape} is a {bundle.kind} "
                         f"cell: use a train shape")
    params, opt_state, _, _ = make_smoke_args(bundle)
    step_fn = bundle.fn
    if args.compress_grads:
        opt = get_optimizer(bundle.optimizer)
        vg = grad_accum_value_and_grad(bundle.loss, bundle.accum)
        ef = {"state": grad_compress.init_state(params)}

        def step_fn(params, opt_state, batch, step):
            loss, grads = vg(params, batch)
            grads, ef["state"] = grad_compress.compress_decompress(
                grads, ef["state"])
            params, opt_state = opt.update(grads, opt_state, params, step)
            return params, opt_state, loss

    ckpt = CheckpointManager(args.checkpoint_dir) \
        if args.checkpoint_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        tree, start, _ = ckpt.restore({"params": params,
                                       "opt_state": opt_state})
        params, opt_state = tree["params"], tree["opt_state"]
        print(f"resumed from step {start}")

    losses = []
    for i in range(start, start + args.steps):
        batch = smoke_batch(bundle, seed=i)        # a fresh batch a step
        params, opt_state, loss = step_fn(params, opt_state, batch, i)
        losses.append(float(loss))
        if i % 5 == 0 or i == start + args.steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f}")
        if ckpt and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(i + 1, {"params": params, "opt_state": opt_state})
    if ckpt:
        ckpt.wait()
    out = {"first_loss": losses[0], "last_loss": losses[-1],
           "improved": losses[-1] < losses[0]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
