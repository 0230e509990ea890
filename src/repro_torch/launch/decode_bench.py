"""Time the RAG generator on the card: Mistral-NeMo-12B at full width
(``configs/mistral_nemo_12b``, 24.5 GB of seeded bf16 weights made on
the card), a prefill of a 256-token prompt into the engine's 320-entry
cache, then single-token decode steps (batch 1), as ``RAGEngine``
answers a request.

    python -m repro_torch.launch.decode_bench [--steps 48] [--seed 0]

Prints one JSON object: the card's name and power limit, host ms of
each of three prefills and of each decode step (synchronized after
each), their medians, and the attention kernels' library calls a step.
To compare two checkouts in one run, copy this file into the other's
``src/repro_torch/launch/`` and run it there too, alternating the two."""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..configs.mistral_nemo_12b import CONFIG
from ..kernels.flash_attention import ops as fa
from ..kernels.flash_decode import ops as fd
from ..models.transformer import decode_step, init_params, prefill

PROMPT = 256
CACHE = PROMPT + 64            # RAGEngine's cache at max_prompt 256


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.steps > CACHE - PROMPT:
        ap.error(f"--steps must be at most {CACHE - PROMPT}")
    params = init_params(CONFIG, seed=args.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    toks = torch.randint(4, CONFIG.vocab, (1, PROMPT), generator=gen,
                         device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        pre = []
        for _ in range(3):
            (logits, cache, n), ms = timed(
                lambda: prefill(params, toks, CONFIG, CACHE))
            pre.append(ms)
        cur = logits.argmax(-1)[:, None]
        steps = []
        fd0, fa0 = fd.launches, fa.launches
        for _ in range(args.steps):
            (logits, cache, n), ms = timed(
                lambda: decode_step(params, cur, cache, n, CONFIG))
            cur = logits.argmax(-1)[:, None]
            steps.append(ms)
        calls = (fd.launches - fd0) / args.steps
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"card": card, "prompt": PROMPT, "cache": CACHE,
           "prefill_ms": pre, "prefill_ms_median": sorted(pre)[1],
           "decode_step_ms": steps,
           "decode_step_ms_median": sorted(steps)[len(steps) // 2],
           "flash_decode_calls_a_step": calls,
           "flash_attention_calls_in_steps": fa.launches - fa0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
