"""Time the fp32 attention bodies on the card (3xTF32 on the tensor
cores): ``flash_attention`` at BERT4Rec's serve_p99 shape (512, 2, 2,
200, 200, 32) and MiniLM's encode chunk (256, 12, 12, 128, 128, 32), and
``flash_attention_bwd`` at BERT4Rec's train microbatch (256, 2, 2, 200,
200, 32), all bidirectional, against SDPA and SDPA's backward on the
same inputs.

    python -m repro_torch.launch.attention_bench [--reps 50] [--seed 0]

Prints one JSON object: the card's name and power limit; for each shape
the kernel's and the library's ms a call between CUDA events over
back-to-back calls, the bound (the larger of the bytes over 3.35 TB/s
and 3 x the FLOPs over 495 TFLOP/s of TF32, as the 3xTF32 route takes
three tensor-core products for each fp32 one) and the kernel's share of
it; and the backward's device time by kernel (torch.profiler). To
compare two checkouts, run each checkout's own copy in turns."""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fa

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, data sheet
TF32_FLOPS = 495e12             # H100 SXM tf32 dense, data sheet
SHAPES = {"bert4rec serve_p99": (512, 2, 2, 200, 200, 32),
          "minilm encode": (256, 12, 12, 128, 128, 32)}
TRAIN = ("bert4rec train", (256, 2, 2, 200, 200, 32))


def cuda_ms(fn, reps: int) -> float:
    """ms a call between CUDA events over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, flops: int) -> float:
    """The least ms: bytes at 3.35 TB/s or 3 x FLOPs at 495 TFLOP/s."""
    return max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    for what, (b, h, kv, sq, skv, d) in SHAPES.items():
        q, k, v = randn(b, h, sq, d), randn(b, kv, skv, d), randn(b, kv, skv,
                                                                   d)
        before = fa.tf32_launches
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, False), args.reps)
        assert fa.tf32_launches > before, "the 3xTF32 body did not run"
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                      args.reps)
        bound = bound_ms((2 * b * h * sq + 2 * b * kv * skv) * d * 4,
                         4 * b * h * sq * skv * d)
        out[what] = dict(ms=ms, library_ms=lib, bound_ms=bound,
                         bound_share=bound / ms)
        del q, k, v
    what, (b, h, kv, sq, skv, d) = TRAIN
    q, k, v, do = (randn(b, h, sq, d), randn(b, kv, skv, d),
                   randn(b, kv, skv, d), randn(b, h, sq, d))
    o, lse = fa.flash_attention_with_lse(q, k, v, False)
    before = fa.bwd_tf32_launches
    ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, False),
                 args.reps)
    assert fa.bwd_tf32_launches > before, "the 3xTF32 body did not run"
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = F.scaled_dot_product_attention(*leaves)
    lib = cuda_ms(lambda: torch.autograd.grad(y, leaves, do,
                                              retain_graph=True), args.reps)
    bound = bound_ms((4 * b * h * sq + 4 * b * kv * skv) * d * 4
                     + b * h * sq * 4, 10 * b * h * sq * skv * d)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fa.flash_attention_bwd(q, k, v, o, do, lse, False)
        torch.cuda.synchronize()
    kernels = {e.key.split("::")[-1].split("(")[0]:
               e.self_device_time_total / e.count / 1e3
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and "bwd_tf32" in e.key}
    out[what] = dict(ms=ms, library_ms=lib, bound_ms=bound,
                     bound_share=bound / ms, kernel_ms=kernels)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
