"""Wrapper of the gather-segment-sum kernel (csrc/segment_sum.cu):
SchNet's message passing, its energy readout and the gradient of its atom
embedding, summed in a fixed order with no atomics.

``gather_segment_sum(x, src, dst, n_out, w)`` is differentiable: the
gradient of x is the same kernel over the plan's src order, the gradient
of w two forward gathers and a product (``plain.weight_grad``). A CPU
tensor runs the plain version (``plain.segment_sum_plain``), a CUDA
tensor launches the kernel or raises; both sum the same terms in the same
order, so they agree bit for bit."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import EdgePlan, segment_sum_plain, weight_grad

launches = 0          # calls of the CUDA entry (two launches each)

_entry = None


def _lib():
    """(library, ``gather_segment_sum_fwd``), built, loaded and declared
    once."""
    global _entry
    if _entry is None:
        lib = build.load("segment_sum")
        fn = lib.gather_segment_sum_fwd
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _entry = (lib, fn)
    return _entry


def _call(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``dev``."""
    idx = dev.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)


def _check(name: str, t: torch.Tensor, rows: int, d: int,
           dev: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"gather_segment_sum: {name} must be float32 "
                        f"(SchNet's dtype), not {t.dtype}")
    if t.shape != (rows, d):
        raise ValueError(f"gather_segment_sum: {name} is "
                         f"{tuple(t.shape)}, the plan wants ({rows}, {d})")
    if t.device != dev:
        raise ValueError(f"gather_segment_sum: {name} on {t.device}, x on "
                         f"{dev}")


def segment_sum(x: torch.Tensor, w: torch.Tensor | None,
                order: dict) -> torch.Tensor:
    """The sums of one order of an ``EdgePlan`` (``plan.fwd`` or
    ``plan.bwd``) over x (n_x, D) fp32 and w (n_edges, D) fp32 or None:
    (n_out, D) fp32, the sizes the order was made for. A CPU x runs
    ``segment_sum_plain``; a CUDA x launches the kernel once (two
    launches, no atomics)."""
    global launches
    with obs.span("kernel:gather_segment_sum") as sp:
        dev = x.device
        d = x.shape[-1]
        _check("x", x, order["n_x"], d, dev)
        if w is not None:
            _check("w", w, order["n_edges"], d, dev)
        n_out = order["n_out"]
        slots = len(order["edge"])
        sp.add("rows", slots)
        sp.add("bytes", slots * (d * 4 * (1 if w is None else 2) + 8)
               + n_out * d * 4)
        if dev.type == "cpu":
            return segment_sum_plain(x, w, order)
        if dev.type != "cuda":
            raise ValueError(f"gather_segment_sum runs on cpu or cuda, not "
                             f"{dev}")
        if order["edge"].device != dev:
            raise ValueError(f"gather_segment_sum: the plan on "
                             f"{order['edge'].device}, x on {dev}")
        x = x.contiguous()
        w = None if w is None else w.contiguous()
        out = torch.zeros((n_out, d), dtype=torch.float32, device=dev)
        partial = torch.empty((order["parts"], d), dtype=torch.float32,
                              device=dev)
        lib, fn = _lib()
        err = _call(dev, fn, x.data_ptr(), d, order["gather"].data_ptr(),
                    None if w is None else w.data_ptr(),
                    order["edge"].data_ptr(), order["start"].data_ptr(),
                    order["count"].data_ptr(), order["key"].data_ptr(),
                    order["part"].data_ptr(), len(order["start"]),
                    order["mfirst"].data_ptr(), order["mcount"].data_ptr(),
                    order["mkey"].data_ptr(), len(order["mkey"]),
                    partial.data_ptr(), out.data_ptr())
        check(lib, err, "gather_segment_sum_fwd")
        launches += 1
        if sp is not obs.NOOP_SPAN:            # traced: span = device time
            torch.cuda.current_stream(dev).synchronize()
        return out


class _GatherSegmentSum(torch.autograd.Function):
    """The forward over ``plan.fwd``; the gradient of x over ``plan.bwd``
    (the cotangent's rows gathered by dst, summed into rows src), that of
    w by ``weight_grad``."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, w)
        return segment_sum(x, w, plan.fwd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = segment_sum(g, w, plan.bwd)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, g, plan)
        return dx, dw, None


def gather_segment_sum(x: torch.Tensor, src: torch.Tensor | None,
                       dst: torch.Tensor | None, n_out: int,
                       w: torch.Tensor | None = None,
                       plan: EdgePlan | None = None) -> torch.Tensor:
    """out[d] = sum over edges e with dst[e] = d of x[src[e]] * w[e]: x (N,
    D) fp32, src and dst (E,) int, w (E, D) fp32 or None (ones). Returns
    (n_out, D) fp32. repro's semantics: a src in [-N, -1] reads row src +
    N and any other src outside [0, N) a row of NaN (``jnp.take``); a dst
    outside [0, n_out) is dropped (``jax.ops.segment_sum``); a row no edge
    reaches is 0. ``plan``, an ``EdgePlan(src, dst, N, n_out)`` made once
    a batch, replaces src and dst (pass None for them). Differentiable in
    x and w. A CPU x runs the plain version, a CUDA x the kernel; the
    same sums in the same order either way."""
    if plan is None:
        plan = EdgePlan(src, dst, x.shape[0], n_out)
    elif (plan.n_src, plan.n_out) != (x.shape[0], n_out):
        raise ValueError(f"gather_segment_sum: a plan for {plan.n_src} -> "
                         f"{plan.n_out} rows, called for {x.shape[0]} -> "
                         f"{n_out}")
    return _GatherSegmentSum.apply(x, w, plan)
