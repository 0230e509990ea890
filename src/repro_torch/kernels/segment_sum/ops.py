"""Wrapper of the gather-segment-sum kernels (csrc/segment_sum.cu):
SchNet's message passing, its energy readout and the gradient of its atom
embedding, summed in a fixed order with no atomics.

``gather_segment_sum(x, src, dst, n_out, w)`` is differentiable: its
backward (``segment_sum_bwd``) is one kernel over the plan's src order
that gives the gradients of x and of w together (dx summed in a fixed
order; dw[e] = x[src[e]] * g[dst[e]] from the rows it gathers for dx).
``take(table, ids)`` is a row gather (``jnp.take``) whose gradient is
this kernel over the ids: SchNet's atom embedding and the recsys
lookups (``models/recsys.lookup``) add their rows' gradients with it, in
a fixed order, where ``index_select``'s backward adds them with atomics
on the card. A CPU tensor runs the plain versions
(``plain.segment_sum_plain``, ``plain.segment_sum_bwd_plain``), a CUDA
tensor launches the kernels or raises; both compute the same terms in
the same order, so they agree bit for bit."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import (EdgePlan, segment_sum_bwd_plain, segment_sum_plain,
                    take_rows)

launches = 0          # calls of the forward entry (two launches each)
bwd_launches = 0      # calls of the backward entry (one or two launches)
GAP_FILL = 64         # the backward zeroes dx's unreached rows itself
                      # where no run of them is longer

_entry = None


def _lib():
    """(library, ``gather_segment_sum_fwd``, ``gather_segment_sum_bwd``),
    built, loaded and declared once."""
    global _entry
    if _entry is None:
        lib = build.load("segment_sum")
        p, n = ctypes.c_void_p, ctypes.c_longlong
        fn = lib.gather_segment_sum_fwd
        fn.argtypes = [p, n] + [p] * 7 + [n] + [p] * 3 + [n] + [p] * 3
        fn.restype = ctypes.c_int
        bwd = lib.gather_segment_sum_bwd
        bwd.argtypes = ([p] * 3 + [n] + [p] * 6 + [n, n] + [p] * 3 + [n]
                        + [p] * 2 + [n, ctypes.c_int, p, n] + [p] * 4)
        bwd.restype = ctypes.c_int
        _entry = (lib, fn, bwd)
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
    dev = x.device
    d = x.shape[-1]
    _check("x", x, order["n_x"], d, dev)
    if w is not None:
        _check("w", w, order["n_edges"], d, dev)
    n_out = order["n_out"]
    slots = len(order["edge"])
    with obs.kernel_span("kernel:gather_segment_sum", dev) as sp:
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
        lib, fn, _ = _lib()
        with sp.launch():
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
        return out


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def segment_sum_bwd(x: torch.Tensor | None, g: torch.Tensor,
                    w: torch.Tensor | None, plan: EdgePlan,
                    dx: bool = True, dw: bool = True) -> tuple:
    """Both gradients of ``segment_sum(x, w, plan.fwd)`` against the
    cotangent ``g`` (plan.n_out, D) fp32: (dx (plan.n_src, D), dw (E, D)),
    None where not asked for (``dx``, ``dw``) and dw None without w; x is
    read only for dw. A CPU g runs ``segment_sum_bwd_plain``; a CUDA g
    launches the kernel once (one pass over ``plan.bwd``, then the rows
    of several chunks; no atomics)."""
    global bwd_launches
    dw = dw and w is not None
    if not (dx or dw):
        return None, None
    order = plan.bwd
    dev = g.device
    d = g.shape[-1]
    _check("g", g, order["n_x"], d, dev)
    if w is not None:
        _check("w", w, order["n_edges"], d, dev)
    if dw:
        _check("x", x, order["n_out"], d, dev)
    n_rows, e = order["n_out"], order["n_edges"]
    slots = len(order["edge"])
    with obs.kernel_span("kernel:gather_segment_sum_bwd", dev) as sp:
        sp.add("rows", slots)
        sp.add("bytes", slots * (d * 4 * (int(dx) * (w is not None)
                                          + int(dw) + 1) + 8)
               + (n_rows * d * 4 if dx else 0)
               + (len(order["start"]) * d * 4 if dw else 0))
        if dev.type == "cpu":
            return segment_sum_bwd_plain(x, g, w, plan, dx, dw)
        if dev.type != "cuda":
            raise ValueError(f"gather_segment_sum runs on cpu or cuda, not "
                             f"{dev}")
        if order["edge"].device != dev:
            raise ValueError(f"gather_segment_sum: the plan on "
                             f"{order['edge'].device}, g on {dev}")
        g = g.contiguous()
        w = None if w is None else w.contiguous()
        x = x.contiguous() if dw else None
        chunks = len(order["start"])
        fill = chunks > 0 and order["gap"] <= GAP_FILL
        f32 = dict(dtype=torch.float32, device=dev)
        gx = gw = partial = None
        if dx:
            gx = (torch.empty if fill else torch.zeros)((n_rows, d), **f32)
            partial = torch.empty((order["parts"], d), **f32)
        skip = plan.skip if dw else None
        if dw:
            gw = torch.empty((e, d), **f32)
        lib, _, fn = _lib()
        with sp.launch():
            err = _call(dev, fn, _ptr(x), g.data_ptr(), _ptr(w), d,
                        order["gather"].data_ptr(), order["edge"].data_ptr(),
                        order["start"].data_ptr(), order["count"].data_ptr(),
                        order["key"].data_ptr(), order["part"].data_ptr(),
                        chunks, order["longest"], order["mfirst"].data_ptr(),
                        order["mcount"].data_ptr(), order["mkey"].data_ptr(),
                        len(order["mkey"]), _ptr(partial), _ptr(gx), n_rows,
                        int(fill), _ptr(skip),
                        0 if skip is None else len(skip),
                        plan.src.data_ptr(), plan.dst.data_ptr(), _ptr(gw))
        check(lib, err, "gather_segment_sum_bwd")
        bwd_launches += 1
        return gx, gw


class _GatherSegmentSum(torch.autograd.Function):
    """The forward over ``plan.fwd``; both gradients by ``segment_sum_bwd``
    over ``plan.bwd`` (the cotangent's rows gathered by dst: summed into
    rows src for x, times x[src] for w), each only if asked for."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, w)
        return segment_sum(x, w, plan.fwd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = segment_sum_bwd(x, g.contiguous(), w, ctx.plan,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
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


class _Take(torch.autograd.Function):
    """``jnp.take(table, ids, axis=0)`` of a (V, D) fp32 table and flat
    ids (already wrapped: -1 marks a NaN row); its gradient adds each
    id's cotangent into its row through the kernel (an id out of range
    adds to no row), summed in the plan's fixed order."""

    @staticmethod
    def forward(ctx, table, z):
        ctx.save_for_backward(z)
        ctx.v = table.shape[0]
        return take_rows(table, z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        src = torch.arange(z.shape[0], device=z.device)
        return gather_segment_sum(g.contiguous(), src, z, ctx.v), None


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows of a (V,) or (V, D) fp32
    ``table`` for ``ids`` of any shape, (*ids.shape, *table.shape[1:]).
    An id in [-V, -1] reads row id + V, any other id outside [0, V) a row
    of NaN. Differentiable in ``table``: its gradient is
    ``gather_segment_sum`` of the cotangent's rows into the ids' rows,
    with no atomics (a CUDA table launches the kernel, a CPU one its
    plain version)."""
    v = table.shape[0]
    z = ids.reshape(-1).long()
    z = torch.where(z < 0, z + v, z)
    z = torch.where((z >= 0) & (z < v), z, -1)
    rows = _Take.apply(table.reshape(v, -1), z)
    return rows.reshape(*ids.shape, *table.shape[1:])
