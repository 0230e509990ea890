"""Wrappers of the embedding-bag kernels (csrc/embedding_bag.cu): the
sparse-feature lookup of DLRM and its backward. ``embedding_bag_grouped``
covers a group of tables (DLRM's 26 fields) in one launch;
``embedding_bag`` is the one-table call behind repro's API, the same
kernel body with F = 1. Both are differentiable: where autograd records
and a table (or the weights, or ``out``) requires grad, the backward is
``embedding_bag_grouped_bwd``, one call over the group (the backward
kernel on the card)."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import (bag_segments, embedding_bag_backward_plain,
                    embedding_bag_grouped_plain, embedding_bag_plain,
                    embedding_bag_weights_grad_plain)

launches = 0          # CUDA kernel launches of either forward wrapper
bwd_launches = 0      # CUDA calls of ``embedding_bag_grouped_bwd``

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COMBINERS = {"sum": 0, "mean": 1}
MAX_TABLES = 64       # csrc BAG_MAX_TABLES: the group rides in the params


class _Table(ctypes.Structure):
    """csrc ``BagTable``: one table of a group."""
    _fields_ = [("data", ctypes.c_void_p), ("rows", ctypes.c_longlong)]


_entries = None
_groups: dict = {}    # (data_ptr, shape, stride, dtype) a table -> group


def _lib():
    """(library, ``embedding_bag_fwd``, ``embedding_bag_grouped_fwd``),
    built, loaded and declared once."""
    global _entries
    if _entries is None:
        lib = build.load("embedding_bag")
        one = lib.embedding_bag_fwd
        one.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                        + [ctypes.c_longlong] * 6
                        + [ctypes.c_int, ctypes.c_void_p])
        one.restype = ctypes.c_int
        grp = lib.embedding_bag_grouped_fwd
        grp.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                        + [ctypes.c_longlong] * 9
                        + [ctypes.c_int, ctypes.c_void_p])
        grp.restype = ctypes.c_int
        bwd = lib.embedding_bag_grouped_bwd
        bwd.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 6
                        + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                        + [ctypes.c_longlong] + [ctypes.c_void_p] * 3)
        bwd.restype = ctypes.c_int
        _entries = (lib, one, grp, bwd)
    return _entries


def _call(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``dev``, made the
    current device only where it is not already."""
    idx = dev.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)


def _on(name: str, x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``dev``: arrays and lists are moved
    there, a tensor on another device is an error."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(x, device=dev).to(dtype)
    if x.device != dev:
        raise ValueError(f"embedding_bag: {name} on {x.device}, the table "
                         f"on {dev}")
    return x.to(dtype)


def _row_stride(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` (B, L) with its slots contiguous, and its row stride: a
    strided row view (one field of a (B, F, L) tensor) goes as it lies,
    anything else is copied."""
    if x.shape[1] > 1 and x.stride(1) != 1:
        x = x.contiguous()
    return x, (x.stride(0) if x.shape[0] > 1 else x.shape[1])


def _slots(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """``x`` (B, F, L) with its slots contiguous, and its (b, f) strides:
    a strided view goes as it lies, anything else is copied."""
    if x.shape[2] > 1 and x.stride(2) != 1:
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


def _check_table(table) -> None:
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"table: expected a torch.Tensor, got "
                        f"{type(table)}")
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise TypeError(f"embedding_bag: table must be 2-d in "
                        f"{list(DTYPES)}, got {tuple(table.shape)} "
                        f"{table.dtype}")


def _check_group(tables) -> None:
    """Raise unless ``tables`` are 1 to MAX_TABLES 2-d tables of one
    dtype, one width and one device."""
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"embedding_bag_grouped: {len(tables)} tables, "
                         f"not 1 to {MAX_TABLES}")
    for t in tables:
        _check_table(t)
    t0 = tables[0]
    for i, t in enumerate(tables):
        if t.dtype != t0.dtype or t.shape[1] != t0.shape[1]:
            raise TypeError(f"embedding_bag_grouped: table {i} is "
                            f"{tuple(t.shape)} {t.dtype}, table 0 "
                            f"{tuple(t0.shape)} {t0.dtype}: a group shares "
                            f"one dtype and one width")
        if t.device != t0.device:
            raise ValueError(f"embedding_bag_grouped: table {i} on "
                             f"{t.device}, table 0 on {t0.device}")


def _group(tables) -> ctypes.Array:
    """The group's (pointer, V) descriptors for the C entry, made once a
    group: cached per tuple of (data_ptr, shape, stride, dtype) of its
    tables (stride: a transposed square table has the same pointer and
    shape), so a repeated call does no per-table checks."""
    key = tuple([(t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for t in tables])
    desc = _groups.get(key)
    if desc is None:
        _check_group(tables)
        for i, t in enumerate(tables):
            if not t.is_contiguous():
                raise ValueError(f"embedding_bag_grouped: table {i} must "
                                 f"be contiguous")
        if len(_groups) >= 64:
            _groups.clear()
        desc = _groups[key] = (_Table * len(tables))(
            *[(t.data_ptr(), t.shape[0]) for t in tables])
    return desc


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def embedding_bag(table: torch.Tensor, indices, weights=None,
                  combiner: str = "sum") -> torch.Tensor:
    """Multi-hot embedding lookup-reduce. table: (V, D) f32 or bf16;
    indices: (B, L), cast to int32 (as repro's wrapper does), every
    negative id padding; weights: (B, L), cast to f32, None = ones (the
    kernel then reads no weights; a strided row view of ids or weights
    is read as it lies).
    Returns (B, D) in the table's dtype: the weighted sum of the bag's
    rows in fp32 (``combiner="mean"``: over max(sum of the valid
    weights, 1e-9)), 0 for an all-padding bag, NaN for a bag holding an
    id >= V. A CPU table runs the plain PyTorch version; a CUDA table
    launches the kernel. Differentiable (``embedding_bag_grouped_bwd``
    over the one table)."""
    if _needs_grad((table, weights)):
        idx = _on("indices", indices, torch.int32, table.device)
        w = None if weights is None else \
            _on("weights", weights, torch.float32, table.device)
        out = _GroupedBag.apply(None, idx[:, None], None if w is None
                                else w[:, None], combiner, table)
        return out[:, 0]
    return _bag(table, indices, weights, combiner)


def _bag(table: torch.Tensor, indices, weights, combiner: str
         ) -> torch.Tensor:
    """``embedding_bag``'s forward."""
    global launches
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not "
                         f"{combiner!r}")
    _check_table(table)
    dev = table.device
    indices = _on("indices", indices, torch.int32, dev)
    if weights is not None:
        weights = _on("weights", weights, torch.float32, dev)
    wshape = None if weights is None else tuple(weights.shape)
    if indices.dim() != 2 or wshape not in (None, indices.shape):
        raise ValueError(f"embedding_bag: indices {tuple(indices.shape)}"
                         f" must be (B, L) and weights {wshape} the "
                         f"same")
    (b, bag), (v, d) = indices.shape, table.shape
    es = table.element_size()
    with obs.kernel_span("kernel:embedding_bag", dev) as sp:
        sp.add("rows", b * bag)
        sp.add("bytes", b * bag * (d * es + (4 if weights is None else 8))
               + b * d * es)
        if dev.type == "cpu":
            return embedding_bag_plain(table, indices, weights, combiner)
        if dev.type != "cuda":
            raise ValueError(f"embedding_bag runs on cpu or cuda, not {dev}")
        if not table.is_contiguous():
            raise ValueError("embedding_bag: the table must be contiguous")
        out = torch.empty((b, d), dtype=table.dtype, device=dev)
        if b == 0 or d == 0:
            return out
        indices, ldi = _row_stride(indices)
        w_ptr, ldw = None, 0                 # null weights: unit weights
        if weights is not None:
            weights, ldw = _row_stride(weights)
            w_ptr = weights.data_ptr()
        lib, one, _, _ = _lib()
        with sp.launch():
            err = _call(dev, one, table.data_ptr(), indices.data_ptr(),
                        w_ptr, out.data_ptr(), DTYPES[table.dtype], v, d, b,
                        bag, ldi, ldw, COMBINERS[combiner])
        check(lib, err, "embedding_bag_fwd")
        launches += 1
        return out


def embedding_bag_grouped(tables, indices, weights=None,
                          combiner: str = "sum",
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """``embedding_bag`` over F tables in one launch. tables: a sequence
    of F <= 64 (V_f, D) tables of one dtype (f32 or bf16), one D, one
    device; indices: (B, F, L), cast to int32, field f's ids index table
    f; weights: (B, F, L) f32, or None for unit weights; ids and weights
    are read through their (b, f) strides as they lie. out: (B, F, D) in
    the tables' dtype with its last dimension contiguous, written in
    place (DLRM passes ``feats[:, 1:]`` of its (B, F + 1, D) stack), or
    None to allocate one. Returns ``out``: out[:, f] is
    ``embedding_bag(tables[f], indices[:, f], weights[:, f], combiner)``
    bit for bit. CPU tables run the plain version; CUDA tables launch the
    kernel once. Differentiable: the tables' cotangent is ``out``'s (for
    DLRM the slice of its stack), and ``embedding_bag_grouped_bwd`` gives
    the tables' dense gradients in one call."""
    if _needs_grad(list(tables) + [weights, out]):
        return _GroupedBag.apply(out, indices, weights, combiner, *tables)
    return _grouped(tables, indices, weights, combiner, out)


def _grouped(tables, indices, weights=None, combiner: str = "sum",
             out: torch.Tensor | None = None) -> torch.Tensor:
    """``embedding_bag_grouped``'s forward."""
    global launches
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not "
                         f"{combiner!r}")
    if not tables:
        raise ValueError("embedding_bag_grouped: no tables")
    t0 = tables[0]
    _check_table(t0)
    dev, dtype, f, d = t0.device, t0.dtype, len(tables), t0.shape[1]
    indices = _on("indices", indices, torch.int32, dev)
    if weights is not None:
        weights = _on("weights", weights, torch.float32, dev)
    wshape = None if weights is None else tuple(weights.shape)
    if (indices.dim() != 3 or indices.shape[1] != f
            or wshape not in (None, indices.shape)):
        raise ValueError(f"embedding_bag_grouped: indices "
                         f"{tuple(indices.shape)} must be (B, {f}, L) "
                         f"and weights {wshape} the same")
    b, _, bag = indices.shape
    if out is None:
        out = torch.empty((b, f, d), dtype=dtype, device=dev)
    elif (out.shape != (b, f, d) or out.dtype != dtype
          or out.device != dev or (d > 1 and out.stride(2) != 1)):
        raise ValueError(f"embedding_bag_grouped: out "
                         f"{tuple(out.shape)} {out.dtype} on "
                         f"{out.device} must be ({b}, {f}, {d}) "
                         f"{dtype} on {dev}, last dimension "
                         f"contiguous")
    es = t0.element_size()
    with obs.kernel_span("kernel:embedding_bag", dev) as sp:
        sp.add("rows", b * f * bag)
        sp.add("bytes", b * f * bag * (d * es + (4 if weights is None
                                                 else 8)) + b * f * d * es)
        if dev.type == "cpu":
            _check_group(tables)
            return embedding_bag_grouped_plain(tables, indices, weights,
                                               combiner, out)
        if dev.type != "cuda":
            raise ValueError(f"embedding_bag runs on cpu or cuda, not {dev}")
        desc = _group(tables)
        if b == 0 or d == 0:
            return out
        indices, ids_b, ids_f = _slots(indices)
        w_ptr, w_b, w_f = None, 0, 0          # null weights: unit weights
        if weights is not None:
            weights, w_b, w_f = _slots(weights)
            w_ptr = weights.data_ptr()
        lib, _, grp, _ = _lib()
        with sp.launch():
            err = _call(dev, grp, desc, f, indices.data_ptr(), w_ptr,
                        out.data_ptr(), DTYPES[dtype], d, b, bag, ids_b,
                        ids_f, w_b, w_f, out.stride(0), out.stride(1),
                        COMBINERS[combiner])
        check(lib, err, "embedding_bag_grouped_fwd")
        launches += 1
        return out


class _GroupedBag(torch.autograd.Function):
    """The grouped forward, written into ``out`` in place (``out`` comes
    first: autograd hands an in-place op on a view the view's gradient as
    that of the op's first input), and its backward."""

    @staticmethod
    def forward(ctx, out, indices, weights, combiner, *tables):
        dev = tables[0].device
        indices = _on("indices", indices, torch.int32, dev)
        if weights is not None:
            weights = _on("weights", weights, torch.float32, dev)
        res = _grouped(tables, indices, weights, combiner, out)
        if out is not None:
            ctx.mark_dirty(out)
        ctx.save_for_backward(indices, weights, *tables)
        ctx.combiner = combiner
        return res

    @staticmethod
    def backward(ctx, g):
        indices, weights, *tables = ctx.saved_tensors
        grads = [None] * len(tables)
        if any(ctx.needs_input_grad[4:]):
            stacked = embedding_bag_grouped_bwd(
                [t.shape[0] for t in tables], tables[0].dtype, indices,
                weights, ctx.combiner, g)
            grads, row = [], 0
            for t in tables:
                grads.append(stacked[row:row + t.shape[0]])
                row += t.shape[0]
        dw = None
        if ctx.needs_input_grad[2]:
            dw = embedding_bag_weights_grad_plain(tables, indices, weights,
                                                  ctx.combiner, g)
        # ``out``'s earlier content is overwritten: its gradient is 0
        dout = g.new_zeros(()).expand(g.shape) if ctx.needs_input_grad[0] \
            else None
        return (dout, None, dw, None, *grads)


def embedding_bag_grouped_bwd(sizes, dtype: torch.dtype, indices,
                              weights, combiner: str,
                              grad: torch.Tensor) -> torch.Tensor:
    """The dense gradient of a grouped bag call's tables: ``grad`` (B, F,
    D) is the cotangent of its output (any strides, last dimension
    contiguous), ``sizes`` the F tables' row counts. Returns the
    (sum(sizes), D) stacked gradient in ``dtype`` (field f's rows from
    the sum of the earlier sizes): each row the sum of coef * grad[b, f]
    over its slots, coef the slot's weight (1 without weights; over
    max(bag's weight sum, 1e-9) for ``mean``), padding and ids >= V_f
    adding nothing. The slots are sorted stably by row
    (``plain.bag_segments``, index work in PyTorch); a CPU ``grad`` then
    runs ``embedding_bag_backward_plain``, a CUDA one the backward kernel
    (two launches, no atomics), both in the same order: the same bits."""
    global bwd_launches
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not "
                         f"{combiner!r}")
    dev = grad.device
    indices = _on("indices", indices, torch.int32, dev)
    if weights is not None:
        weights = _on("weights", weights, torch.float32, dev)
    b, f, bag = indices.shape
    d = grad.shape[-1]
    if (grad.dim() != 3 or tuple(grad.shape[:2]) != (b, f)
            or len(sizes) != f or dtype not in DTYPES
            or (weights is not None and weights.shape != indices.shape)):
        raise ValueError(f"embedding_bag_grouped_bwd: grad "
                         f"{tuple(grad.shape)}, indices "
                         f"{tuple(indices.shape)}, {len(sizes)} sizes")
    if b * f * bag >= 2 ** 31:
        raise ValueError("embedding_bag_grouped_bwd: more than 2^31 "
                         "slots")
    seg = bag_segments(sizes, indices, weights, combiner)
    es = torch.tensor([], dtype=dtype).element_size()
    with obs.kernel_span("kernel:embedding_bag_bwd", dev) as sp:
        sp.add("rows", len(seg["slot"]))
        sp.add("bytes", len(seg["slot"]) * (d * es + 8)
               + seg["rows"] * d * es)
        if dev.type == "cpu":
            return embedding_bag_backward_plain(sizes, dtype, indices,
                                                weights, combiner, grad, seg)
        if dev.type != "cuda":
            raise ValueError(f"embedding_bag runs on cpu or cuda, not {dev}")
        grad = grad.to(dtype)
        if d > 1 and grad.stride(2) != 1:
            grad = grad.contiguous()
        out = torch.zeros((seg["rows"], d), dtype=dtype, device=dev)
        partial = torch.empty((seg["parts"], d), dtype=torch.float32,
                              device=dev)
        coef = seg["coef"]
        lib, _, _, bwd = _lib()
        with sp.launch():
            err = _call(dev, bwd, grad.data_ptr(), DTYPES[dtype],
                        grad.stride(0), grad.stride(1), f, bag, d,
                        seg["slot"].data_ptr(),
                        None if coef is None else coef.data_ptr(),
                        seg["start"].data_ptr(), seg["count"].data_ptr(),
                        seg["key"].data_ptr(), seg["part"].data_ptr(),
                        len(seg["start"]), seg["multi_first"].data_ptr(),
                        seg["multi_count"].data_ptr(),
                        seg["multi_key"].data_ptr(), len(seg["multi_key"]),
                        partial.data_ptr(), out.data_ptr())
        check(lib, err, "embedding_bag_grouped_bwd")
        bwd_launches += 1
        return out
