"""Wrapper of the embedding-bag kernel (csrc/embedding_bag.cu): the
sparse-feature lookup of DLRM, one launch a table."""
from __future__ import annotations

import ctypes

import torch

from ... import obs
from .. import build
from ..build import check
from .plain import embedding_bag_plain

launches = 0          # CUDA kernel launches of ``embedding_bag``

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COMBINERS = {"sum": 0, "mean": 1}


def _lib():
    lib = build.load("embedding_bag")
    if lib.embedding_bag_fwd.argtypes is None:
        lib.embedding_bag_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 6
            + [ctypes.c_int, ctypes.c_void_p])
        lib.embedding_bag_fwd.restype = ctypes.c_int
    return lib


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
    launches the kernel."""
    global launches
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not "
                         f"{combiner!r}")
    with obs.span("kernel:embedding_bag") as sp:
        if not isinstance(table, torch.Tensor):
            raise TypeError(f"table: expected a torch.Tensor, got "
                            f"{type(table)}")
        if table.dim() != 2 or table.dtype not in DTYPES:
            raise TypeError(f"embedding_bag: table must be 2-d in "
                            f"{list(DTYPES)}, got {tuple(table.shape)} "
                            f"{table.dtype}")
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
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.embedding_bag_fwd(
                table.data_ptr(), indices.data_ptr(), w_ptr, out.data_ptr(),
                DTYPES[table.dtype], v, d, b, bag, ldi, ldw,
                COMBINERS[combiner], stream)
        check(lib, err, "embedding_bag_fwd")
        launches += 1
        if sp is not obs.NOOP_SPAN:            # traced: span = device time
            torch.cuda.current_stream(dev).synchronize()
        return out
