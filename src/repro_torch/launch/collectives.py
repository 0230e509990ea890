"""The port's collectives, and the record of them (the counterpart of
repro's ``launch/hlo_analysis.py``).

repro reads its collectives out of the partitioned HLO. The port has no
HLO: each sharded path (``models/moe.moe_block_sharded``,
``models/recsys.RowShardedBag``, the retrieval cell,
``shard/planner.device_fanout_topk``) is a per-rank function on local
tensors whose collectives are these explicit calls at its boundary, and
each call records itself where it is made: (op, result bytes, group
size), forward and backward alike, in one record of the process (under
a lock: autograd's device thread runs the backward on the card, the
caller's thread on the CPU, and both land in the same record). A layer
recomputed by ``torch.utils.checkpoint`` in the backward replays its
forward's collectives: they are counted once more, as calls of their
own, as repro's HLO holds a rematerialized layer's collectives a second
time; the same step counts the same on the CPU and on the card.
``collective_stats`` tallies a record as repro's
``collective_stats`` tallies an HLO module.

Each call reduces over one mesh axis or a group of them (one call a
process group, ``mesh.get_group(axis)``, inner axis first for a gather),
with only ``all_reduce`` (a sum, or a max: ``all_reduce_max``) and
``all_gather`` (gloo on the CPU and NCCL on
the card both have them). Autograd takes the SPMD view: each rank
differentiates its own share of the global loss (``train/train_loop``),
so the backward of a sum over a group is the sum of the group's
cotangents, and that of a gather the sum of the cotangents of one's own
block (a reduce-scatter, here an all-reduce and a slice).

``hlo_analysis.cost_summary`` (XLA's memory and cost analysis) has its
counterpart in ``launch/dryrun``: each rank's argument bytes from the
placements; the port measures no temp bytes or FLOPs there. repro's
``launch/compat.py`` holds only JAX shims and has no counterpart.
"""
from __future__ import annotations

import threading

import torch

from .sharding import _axes

# repro's keys, so that a tally has its shape; the port records only the
# first two (the others stay at 0)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_HLO_NAMES = {torch.float64: "f64", torch.float32: "f32",
              torch.float16: "f16", torch.bfloat16: "bf16",
              torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
              torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}

_log: list = []              # the process's record
_lock = threading.Lock()


def _nbytes(t: torch.Tensor) -> int:
    """A result's bytes, by the HLO element sizes repro counts with."""
    return t.numel() * _DTYPE_BYTES[_HLO_NAMES[t.dtype]]


def _record(op: str, t: torch.Tensor, n: int) -> None:
    with _lock:
        _log.append((op, _nbytes(t), n))


def take_records() -> list:
    """The process's record, (op, result bytes, group size) a call in the
    order the calls were made, emptied."""
    with _lock:
        out = list(_log)
        _log.clear()
    return out


def _wire_bytes(op: str, result_bytes: int, g: int) -> float:
    """Per-device wire-byte estimate from the RESULT shape and group
    size g (ring algorithms), repro's for the two ops the port records:
      all-gather:     result = full gathered tensor -> (g-1)/g * result
      all-reduce:     in == out -> ring sends 2*(g-1)/g * result
    """
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    assert op == "all-reduce", op
    return 2.0 * result_bytes * (g - 1) / g


def collective_stats(recs) -> dict:
    """Per-op-kind tallies of a record: {op: {bytes, wire_bytes, count},
    total_bytes, total_wire_bytes}, as repro's. ``bytes`` = result bytes
    a rank; ``wire_bytes`` = the ring estimate a rank."""
    stats: dict = {op: {"bytes": 0, "wire_bytes": 0.0, "count": 0}
                   for op in COLLECTIVE_OPS}
    for op, b, g in recs:
        stats[op]["bytes"] += b
        stats[op]["wire_bytes"] += _wire_bytes(op, b, g)
        stats[op]["count"] += 1
    stats["total_bytes"] = sum(stats[op]["bytes"] for op in COLLECTIVE_OPS)
    stats["total_wire_bytes"] = sum(stats[op]["wire_bytes"]
                                    for op in COLLECTIVE_OPS)
    return stats


def _groups(mesh, axes) -> list:
    """(process group, size) of each named axis, in the order given."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return [(mesh.get_group(a), sizes[a]) for a in _axes(axes)]


def _reduce(t: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist

    t = t.contiguous().clone()
    for group, n in groups:
        dist.all_reduce(t, group=group)
        _record("all-reduce", t, n)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _reduce(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.groups), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, dim):
        import torch.distributed as dist

        ctx.dim, ctx.width, ctx.groups = dim, t.shape[dim], groups
        block = 0                            # own block's index, mixed radix
        for group, n in groups:
            block = block * n + dist.get_rank(group)
        ctx.block = block
        for group, n in reversed(groups):    # inner axis first
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim)
            _record("all-gather", t, n)
        return t

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, ctx.groups)
        return (g.narrow(ctx.dim, ctx.block * ctx.width, ctx.width)
                .contiguous(), None, None)


def all_reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``t`` over the ranks of the mesh axes ``axes`` (a name or a
    tuple); differentiable. On one rank, a copy."""
    return _AllReduceSum.apply(t, _groups(mesh, axes))


def all_reduce_sum_(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``t`` (contiguous) over the ranks of ``axes`` in place, with no
    autograd rule (a step's gradients, ``train_loop.reduce_grads``: no
    copy of a leaf beside it). Returns ``t``."""
    import torch.distributed as dist

    for group, n in _groups(mesh, axes):
        dist.all_reduce(t, group=group)
        _record("all-reduce", t, n)
    return t


def all_reduce_max(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise max of ``t`` over the ranks of ``axes``; no gradient
    (the caller passes a detached tensor: a softmax's shift)."""
    import torch.distributed as dist

    t = t.detach().contiguous().clone()
    for group, n in _groups(mesh, axes):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        _record("all-reduce", t, n)
    return t


def all_reduce_mean(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Mean of ``t`` over the ranks of ``axes``; differentiable."""
    n = 1
    for _, size in _groups(mesh, axes):
        n *= size
    return all_reduce_sum(t, mesh, axes) / n


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of ``t`` of the ranks of ``axes`` concatenated along
    ``dim`` in the order ``launch/sharding.local_slice`` cuts them
    (the first axis major); differentiable."""
    return _AllGather.apply(t, _groups(mesh, axes), dim)
