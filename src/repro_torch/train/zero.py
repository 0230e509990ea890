"""ZeRO-1 on a mesh: one rank's layout of the optimizer state and of its
update (repro's ``launch/sharding.zero1_opt_specs``, executed).

A rank holds a block of each param (its spec under
``launch/sharding.lm_param_specs`` / ``recsys_param_specs``, a gated
``[gate | up]`` leaf as ``models/tp.gated_block`` cuts it). repro's
ZeRO-1 rule adds the data-parallel axes that the param spec leaves free
to the largest dimension they divide: the ZeRO block of the rank is the
part of its param block that it updates. ``LeafLayout`` says where that
block lies (``dim``, ``lo``, ``width`` within the param block; ``axes``,
the ZeRO axes), which mesh axes split it (``split_axes``: the param
spec's and the ZeRO axes, those of size 1 left out) and the global
positions of its rows along each dimension (``runs``, ``index``; a gated
last dimension is two runs).

The step (``train/optimizer``): the gradients arrive summed over the
axes their spec does not name (``train_loop.reduce_grads``: an
all-reduce; a reduce-scatter would send half the bytes, later work), the
rank updates its ZeRO block of the param from its block of the gradient
and of the state, then all-gathers the param over the ZeRO axes along
``dim`` and writes it back in place (``gather_back``). AdamW is
elementwise, so this is the replicated update bit for bit. Adafactor's
row and column means and its RMS clip span a layer's whole matrix, so
the rank sums its block's partials over the axes that split the block
(``split_axes``) into the statistics of the whole matrix, which are small
(``train/optimizer.adafactor``).

The state is made at its block directly (``init``): a full-size state
of a large model would not fit a card beside the params. AdamW's m and
v are the ZeRO block's shape; Adafactor's r / c lie at their own spec
(repro's ``zero1_opt_specs`` gives a factored accumulator the data axes
on its largest dimension and no "model"), a full v at the ZeRO block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .tree import leaves, tree_map_with_path

GATHER_CHUNK = 1 << 26       # elements of one param gather's block, about


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    shape: tuple                 # the leaf's global shape
    block: tuple                 # the rank's param block's shape
    dim: Optional[int]           # the ZeRO dimension (None: whole block)
    axes: tuple                  # the ZeRO axes (sizes > 1), mesh order
    lo: int                      # the ZeRO block within the param block
    width: int
    split_axes: tuple            # every axis (size > 1) splitting it
    runs: tuple                  # per dimension: ((lo, hi), ...) global

    def zero_block(self, t: torch.Tensor) -> torch.Tensor:
        """The ZeRO block of ``t`` (a param block, or its gradient): a
        view."""
        return t if self.dim is None else t.narrow(self.dim, self.lo,
                                                  self.width)

    def zero_shape(self) -> tuple:
        out = list(self.block)
        if self.dim is not None:
            out[self.dim] = self.width
        return tuple(out)

    def index(self, dims, device) -> tuple:
        """Broadcastable index tensors of the block's global positions
        along ``dims`` (a list of dimensions), for advanced indexing of a
        tensor whose dimensions are those."""
        out = []
        for j, d in enumerate(dims):
            pos = torch.cat([torch.arange(lo, hi, device=device)
                             for lo, hi in self.runs[d]])
            shape = [1] * len(dims)
            shape[j] = -1
            out.append(pos.reshape(shape))
        return tuple(out)


def block_runs(shape: tuple, spec, mesh, coord: dict,
               gated: bool = False) -> tuple:
    """The global positions of the block that the rank at ``coord``
    holds of a ``shape`` leaf under ``spec`` (``launch/sharding.P``): per
    dimension, ((lo, hi), ...), one run along ``local_slice``'s block, or
    two along the last dimension of a ``gated`` leaf (``[gate | up]``)
    that the spec splits, whose block is ``[gate_r | up_r]``
    (``models/tp.gated_block``)."""
    from ..launch.sharding import local_slice

    runs = []
    for d, sl in enumerate(local_slice(shape, spec, mesh, coord)):
        start, stop = sl.start, sl.stop
        if d == len(shape) - 1 and gated and stop - start < shape[d]:
            f, w, g0 = shape[d] // 2, (stop - start) // 2, start // 2
            runs.append(((g0, g0 + w), (f + g0, f + g0 + w)))
        else:
            runs.append(((start, stop),))
    return tuple(runs)


class ZeroLayout:
    """One rank's ZeRO-1 layout of a param tree: a ``LeafLayout`` a leaf
    (``leaf(path)``), the mesh and the rank's coordinate, and the state's
    spec tree of the optimizer it was made for (``state_specs``).

    ``shapes``: the global param tree (meta tensors do); ``pspecs``: its
    spec tree; ``opt_name``: "adamw" or "adafactor"; ``mesh``: a
    ``DeviceMesh`` (or a ``launch/mesh.MeshShape`` with ``coord`` given,
    for ``init`` alone: the dry run); ``act``: the model's activation (a
    gated leaf's block is ``[gate_r | up_r]``)."""

    def __init__(self, shapes, pspecs, opt_name: str, mesh,
                 coord: Optional[dict] = None, act: Optional[str] = None):
        from ..launch import sharding as shd
        from ..models.tp import gated_leaf
        from .optimizer import get_optimizer

        if coord is None:
            from ..launch.mesh import coordinate
            coord = coordinate(mesh)
        self.mesh, self.coord, self.opt_name = mesh, dict(coord), opt_name
        self.act = act or ""
        self.shapes = shapes
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        zspecs = dict(leaves(shd.zero1_opt_specs(pspecs, shapes, mesh)))
        flat_p = dict(leaves(pspecs))
        self.state_specs = shd.zero1_opt_specs(
            pspecs, get_optimizer(opt_name).init(shapes), mesh)
        self._state_flat = dict(leaves(self.state_specs))
        self._leaves = {}
        for path, leaf in leaves(shapes):
            shape, pspec = tuple(leaf.shape), flat_p[path]
            zspec = zspecs[path]
            block = shd.local_shape(shape, pspec, mesh)
            dim, axes, lo, width = None, (), 0, 0
            for d, (pe, ze) in enumerate(zip(pspec, zspec)):
                extra = tuple(a for a in shd._axes(ze)
                              if a not in shd._axes(pe) and sizes[a] > 1)
                if extra:
                    dim, axes = d, extra
            if dim is not None:
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * sizes[a] + coord[a], n * sizes[a]
                width = block[dim] // n
                lo = idx * width
            split = [a for e in pspec for a in shd._axes(e)
                     if sizes[a] > 1] + list(axes)
            runs = block_runs(shape, zspec, mesh, coord,
                              gated_leaf(path, act or ""))
            self._leaves[path] = LeafLayout(shape, block, dim, axes, lo,
                                            width, tuple(split),
                                            tuple(runs))

    def leaf(self, path: str) -> LeafLayout:
        return self._leaves[path]

    def state_spec(self, path: str):
        """The spec of the state leaf at ``path`` (``state_specs``')."""
        return self._state_flat[path]

    def state_blocks(self, device) -> Any:
        """The optimizer's state at the rank's blocks: zeros (fp32) of
        each state leaf's block under ``state_specs``, made on
        ``device``."""
        from ..launch.sharding import local_shape
        from .optimizer import get_optimizer

        return tree_map_with_path(lambda path, t: torch.zeros(
            local_shape(tuple(t.shape), self._state_flat[path], self.mesh),
            dtype=torch.float32, device=device),
            get_optimizer(self.opt_name).init(self.shapes))

    def local_slice(self, shape: tuple, spec) -> tuple:
        from ..launch.sharding import local_slice
        return local_slice(shape, spec, self.mesh, self.coord)

    def gather_state(self, t: torch.Tensor, shape: tuple, spec
                     ) -> torch.Tensor:
        """The whole of a state leaf of global ``shape`` from the rank's
        block ``t`` at ``spec``: all-gathered along each dimension its
        spec splits."""
        from ..launch.collectives import all_gather
        from ..launch.sharding import _axes

        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        for d, entry in enumerate(spec):
            axes = tuple(a for a in _axes(entry) if sizes[a] > 1)
            if axes and t.shape[d] < shape[d]:
                t = all_gather(t.contiguous(), self.mesh, axes, dim=d)
        return t

    def gather_back(self, p: torch.Tensor, lf: LeafLayout) -> None:
        """All-gather the updated ZeRO blocks of param block ``p`` over
        ``lf.axes`` along ``lf.dim`` and write them into ``p`` in place:
        in slices of its first dimension (when the ZeRO dimension is
        another) of about ``GATHER_CHUNK`` elements, so the temporaries
        stay small beside a stacked leaf."""
        from ..launch.collectives import all_gather

        if lf.dim is None:
            return
        if lf.dim == 0:
            p.copy_(all_gather(lf.zero_block(p).contiguous(), self.mesh,
                               lf.axes, dim=0))
            return
        per = max(1, GATHER_CHUNK // max(1, p[0].numel()))
        for i in range(0, p.shape[0], per):
            sl = p[i:i + per]
            sl.copy_(all_gather(sl.narrow(lf.dim, lf.lo, lf.width)
                                .contiguous(), self.mesh, lf.axes,
                                dim=lf.dim))

    def reduce(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        """``t`` summed over ``axes`` (none: ``t``)."""
        from ..launch.collectives import all_reduce_sum
        return all_reduce_sum(t, self.mesh, axes) if axes else t

