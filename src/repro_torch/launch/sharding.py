"""Sharding rules: map every cell's trees onto a mesh (repro's
``launch/sharding.py``, rule for rule).

Scheme (DESIGN.md §3):
  LM train:   DP over ('pod','data') for the batch; Megatron TP over
              'model' (fused head*dh dim of QKV, d_ff, vocab); MoE expert
              dim over 'model' (expert parallelism) with the capacity dim
              over 'data'; ZeRO-1: optimizer state additionally sharded
              over the DP axes on the largest divisible dim.
  LM decode:  KV cache batch over DP, kv-heads over 'model' when
              divisible, else the SEQUENCE over 'model' (kv<16 archs);
              long_500k shards the 512k sequence over 'data'.
  GNN:        edges sharded over every axis; node arrays replicated.
  RecSys:     embedding tables row-sharded over 'model'; batch over DP;
              candidate matrices row-sharded over ALL axes.

Every rule is divisibility-sanitized: an axis that does not divide the
dim is dropped (replicated).

A spec is a ``P``: a tuple with one entry a tensor dimension, each the
name of a mesh axis, a tuple of names (split in that order, the first
major), or None. The rules match a leaf by its path, the string
``train/tree.leaves`` gives it (``jax.tree_util.keystr``'s, such as
``"['layers']['attn']['wq']"``), so they read as repro's. They need only
a mesh's ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh`` or a
``launch/mesh.MeshShape``): no process group.

``placements`` turns a spec into DTensor placements on a
``DeviceMesh``; ``local_slice`` and ``distribute_tree`` give one rank its
blocks. ``executed`` and ``executed_batch`` say which leaves a step
actually executes sharded: every leaf of every kind at repro's spec
(Megatron tensor parallelism, ``models/tp``; the KV cache split by kv
heads or by sequence; the optimizer state at ``zero1_opt_specs``,
``train/optimizer``'s ZeRO-1 layout; a graph batch's edges over every
axis and its node rows over the data-parallel axes, ``models/schnet``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..train.tree import leaves, tree_map_with_path
from .mesh import axis_size, dp_axes


class P(tuple):
    """A PartitionSpec: ``P("model", None)``. A one-name tuple entry is
    that name, as JAX's ``PartitionSpec`` keeps it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _size(mesh, axes) -> int:
    return axis_size(mesh, axes)


def sanitize(spec: P, shape: tuple, mesh) -> P:
    """Drop spec axes that don't evenly divide the dim (replicate)."""
    out = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(shape):
            out.append(None)
            continue
        if shape[i] % _size(mesh, axes) == 0:
            out.append(axes)
        else:
            out.append(None)
    return P(*out)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def replicated(tree) -> Any:
    """An all-None spec for every leaf of ``tree``."""
    return tree_map_with_path(lambda p, l: P(*([None] * len(_shape(l)))), tree)


# ---------------------------------------------------------------------------
# LM params
# ---------------------------------------------------------------------------
def lm_param_specs(params_shape, mesh) -> Any:
    """Spec tree mirroring the param tree. Layer-stacked params carry a
    leading L dim (unsharded)."""

    def rule(p: str, leaf):
        nd = len(leaf.shape)
        if "embed" in p:
            return P("model", None)                    # vocab-sharded
        if "lm_head" in p:
            return P(None, "model")
        if "'attn'" in p:
            if p.endswith("['wo']"):                   # (L, H*dh, D)
                return P(None, "model", None)
            if nd == 3:                                # wq/wk/wv (L, D, E)
                return P(None, None, "model")
            if nd == 2:                                # biases (L, E)
                return P(None, "model")
        if "moe" in p:
            if "router" in p:                          # (L, D, E)
                return P(None, None, None)
            if "shared_w_in" in p:                     # (L, D, Fs)
                return P(None, None, "model")
            if "shared_w_out" in p:                    # (L, Fs, D)
                return P(None, "model", None)
            if "w_in" in p:                            # (L, E, D, F)
                # 2D expert sharding: experts over 'model' (EP) AND the
                # per-expert d_model dim over 'data' (gathered over
                # 'data' just in time, models/moe.moe_block_sharded)
                return P(None, "model", "data", None)
            if "w_out" in p:                           # (L, E, F, D)
                return P(None, "model", "data", None)
        if "mlp" in p:
            if "win" in p:                             # (L, D, F*)
                return P(None, None, "model")
            if "wout" in p:                            # (L, F, D)
                return P(None, "model", None)
        return P(*([None] * nd))                       # norms etc.

    return tree_map_with_path(
        lambda path, leaf: sanitize(rule(path, leaf), _shape(leaf), mesh),
        params_shape)


def zero1_opt_specs(param_specs, opt_shape, mesh) -> Any:
    """Optimizer-state specs: mirror the param spec where shapes match
    (adam m/v), and additionally shard the largest free dim over the DP
    axes (ZeRO-1). Adafactor r/c (reduced shapes) get a shape-driven
    variant of the same rule."""
    dp = dp_axes(mesh)
    flat_specs = leaves(param_specs)

    def per_state(path: str, leaf):
        shape = _shape(leaf)
        spec = _lookup_param_spec(flat_specs, path)
        if spec is not None and len(spec) == len(shape):
            base = list(sanitize(spec, shape, mesh))
        else:
            base = [None] * len(shape)
        # ZeRO-1: add DP on the largest unsharded divisible dim — unless
        # a DP axis is already consumed by the param sharding
        used = set()
        for axes in base:
            used.update(_axes(axes))
        free_dp = tuple(a for a in dp if a not in used)
        free_n = _size(mesh, free_dp)
        best, best_dim = -1, -1
        for i, (axes, dim) in enumerate(zip(base, shape)):
            if axes is None and free_dp and dim % free_n == 0 \
                    and dim > best:
                best, best_dim = dim, i
        if best_dim >= 0:
            base[best_dim] = free_dp if len(free_dp) > 1 else free_dp[0]
        return P(*base)

    return tree_map_with_path(per_state, opt_shape)


def _lookup_param_spec(flat_specs, state_path: str) -> Optional[P]:
    """Match a state path like "['m']['layers']['attn']['wq']" (or
    "['layers']...['r']") to its param spec by stripping state-level
    keys. ``flat_specs``: (path, spec) of the param spec tree."""
    s_core = state_path
    for k in ("['m']", "['v']", "['r']", "['c']"):
        s_core = s_core.replace(k, "")
    for pstr, spec in flat_specs:
        core = pstr.replace("['m']", "").replace("['v']", "")
        if core == s_core or pstr == s_core:
            return spec
    return None


# ---------------------------------------------------------------------------
# LM batch / cache
# ---------------------------------------------------------------------------
def _dp_spec(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def lm_batch_specs(input_specs: dict, mesh, cfg, shape_kind: str,
                   long_context: bool = False) -> dict:
    dp_spec = _dp_spec(mesh)
    model_n = _size(mesh, "model")
    out = {}
    for name, s in input_specs.items():
        shape = _shape(s)
        if name in ("tokens", "labels"):
            out[name] = P(dp_spec, *([None] * (len(shape) - 1)))
        elif name in ("cache_k", "cache_v"):
            # (L, B, KV, S, Dh)
            kv_div = shape[2] % model_n == 0
            if long_context:
                # batch=1: shard the SEQUENCE over data; kv over model
                out[name] = P(None, None, "model" if kv_div else None,
                              dp_spec, None)
            elif kv_div:
                out[name] = P(None, dp_spec, "model", None, None)
            else:
                # kv heads don't divide: shard sequence over model
                out[name] = P(None, dp_spec, None, "model", None)
        elif name == "cache_len":
            out[name] = P()
        else:
            out[name] = P(*([None] * len(shape)))
    return {k: sanitize(v, _shape(input_specs[k]), mesh)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------
def gnn_param_specs(params_shape, mesh) -> Any:
    # d_hidden=64: everything replicated (node arrays are the big ones and
    # they are activations, not params)
    return replicated(params_shape)


def gnn_batch_specs(input_specs: dict, mesh) -> dict:
    every = tuple(mesh.mesh_dim_names)
    out = {}
    for name, s in input_specs.items():
        shape = _shape(s)
        if name == "edge_index":                     # (2, E)
            out[name] = P(None, every)
        elif name == "edge_dist":                    # (E,)
            out[name] = P(every)
        elif name == "node_feat":                    # (N, F): rows over DP
            out[name] = P(dp_axes(mesh), None)
        elif name in ("atom_z", "labels", "graph_ids"):
            out[name] = P(dp_axes(mesh))
        else:
            out[name] = P(*([None] * len(shape)))
    return {k: sanitize(v, _shape(input_specs[k]), mesh)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# Shard fabric fan-out (DESIGN.md §10.5)
# ---------------------------------------------------------------------------
def fabric_fanout_specs(mesh, n_shards: int
                        ) -> tuple[P, P, P, tuple[P, P]]:
    """Specs for the shard fabric's device fan-out: a stacked per-shard
    corpus (S, N_pad, d) and alive mask (S, N_pad) split their shard dim
    over the data-parallel axes (each rank scores its local shards);
    queries are replicated; the per-shard (S, Q, k) candidate blocks come
    back shard-partitioned. A DP axis group that does not divide S is
    dropped (replicated)."""
    dp_spec = _dp_spec(mesh)
    shard_dim = (dp_spec if dp_spec is not None
                 and n_shards % _size(mesh, dp_spec) == 0 else None)
    q_spec = P(None, None)
    emb_spec = P(shard_dim, None, None)
    mask_spec = P(shard_dim, None)
    out_specs = (P(shard_dim, None, None), P(shard_dim, None, None))
    return q_spec, emb_spec, mask_spec, out_specs


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------
def _row_sharded_table(p: str, shape: tuple) -> bool:
    """The recsys rule's first case: a table of >= 4096 rows."""
    nd = len(shape)
    big = shape[0] >= 4096 if nd >= 1 else False
    return ("table" in p or "'v'" in p or "'w'" in p or "embed" in p
            or "wide_w" in p) and nd >= 1 and big


def recsys_param_specs(params_shape, mesh) -> Any:
    def rule(p: str, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if _row_sharded_table(p, shape):
            return P("model", *([None] * (nd - 1)))  # row-sharded table
        if nd == 2 and min(shape) >= 256:
            return P(None, "model")                  # big MLP weights: TP
        return P(*([None] * nd))

    return tree_map_with_path(
        lambda path, leaf: sanitize(rule(path, leaf), _shape(leaf), mesh),
        params_shape)


def recsys_batch_specs(input_specs: dict, mesh) -> dict:
    dp_spec = _dp_spec(mesh)
    every = tuple(mesh.mesh_dim_names)
    out = {}
    for name, s in input_specs.items():
        shape = _shape(s)
        if name == "candidates":                     # (N_pad, d): everywhere
            out[name] = P(every, None)
        elif name == "candidate_mask":
            out[name] = P(every)
        elif name == "query":
            out[name] = P(*([None] * len(shape)))
        else:                                        # batch-leading arrays
            out[name] = P(dp_spec, *([None] * (len(shape) - 1)))
    return {k: sanitize(v, _shape(input_specs[k]), mesh)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# what a step executes sharded, placements and local blocks
# ---------------------------------------------------------------------------
def executed(spec_tree, kind: str = "train") -> Any:
    """The part of a param (or optimizer state) spec tree that the port's
    steps execute sharded for a cell of ``kind``: all of it, for every
    kind. An LM's prefill, decode, encode and train cells run Megatron
    tensor parallelism over "model" (``models/tp``'s rank bodies: the
    attention, the dense MLP, the shared experts, the embedding and the
    head, with a vocab-parallel loss) and the experts over "model" and
    "data"; the recsys rule's row-sharded tables and column-parallel
    MLPs run as ``models/recsys`` cuts them; a train cell's optimizer
    state lies at ``zero1_opt_specs`` (``train/optimizer``'s ZeRO-1),
    SchNet's params and state replicated (``gnn_param_specs``)."""
    return spec_tree


def executed_batch(specs: dict, mesh=None, kind: str = "train") -> dict:
    """The part of a batch spec dict that the port's steps execute
    sharded for a cell of ``kind`` on ``mesh``: all of it, for every
    kind (the batch over the data-parallel axes, a KV cache's kv heads
    over "model" or its sequence over "model" or the data axes, the
    retrieval candidates over every axis, a graph batch's edges over
    every axis and its node rows over the data axes)."""
    return dict(specs)


def replicated_axes(spec: P, mesh) -> tuple:
    """The mesh axes ``spec`` does not name, in mesh order."""
    named = {a for e in spec for a in _axes(e)}
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


def placements(mesh, spec: P) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dimension d names, ``Replicate()`` on the
    others. A dimension split over several mesh dimensions names them in
    mesh order (as every rule here does), which is DTensor's order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    names = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"{spec}: axes of dim {d} out of mesh order")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def local_shape(shape: tuple, spec: P, mesh) -> tuple:
    """One rank's block shape of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _size(mesh, _axes(entry))
        if n == 1:
            continue
        if shape[d] % n:
            raise ValueError(f"{spec} does not divide {tuple(shape)}")
        out[d] = shape[d] // n
    return tuple(out)


def local_slice(shape: tuple, spec: P, mesh, coord: dict) -> tuple:
    """The index (a tuple of slices) of the block that the rank at
    ``coord`` ({axis: index}) holds of a ``shape`` tensor under
    ``spec``: along a dimension split over axes (a, b), block
    ``coord[a] * size(b) + coord[b]``."""
    loc = local_shape(shape, spec, mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    idx = []
    for d in range(len(shape)):
        block = 0
        for a in _axes(spec[d] if d < len(spec) else None):
            block = block * sizes[a] + coord[a]
        idx.append(slice(block * loc[d], (block + 1) * loc[d]))
    return tuple(idx)


def distribute_tree(tree, spec_tree, mesh, coord: Optional[dict] = None,
                    copy: bool = False):
    """The rank at ``coord`` (default: this rank of the ``DeviceMesh``)'s
    blocks of every leaf of ``tree``: views where a leaf is sharded, the
    leaf itself where it is replicated, or contiguous copies of both with
    ``copy``."""
    if coord is None:
        from .mesh import coordinate
        coord = coordinate(mesh)

    def block(leaf, spec):
        if any(_axes(e) for e in spec):
            leaf = leaf[local_slice(_shape(leaf), spec, mesh, coord)]
        return leaf.clone(memory_format=torch.contiguous_format) \
            if copy else leaf

    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh, coord, copy)
                for k, v in tree.items()}
    return block(tree, spec_tree)
