"""Cell bundles of the port: for every (arch x shape) cell it serves, the
concrete step function and real arrays to drive it (repro's
``launch/steps.py`` without JAX or lowering).

A ``CellBundle`` packages:
  - fn(params, opt_state, batch, step) -> (params, opt_state, loss) for a
    train cell (params and opt_state updated in place), fn(params, batch)
    for a serve, prefill, decode or encode cell, fn(batch) for a
    retrieval cell,
  - arg_specs: the ``configs.base.Spec`` trees of its arguments (a
    params or opt_state slot is None: its shapes are the model's),
  - sharding_fn(mesh): repro's spec trees of the arguments on a mesh
    (``launch/sharding``: params, optimizer state, batch, step for a
    train cell; params, batch for the others; batch for retrieval),
    from shapes alone (``param_shapes``: the init on ``meta``),
  - model_cfg, the device its arrays go to, and for a train cell its
    optimizer's name and gradient-accumulation factor.

Ported: every kind of the LM family (``train``, ``prefill``, ``decode``;
``long_500k`` is a decode cell), the embedder's ``encode``
the recsys family's ``train``, ``serve`` and ``retrieval``, and SchNet's
``train`` cells (the GNN family: molecule, full_graph_sm, minibatch_lg,
ogb_products). A train cell's params are repro's tree (layers stacked
for a transformer or SchNet's interactions, ``models/bridge.train_tree``),
so the optimizer, the gradient compression and the checkpoint see repro's
leaves.

On a mesh (``build_cell(..., mesh=)``, one rank of a ``DeviceMesh``)
``fn`` is that rank's step on its blocks (``make_smoke_args`` cuts
them), every leaf at repro's spec (``launch/sharding.executed``): the
batch split over the data-parallel axes; an LM runs Megatron tensor
parallelism over "model" (``transformer.TPConfig``, ``models/tp``), its
MoE layers expert-parallel (``moe_mesh``), a prefill or decode cell's
cache split by kv heads over "model" or by sequence over "model" or the
data axes, the sequence's partials merged across ranks, a train cell's
loss vocab-parallel; the recsys rule's large tables are row-sharded
over "model" (DLRM's by ``recsys.RowShardedBag``, the others'
lookups by ``recsys.lookup_rows``) and its large MLP weights
column-parallel (``recsys.mlp_apply``); the retrieval cell scores each
rank's candidate rows and merges the all-gathered blocks (repro's
shard_map); SchNet's edges are split over every axis and its node
rows over the data-parallel axes (``models/schnet``: each rank sums its
edges, an all-reduce a layer), its params and AdamW state replicated. A
train cell reduces each gradient by its leaf's spec
(``train/train_loop``) and updates its ZeRO-1 blocks
(``train/zero``): its optimizer state is made at those blocks (SchNet's
whole, as repro's).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import get_arch, list_archs
from ..configs import schnet as schnet_cfg
from ..kernels.common import merge_candidates, resolve_device
from ..kernels.topk_search.ops import topk_search
from ..models import recsys as recsys_m
from ..models import schnet as schnet_m
from ..models import tp
from ..models import transformer as tfm
from ..models.bridge import train_tree
from ..models.moe import sharded_moe_applicable
from ..train.optimizer import Optimizer, adafactor, adamw
from ..train.train_loop import grad_accum_value_and_grad
from ..train.zero import ZeroLayout
from . import sharding as shd
from .collectives import all_gather
from .mesh import axis_size, coordinate, dp_axes

ADAFACTOR_THRESHOLD = 100e9        # params above this use factored state

# Gradient-accumulation (microbatch) factors of the FULL train cells, as
# repro sizes them; reduced configs use 1.
TRAIN_ACCUM_STEPS = {
    "mistral-nemo-12b": 8,
    "nemotron-4-15b": 16,
    "qwen1.5-32b": 16,
    "kimi-k2-1t-a32b": 8,
    "qwen2-moe-a2.7b": 8,
    "bert4rec": 16,           # 65k x 200-seq Cloze batches
}

_INIT = {"fm": recsys_m.fm_init, "dlrm-mlperf": recsys_m.dlrm_init,
         "wide-deep": recsys_m.widedeep_init,
         "schnet": schnet_m.init_params}


def effective_accum(preferred: int, global_batch: int, mesh=None) -> int:
    """Microbatches must keep the PER-MICROBATCH global batch divisible
    by (and >= ) the DP extent, or the batch could not be split over it.
    Clamp the preferred factor to global_batch // dp (repro's rule); on
    one card (``mesh`` None) the preferred factor stands."""
    if mesh is None:
        return preferred
    dp = axis_size(mesh, dp_axes(mesh))
    return max(1, min(preferred, global_batch // dp))


@functools.lru_cache(maxsize=8)
def param_shapes(arch_name: str, cfg) -> dict:
    """The cell's param train tree on the ``meta`` device: shapes and
    dtypes, no values (repro's ``params_shape``). Cached: the dry run
    asks for each arch's tree once a cell and mesh; callers read it."""
    init = _INIT.get(arch_name, tfm.init_params)
    return train_tree(init(cfg, seed=0, device="meta"))


@dataclasses.dataclass
class CellBundle:
    arch: str
    shape: str
    kind: str
    fn: Callable
    arg_specs: tuple
    model_cfg: Any
    device: torch.device
    optimizer: Optional[str] = None     # train cells
    accum: int = 1                      # train cells: microbatches a step
    loss: Optional[Callable] = None     # train cells: loss(params, batch)
    sharding_fn: Optional[Callable] = None   # mesh -> spec trees (repro's)
    mesh: Any = None                    # the rank's mesh (None: one card)
    opt: Optional[Optimizer] = None     # train cells: the optimizer ``fn``
    #                                     runs (ZeRO-1 on a mesh)

    @property
    def batch_index(self) -> int:
        return {"train": 2, "retrieval": 0}.get(self.kind, 1)

    def executed_specs(self) -> tuple:
        """(params spec tree or None, batch specs) that this rank's ``fn``
        executes sharded on ``mesh`` for its kind (``sharding.executed``,
        ``executed_batch``)."""
        trees = self.sharding_fn(self.mesh)
        pspec = None if self.kind == "retrieval" else \
            shd.executed(trees[0], self.kind)
        return pspec, shd.executed_batch(trees[self.batch_index], self.mesh,
                                         self.kind)


def _optimizer(name: str, layout=None) -> Optimizer:
    return adafactor(layout=layout) if name == "adafactor" else \
        adamw(layout=layout)


def base_config(cfg):
    """The arch's config of a bundle's ``model_cfg`` (a ``TPConfig``'s
    without the meshes): the config its param shapes and specs are made
    from."""
    return cfg.base() if isinstance(cfg, tfm.TPConfig) else cfg


def zero_layout(bundle: CellBundle, opt_name: Optional[str] = None,
                mesh=None, coord=None) -> ZeroLayout:
    """This rank's ZeRO-1 layout (``train/zero``) of the bundle's params
    under repro's specs on ``mesh`` (default ``bundle.mesh``), for the
    optimizer ``opt_name`` (default the cell's); ``coord`` places a rank
    of a ``launch/mesh.MeshShape`` (the dry run)."""
    mesh = mesh if mesh is not None else bundle.mesh
    cfg = bundle.model_cfg
    return ZeroLayout(param_shapes(bundle.arch, base_config(cfg)),
                      bundle.sharding_fn(mesh)[0],
                      opt_name or bundle.optimizer, mesh, coord,
                      getattr(cfg, "act", None))


def _sharding_fn(arch_name: str, kind: str, cfg, batch_specs,
                 param_rule, batch_rule, opt_name: Optional[str]):
    """mesh -> repro's spec trees of the cell's arguments."""

    def fn(mesh):
        bspec = batch_rule(batch_specs, mesh)
        if kind == "retrieval":
            return (bspec,)
        params = param_shapes(arch_name, cfg)
        pspec = param_rule(params, mesh)
        if kind != "train":
            return (pspec, bspec)
        opt_shape = _optimizer(opt_name).init(params)
        ospec = shd.replicated(opt_shape) if param_rule is \
            shd.gnn_param_specs else shd.zero1_opt_specs(pspec, opt_shape,
                                                         mesh)
        return (pspec, ospec, bspec, shd.P())

    return fn


def _train_bundle(arch_name: str, shape: str, reduced: bool, loss,
                  opt_name: str, accum: Optional[int], batch_specs, cfg,
                  device, sharding_fn, mesh, zero: bool = True
                  ) -> CellBundle:
    if accum is None:
        global_batch = next(iter(batch_specs.values())).shape[0]
        accum = effective_accum(
            1 if reduced else TRAIN_ACCUM_STEPS.get(arch_name, 1),
            global_batch, mesh)
    bundle = CellBundle(arch_name, shape, "train", None,
                        (None, None, batch_specs, None), cfg, device,
                        opt_name, accum, loss, sharding_fn, mesh)
    specs = None if mesh is None else bundle.executed_specs()[0]
    vg = grad_accum_value_and_grad(loss, accum, mesh, specs)
    opt = bundle.opt = _optimizer(
        opt_name, zero_layout(bundle) if mesh is not None and zero else None)

    def fn(params, opt_state, batch, step):
        l, grads = vg(params, batch)
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, l

    bundle.fn = fn
    return bundle


def _lm_optimizer(cfg) -> str:
    return "adafactor" if cfg.n_params() > ADAFACTOR_THRESHOLD else "adamw"


def _lm_bundle(arch_name: str, shape: str, reduced: bool, cfg,
               device: torch.device, accum: Optional[int],
               mesh) -> CellBundle:
    spec = get_arch(arch_name)
    cell = spec.cell(shape)
    batch_specs = spec.input_specs(shape, reduced)
    global_batch = batch_specs["tokens"].shape[0]
    opt_name = _lm_optimizer(cfg) if cell.kind == "train" else None

    def batch_rule(b, m):
        return shd.lm_batch_specs(b, m, cfg, cell.kind,
                                  long_context=shape.startswith("long"))

    sharding_fn = _sharding_fn(arch_name, cell.kind, cfg, batch_specs,
                               shd.lm_param_specs, batch_rule, opt_name)
    if mesh is not None and cfg.moe is not None and \
            sharded_moe_applicable(cfg.moe, mesh, cfg.d_model,
                                   batch=global_batch):
        cfg = dataclasses.replace(cfg, moe_mesh=mesh)
    if mesh is not None:
        cache = batch_rule(batch_specs, mesh).get("cache_k")
        cfg = tfm.TPConfig.of(
            cfg, mesh, () if cache is None else shd._axes(cache[3]))

    if cell.kind == "train":
        return _train_bundle(arch_name, shape, reduced,
                             lambda p, b: tfm.loss_fn(p, b, cfg), opt_name,
                             accum, batch_specs, cfg, device, sharding_fn,
                             mesh)
    if cell.kind == "prefill":
        seq = batch_specs["tokens"].shape[1]

        def fn(params, batch):
            return tfm.prefill(params, batch["tokens"], cfg, cache_size=seq)
    elif cell.kind == "decode":
        def fn(params, batch):
            # the cache is written in place; it is returned as repro's is
            cache = {"k": batch["cache_k"], "v": batch["cache_v"]}
            logits, new_cache, new_len = tfm.decode_step(
                params, batch["tokens"], cache, batch["cache_len"], cfg)
            return logits, new_cache["k"], new_cache["v"], new_len
    else:
        assert cell.kind == "encode"

        def fn(params, batch):
            return tfm.forward_pooled(params, batch["tokens"], cfg)
    return CellBundle(arch_name, shape, cell.kind, fn, (None, batch_specs),
                      cfg, device, sharding_fn=sharding_fn, mesh=mesh)


_RECSYS_LOSSES = {"fm": recsys_m.fm_loss, "wide-deep": recsys_m.widedeep_loss,
                  "dlrm-mlperf": recsys_m.dlrm_loss,
                  "bert4rec": recsys_m.bert4rec_loss}


def retrieval_shard_topk(batch: dict, k: int, rank: int):
    """One rank's part of the sharded retrieval: the masked top-k of the
    query over the rank's block of candidate rows (rank r holds rows
    [r * n_loc, (r + 1) * n_loc)), its ids made global (-1 stays -1)."""
    n_loc = batch["candidates"].shape[0]
    s, i = topk_search(batch["query"].float(), batch["candidates"].float(),
                       batch["candidate_mask"], min(k, n_loc))
    return s, torch.where(i >= 0, i + rank * n_loc, i)


def _retrieval_fn(batch_specs, mesh) -> Callable:
    """The retrieval step: one masked top-k (``topk_search``) of the
    query over the candidates. On a mesh, repro's shard_map: each rank
    holds a block of the candidate rows (split over every axis), scores
    it (``retrieval_shard_topk``), and the (Q, k) blocks of all ranks
    are all-gathered and merged (stable by score, the blocks in row
    order, so ties keep the lower row, as one scan ranks them)."""
    k_top = min(100, batch_specs["candidates"].shape[0])
    if mesh is None or shd.recsys_batch_specs(
            batch_specs, mesh)["candidates"][0] is None:   # not divisible
        def fn(batch):
            return topk_search(batch["query"].float(),
                               batch["candidates"].float(),
                               batch["candidate_mask"], k_top)
        return fn
    every = tuple(mesh.mesh_dim_names)

    def fn(batch):
        sizes, coord, rank = dict(zip(every, mesh.shape)), \
            coordinate(mesh), 0
        for a in every:
            rank = rank * sizes[a] + coord[a]
        s, i = retrieval_shard_topk(batch, k_top, rank)
        s_all = all_gather(s[None], mesh, every, dim=0)
        i_all = all_gather(i[None], mesh, every, dim=0)
        return merge_candidates(s_all, i_all,
                                min(k_top, s_all.shape[0] * s.shape[1]))
    return fn


def _recsys_bundle(arch_name: str, shape: str, reduced: bool, cfg,
                   device: torch.device, accum: Optional[int],
                   mesh) -> CellBundle:
    spec = get_arch(arch_name)
    cell = spec.cell(shape)
    batch_specs = spec.input_specs(shape, reduced)
    param_rule = shd.lm_param_specs if arch_name == "bert4rec" \
        else shd.recsys_param_specs
    sharding_fn = _sharding_fn(arch_name, cell.kind, cfg, batch_specs,
                               param_rule, shd.recsys_batch_specs, "adamw")

    if cell.kind == "retrieval":
        return CellBundle(arch_name, shape, cell.kind,
                          _retrieval_fn(batch_specs, mesh), (batch_specs,),
                          cfg, device, sharding_fn=sharding_fn, mesh=mesh)
    bag = {}
    if mesh is not None and arch_name == "bert4rec":
        cfg = tfm.TPConfig.of(cfg, mesh)
    elif mesh is not None:
        bag = {"mesh": mesh}
        if arch_name == "dlrm-mlperf":
            bag["bag"] = recsys_m.RowShardedBag(cfg, mesh)
    if cell.kind == "train":
        loss = _RECSYS_LOSSES[arch_name]
        return _train_bundle(arch_name, shape, reduced,
                             lambda p, b: loss(p, cfg, b, **bag), "adamw",
                             accum, batch_specs, cfg, device, sharding_fn,
                             mesh)
    assert cell.kind == "serve"

    if arch_name == "bert4rec":
        def fn(params, batch):
            return recsys_m.bert4rec_forward(params, cfg, batch["tokens"])
    elif arch_name == "dlrm-mlperf":
        def fn(params, batch):
            return recsys_m.dlrm_forward(params, cfg, batch["dense"],
                                         batch["sparse_ids"], **bag)
    else:
        fwd = {"fm": recsys_m.fm_forward,
               "wide-deep": recsys_m.widedeep_forward}[arch_name]

        def fn(params, batch):
            return fwd(params, cfg, batch["ids"], **bag)

    return CellBundle(arch_name, shape, cell.kind, fn, (None, batch_specs),
                      cfg, device, sharding_fn=sharding_fn, mesh=mesh)


def _gnn_bundle(arch_name: str, shape: str, reduced: bool, cfg,
                device: torch.device, accum: Optional[int],
                mesh) -> CellBundle:
    """SchNet's train cell: AdamW on ``energy_loss`` (molecules, with
    ``n_graphs`` from the shape) or ``node_class_loss``; one microbatch,
    as repro (``TRAIN_ACCUM_STEPS`` has no schnet). On a mesh the rank's
    step on its blocks of the batch at repro's ``gnn_batch_specs`` (the
    edges over every axis, the node rows over the data axes), its params
    and AdamW state whole (``gnn_param_specs``, repro's replicated
    state)."""
    if accum not in (None, 1):
        raise ValueError(f"{arch_name}: accum {accum}: a graph batch's rows "
                         f"are nodes and edges of one graph, not samples, "
                         f"so it is not cut into microbatches")
    spec = get_arch(arch_name)
    batch_specs = spec.input_specs(shape, reduced)
    info = (schnet_cfg.SHAPES_REDUCED if reduced
            else schnet_cfg.SHAPES)[shape]
    sharding_fn = _sharding_fn(arch_name, "train", cfg, batch_specs,
                               shd.gnn_param_specs, shd.gnn_batch_specs,
                               "adamw")
    place = {} if mesh is None else dict(
        mesh=mesh, specs=shd.executed_batch(sharding_fn(mesh)[2], mesh))
    if info.get("molecular"):
        n_graphs = info["graphs"]

        def loss(params, batch):
            return schnet_m.energy_loss(params, cfg,
                                        dict(batch, n_graphs=n_graphs),
                                        **place)
    else:
        def loss(params, batch):
            return schnet_m.node_class_loss(params, cfg, batch, **place)
    return _train_bundle(arch_name, shape, reduced, loss, "adamw", 1,
                         batch_specs, cfg, device, sharding_fn, mesh,
                         zero=False)


def build_cell(arch_name: str, shape: str, reduced: bool = False,
               device=None, accum: Optional[int] = None,
               model_cfg=None, mesh=None) -> CellBundle:
    """The bundle of one (arch x shape) cell. ``device`` (None = the
    card) is where ``make_smoke_args`` puts its arrays. ``accum``
    overrides a train cell's microbatch count (repro's: 1 reduced, else
    ``TRAIN_ACCUM_STEPS``, clamped on a mesh by ``effective_accum``), for
    a card that holds less of the step. ``model_cfg`` replaces the arch's
    ``model_config(reduced)``, for a cut of it that one card holds (fewer
    layers, capped tables); the cell's shapes and batch stay the arch's,
    and an LM's optimizer follows the config's parameter count, as
    repro's does. A GNN cell's config depends on its shape
    (``model_config(reduced, shape)``) and it takes no ``accum`` but 1.
    ``mesh`` (a ``DeviceMesh`` over the process group, ``launch/mesh``)
    makes ``fn`` this rank's step (module docstring); None is one card,
    bit for bit what it was before meshes."""
    if arch_name not in list_archs():
        raise NotImplementedError(
            f"{arch_name}: not ported; the port registers {list_archs()}")
    spec = get_arch(arch_name)
    gnn = spec.family == "gnn"
    if model_cfg is None:
        model_cfg = spec.model_config(reduced, shape) if gnn else \
            spec.model_config(reduced)
    build = {"gnn": _gnn_bundle, "recsys": _recsys_bundle}.get(spec.family,
                                                               _lm_bundle)
    return build(arch_name, shape, reduced, model_cfg,
                 resolve_device(device), accum, mesh)


# ---------------------------------------------------------------------------
# smoke-test batch materialization (real arrays)
# ---------------------------------------------------------------------------
def smoke_batch(bundle: CellBundle, seed: int = 0,
                rng: Optional[np.random.Generator] = None) -> dict:
    """The batch of ``make_smoke_args`` alone (a train loop's fresh batch
    each step, without a new init): arrays drawn from ``rng`` (default
    ``np.random.default_rng(seed)``) in repro's order, on
    ``bundle.device``."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    cfg, dev = bundle.model_cfg, bundle.device
    specs = bundle.arg_specs[bundle.batch_index]

    def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                             dtype=dtype)

    def batch_arrays(batch_specs: dict) -> dict:
        out = {}
        for name, s in batch_specs.items():
            shape = s.shape
            if name == "tokens":
                vocab = getattr(cfg, "vocab", 100)
                out[name] = put(rng.integers(4, vocab, shape), torch.int32)
            elif name in ("cache_k", "cache_v"):
                out[name] = torch.zeros(shape, dtype=s.dtype, device=dev)
            elif name == "labels":
                if s.dtype.is_floating_point:
                    out[name] = put(rng.integers(0, 2, shape).astype(
                        np.float32), torch.float32)
                else:
                    hi = getattr(cfg, "vocab", None) or \
                        getattr(cfg, "n_classes", None) or 100
                    out[name] = put(rng.integers(0, hi, shape), torch.int32)
            elif name == "cache_len":
                out[name] = torch.tensor(2, dtype=torch.int32)
            elif name == "edge_index":
                n_nodes = next(specs[k].shape[0] for k in specs
                               if k in ("node_feat", "atom_z"))
                out[name] = put(rng.integers(0, n_nodes, shape), torch.int32)
            elif name == "edge_dist":
                out[name] = put((rng.random(shape) * 9).astype(np.float32),
                                torch.float32)
            elif name == "node_feat":
                out[name] = put(rng.standard_normal(shape).astype(
                    np.float32), torch.float32)
            elif name == "atom_z":
                out[name] = put(rng.integers(1, 50, shape), torch.int32)
            elif name == "graph_ids":
                n_graphs = specs["energy"].shape[0]
                out[name] = put(np.repeat(np.arange(n_graphs),
                                          shape[0] // n_graphs),
                                torch.int32)
            elif name == "energy":
                out[name] = put(rng.standard_normal(shape).astype(
                    np.float32), torch.float32)
            elif name == "ids":
                out[name] = put(rng.integers(0, cfg.total_vocab, shape),
                                torch.int32)
            elif name == "dense":
                out[name] = put(rng.random(shape).astype(np.float32),
                                torch.float32)
            elif name == "sparse_ids":
                vmax = min(cfg.table_sizes)
                out[name] = put(rng.integers(0, vmax, shape), torch.int32)
            elif name in ("query", "candidates"):
                x = rng.standard_normal(shape).astype(np.float32)
                x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                                1e-9)
                out[name] = put(x, torch.float32)
            elif name == "candidate_mask":
                m = np.ones(shape, bool)
                m[-max(1, shape[0] // 100):] = False   # padded tail
                out[name] = put(m, torch.bool)
            else:
                raise KeyError(f"no smoke generator for {name}")
        return out

    return batch_arrays(specs)


def make_smoke_args(bundle: CellBundle, seed: int = 0,
                    params=None) -> tuple:
    """Real arrays matching ``bundle.arg_specs``, on ``bundle.device``.
    The batch comes from ``np.random.default_rng(seed)``, drawn array by
    array in the order and with the calls of repro's ``make_smoke_args``,
    so one seed gives both packages the same batch. ``params`` fills a
    model cell's params slot (for example repro's, carried by
    ``models/bridge``; a train cell takes a train tree,
    ``bridge.train_tree`` or ``tree_from_numpy``); None makes the port's
    own seeded init. A train cell returns (params, opt_state, batch,
    step 0): the optimizer's fresh state (on a mesh made at the rank's
    ZeRO-1 blocks, never whole) and a 0-d int32 step. A decode
    cell's ``cache_len`` stays on the host, a 0-d int32 tensor: the
    port's ``decode_step`` reads it there (it picks flash_decode's
    split), so reading it costs no device sync. On a mesh, the rank's
    blocks of the same arrays (``shard_args``)."""
    if bundle.kind == "retrieval":
        args = (smoke_batch(bundle, seed),)
        return args if bundle.mesh is None else shard_args(bundle, args)
    if params is None:
        init = _INIT.get(bundle.arch, tfm.init_params)
        params = init(bundle.model_cfg, seed=seed, device=bundle.device)
    if bundle.kind == "train" or bundle.mesh is not None:
        params = train_tree(params)
    if bundle.kind == "train":
        args = (params, None if bundle.mesh is not None else
                bundle.opt.init(params), smoke_batch(bundle, seed),
                torch.tensor(0, dtype=torch.int32, device=bundle.device))
    else:
        args = (params, smoke_batch(bundle, seed))
    return args if bundle.mesh is None else shard_args(bundle, args)


def shard_args(bundle: CellBundle, args: tuple) -> tuple:
    """The blocks of the whole arguments ``args`` (``make_smoke_args``
    without a mesh: a train tree of params; a train cell's optimizer
    state is not read and may be None) that this rank of
    ``bundle.mesh`` holds, as copies (a gated leaf as
    ``models/tp.serving_blocks`` cuts it); a train cell's optimizer
    state is made at the rank's ZeRO-1 blocks of those params
    (``bundle.opt.init``)."""
    pspec, bspec = bundle.executed_specs()
    batch = shd.distribute_tree(args[bundle.batch_index], bspec,
                                bundle.mesh, copy=True)
    if bundle.kind == "retrieval":
        return (batch,)
    params = tp.serving_blocks(args[0], pspec, bundle.mesh,
                               getattr(bundle.model_cfg, "act", ""))
    if bundle.kind != "train":
        return params, batch
    return params, bundle.opt.init(params), batch, args[3]
