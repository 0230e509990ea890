"""Cell bundles of the port: for every (arch x shape) cell it serves, the
concrete step function and real arrays to drive it (repro's
``launch/steps.py`` without JAX, sharding or lowering).

A ``CellBundle`` packages:
  - fn(params, opt_state, batch, step) -> (params, opt_state, loss) for a
    train cell (params and opt_state updated in place), fn(params, batch)
    for a serve, prefill, decode or encode cell, fn(batch) for a
    retrieval cell,
  - arg_specs: the ``configs.base.Spec`` trees of its arguments (a
    params or opt_state slot is None: its shapes are the model's),
  - model_cfg, the device its arrays go to, and for a train cell its
    optimizer's name and gradient-accumulation factor.

Ported: every kind of the LM family (``train``, ``prefill``, ``decode``;
``long_500k`` is a decode cell, on one card), the embedder's ``encode``
and the recsys family's ``train``, ``serve`` and ``retrieval``. A train
cell's params are repro's tree (layers stacked for a transformer,
``models/bridge.train_tree``), so the optimizer, the gradient
compression and the checkpoint see repro's leaves. SchNet, whose only
cell is ``train``, waits for ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import get_arch, list_archs
from ..kernels.common import resolve_device
from ..kernels.topk_search.ops import topk_search
from ..models import recsys as recsys_m
from ..models import transformer as tfm
from ..models.bridge import train_tree
from ..train.optimizer import Optimizer, adafactor, adamw
from ..train.train_loop import grad_accum_value_and_grad

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
         "wide-deep": recsys_m.widedeep_init}


def effective_accum(preferred: int, mesh=None) -> int:
    """repro clamps the accumulation factor so that each microbatch still
    spans the data-parallel extent of its mesh; on one card (``mesh``
    None) the preferred factor stands. Meshes wait for ROADMAP Queue 1
    item 13."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported (ROADMAP Queue 1 "
                                  "item 13)")
    return preferred


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


def _train_bundle(arch_name: str, shape: str, reduced: bool, loss,
                  opt_name: str, opt: Optimizer, accum: Optional[int],
                  batch_specs, cfg, device) -> CellBundle:
    if accum is None:
        accum = effective_accum(
            1 if reduced else TRAIN_ACCUM_STEPS.get(arch_name, 1))
    vg = grad_accum_value_and_grad(loss, accum)

    def fn(params, opt_state, batch, step):
        l, grads = vg(params, batch)
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, l

    return CellBundle(arch_name, shape, "train", fn,
                      (None, None, batch_specs, None), cfg, device,
                      opt_name, accum, loss)


def _lm_optimizer(cfg) -> tuple[str, Optimizer]:
    if cfg.n_params() > ADAFACTOR_THRESHOLD:
        return "adafactor", adafactor()
    return "adamw", adamw()


def _lm_bundle(arch_name: str, shape: str, reduced: bool, cfg,
               device: torch.device, accum: Optional[int]) -> CellBundle:
    spec = get_arch(arch_name)
    cell = spec.cell(shape)
    batch_specs = spec.input_specs(shape, reduced)

    if cell.kind == "train":
        opt_name, opt = _lm_optimizer(cfg)
        return _train_bundle(arch_name, shape, reduced,
                             lambda p, b: tfm.loss_fn(p, b, cfg), opt_name,
                             opt, accum, batch_specs, cfg, device)
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
                      cfg, device)


_RECSYS_LOSSES = {"fm": recsys_m.fm_loss, "wide-deep": recsys_m.widedeep_loss,
                  "dlrm-mlperf": recsys_m.dlrm_loss,
                  "bert4rec": recsys_m.bert4rec_loss}


def _recsys_bundle(arch_name: str, shape: str, reduced: bool, cfg,
                   device: torch.device, accum: Optional[int]) -> CellBundle:
    spec = get_arch(arch_name)
    cell = spec.cell(shape)
    batch_specs = spec.input_specs(shape, reduced)

    if cell.kind == "retrieval":
        k_top = min(100, batch_specs["candidates"].shape[0])

        def retrieval_fn(batch):
            # one card: the masked top-k of repro's shard_map (local top-k
            # + all-gather + merge) is one fused scan
            return topk_search(batch["query"].float(),
                               batch["candidates"].float(),
                               batch["candidate_mask"], k_top)

        return CellBundle(arch_name, shape, cell.kind, retrieval_fn,
                          (batch_specs,), cfg, device)
    if cell.kind == "train":
        loss = _RECSYS_LOSSES[arch_name]
        return _train_bundle(arch_name, shape, reduced,
                             lambda p, b: loss(p, cfg, b), "adamw", adamw(),
                             accum, batch_specs, cfg, device)
    assert cell.kind == "serve"

    if arch_name == "bert4rec":
        def fn(params, batch):
            return recsys_m.bert4rec_forward(params, cfg, batch["tokens"])
    elif arch_name == "dlrm-mlperf":
        def fn(params, batch):
            return recsys_m.dlrm_forward(params, cfg, batch["dense"],
                                         batch["sparse_ids"])
    else:
        fwd = {"fm": recsys_m.fm_forward,
               "wide-deep": recsys_m.widedeep_forward}[arch_name]

        def fn(params, batch):
            return fwd(params, cfg, batch["ids"])

    return CellBundle(arch_name, shape, cell.kind, fn, (None, batch_specs),
                      cfg, device)


def build_cell(arch_name: str, shape: str, reduced: bool = False,
               device=None, accum: Optional[int] = None,
               model_cfg=None) -> CellBundle:
    """The bundle of one (arch x shape) cell. ``device`` (None = the
    card) is where ``make_smoke_args`` puts its arrays. ``accum``
    overrides a train cell's microbatch count (repro's: 1 reduced, else
    ``TRAIN_ACCUM_STEPS``), for a card that holds less of the step.
    ``model_cfg`` replaces the arch's ``model_config(reduced)``, for a
    cut of it that one card holds (fewer layers, capped tables); the
    cell's shapes and batch stay the arch's, and an LM's optimizer
    follows the config's parameter count, as repro's does."""
    if arch_name not in list_archs():
        raise NotImplementedError(
            f"{arch_name}: not ported; the port registers {list_archs()} "
            f"(SchNet, whose only cell is train, waits for ROADMAP Queue 1 "
            f"item 12)")
    spec = get_arch(arch_name)
    build = _recsys_bundle if spec.family == "recsys" else _lm_bundle
    cfg = spec.model_config(reduced) if model_cfg is None else model_cfg
    return build(arch_name, shape, reduced, cfg, resolve_device(device),
                 accum)


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

    idx = {"train": 2, "retrieval": 0}.get(bundle.kind, 1)
    return batch_arrays(bundle.arg_specs[idx])


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
    step 0): the optimizer's fresh state and a 0-d int32 step. A decode
    cell's ``cache_len`` stays on the host, a 0-d int32 tensor: the
    port's ``decode_step`` reads it there (it picks flash_decode's
    split), so reading it costs no device sync."""
    if bundle.kind == "retrieval":
        return (smoke_batch(bundle, seed),)
    if params is None:
        init = _INIT.get(bundle.arch, tfm.init_params)
        params = init(bundle.model_cfg, seed=seed, device=bundle.device)
        if bundle.kind == "train":
            params = train_tree(params)
    if bundle.kind == "train":
        opt = adafactor() if bundle.optimizer == "adafactor" else adamw()
        return (params, opt.init(params), smoke_batch(bundle, seed),
                torch.tensor(0, dtype=torch.int32, device=bundle.device))
    return params, smoke_batch(bundle, seed)
