"""Cell bundles of the port: for every (arch x shape) cell it serves, the
concrete step function and real arrays to drive it (repro's
``launch/steps.py`` without JAX, sharding or lowering).

A ``CellBundle`` packages:
  - fn(params, batch) for a serve, prefill, decode or encode cell,
    fn(batch) for a retrieval cell,
  - arg_specs: the ``configs.base.Spec`` trees of its arguments (a
    params slot is None: its shapes are the model's),
  - model_cfg and the device its arrays go to.

Ported: the LM family's ``prefill`` and ``decode`` kinds (``long_500k``
is a decode cell, on one card), the embedder's ``encode`` and the recsys
family's ``serve`` and ``retrieval``. Training cells, and SchNet, whose
only cell is ``train``, wait for ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..configs import get_arch, list_archs
from ..kernels.common import resolve_device
from ..kernels.topk_search.ops import topk_search
from ..models import recsys as recsys_m
from ..models import transformer as tfm

_INIT = {"fm": recsys_m.fm_init, "dlrm-mlperf": recsys_m.dlrm_init,
         "wide-deep": recsys_m.widedeep_init}


@dataclasses.dataclass
class CellBundle:
    arch: str
    shape: str
    kind: str
    fn: Callable
    arg_specs: tuple
    model_cfg: Any
    device: torch.device


def _not_ported(cell) -> NotImplementedError:
    return NotImplementedError(
        f"{cell.key}: {cell.kind} cells are not ported yet (training: "
        f"ROADMAP Queue 1 item 12)")


def _lm_bundle(arch_name: str, shape: str, reduced: bool, cfg,
               device: torch.device) -> CellBundle:
    spec = get_arch(arch_name)
    cell = spec.cell(shape)
    batch_specs = spec.input_specs(shape, reduced)

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
    elif cell.kind == "encode":
        def fn(params, batch):
            return tfm.forward_pooled(params, batch["tokens"], cfg)
    else:
        raise _not_ported(cell)
    return CellBundle(arch_name, shape, cell.kind, fn, (None, batch_specs),
                      cfg, device)


def _recsys_bundle(arch_name: str, shape: str, reduced: bool, cfg,
                   device: torch.device) -> CellBundle:
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
    if cell.kind != "serve":
        raise _not_ported(cell)

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
               device=None) -> CellBundle:
    """The bundle of one (arch x shape) cell. ``device`` (None = the
    card) is where ``make_smoke_args`` puts its arrays."""
    if arch_name not in list_archs():
        raise NotImplementedError(
            f"{arch_name}: not ported; the port registers {list_archs()} "
            f"(SchNet, whose only cell is train, waits for ROADMAP Queue 1 "
            f"item 12)")
    spec = get_arch(arch_name)
    build = _recsys_bundle if spec.family == "recsys" else _lm_bundle
    return build(arch_name, shape, reduced, spec.model_config(reduced),
                 resolve_device(device))


# ---------------------------------------------------------------------------
# smoke-test batch materialization (real arrays)
# ---------------------------------------------------------------------------
def make_smoke_args(bundle: CellBundle, seed: int = 0,
                    params=None) -> tuple:
    """Real arrays matching ``bundle.arg_specs``, on ``bundle.device``.
    The batch comes from ``np.random.default_rng(seed)``, drawn array by
    array in the order and with the calls of repro's ``make_smoke_args``,
    so one seed gives both packages the same batch. ``params`` fills a
    model cell's params slot (for example repro's, carried by
    ``models/bridge``); None makes the port's own seeded init. A decode
    cell's ``cache_len`` stays on the host, a 0-d int32 tensor: the
    port's ``decode_step`` reads it there (it picks flash_decode's
    split), so reading it costs no device sync."""
    rng = np.random.default_rng(seed)
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

    if bundle.kind == "retrieval":
        return (batch_arrays(bundle.arg_specs[0]),)
    if params is None:
        init = _INIT.get(bundle.arch, tfm.init_params)
        params = init(cfg, seed=seed, device=dev)
    return params, batch_arrays(bundle.arg_specs[1])

