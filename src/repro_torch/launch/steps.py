"""Cell bundles of the port: for every (arch x shape) cell it serves, the
concrete step function and real arrays to drive it (repro's
``launch/steps.py`` without JAX, sharding or lowering).

A ``CellBundle`` packages:
  - fn(params, batch) for a serve cell, fn(batch) for a retrieval cell,
  - arg_specs: the ``configs.base.Spec`` trees of its arguments (a
    params slot is None: its shapes are the model's),
  - model_cfg and the device its arrays go to.

Ported: the recsys family's ``serve`` and ``retrieval`` kinds. Training
cells wait for ROADMAP Queue 1 item 12, the other families for items 11
and 13.
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
         "wide-deep": recsys_m.widedeep_init,
         "bert4rec": tfm.init_params}


@dataclasses.dataclass
class CellBundle:
    arch: str
    shape: str
    kind: str
    fn: Callable
    arg_specs: tuple
    model_cfg: Any
    device: torch.device


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
        raise NotImplementedError(
            f"{cell.key}: {cell.kind} cells are not ported yet (training: "
            f"ROADMAP Queue 1 item 12)")

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
            f"{arch_name}: only the recsys family ({list_archs()}) is "
            f"ported; the other families wait for ROADMAP Queue 1 items "
            f"11 and 13")
    spec = get_arch(arch_name)
    return _recsys_bundle(arch_name, shape, reduced,
                          spec.model_config(reduced), resolve_device(device))


# ---------------------------------------------------------------------------
# smoke-test batch materialization (real arrays)
# ---------------------------------------------------------------------------
def make_smoke_args(bundle: CellBundle, seed: int = 0,
                    params=None) -> tuple:
    """Real arrays matching ``bundle.arg_specs``, on ``bundle.device``.
    The batch comes from ``np.random.default_rng(seed)``, drawn array by
    array in the order and with the calls of repro's ``make_smoke_args``,
    so one seed gives both packages the same batch. ``params`` fills a
    serve cell's params slot (for example repro's, carried by
    ``models/bridge``); None makes the port's own seeded init."""
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
        params = _INIT[bundle.arch](cfg, seed=seed, device=dev)
    return params, batch_arrays(bundle.arg_specs[1])

