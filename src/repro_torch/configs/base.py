"""Architecture/shape registry of the port, repro's ``configs/base.py``
without JAX.

Every ported architecture ships as one ``configs/<id>.py`` exposing
``ARCH``, an ``ArchSpec`` whose ``cells()`` are its assigned input
shapes. An (arch x shape) cell determines the step function
(``launch/steps.build_cell``), the exact input specs (``Spec``: shape
and torch dtype, no allocation) and a REDUCED variant of the same family
for the CPU tests. ``ARCH_MODULES`` is repro's list: the LM family, the
GNN (SchNet, whose cells are all ``train``), the recsys family and the
embedder.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

f32 = torch.float32
bf16 = torch.bfloat16
i32 = torch.int32
bool_ = torch.bool


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of one input array (repro: jax.ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def sds(shape, dtype: torch.dtype) -> Spec:
    return Spec(tuple(shape), dtype)


@dataclasses.dataclass(frozen=True)
class Cell:
    """(architecture x input-shape) pair."""
    arch: str
    shape: str
    kind: str            # train | prefill | decode | serve | retrieval

    @property
    def key(self) -> str:
        return f"{self.arch}/{self.shape}"


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                           # lm | gnn | recsys
    source: str                           # public-literature citation tag
    model_config: Callable[[bool], Any]   # (reduced) -> family config obj
    cells: Callable[[], list[Cell]]
    input_specs: Callable[[str, bool], dict]   # (shape, reduced) -> specs

    def cell(self, shape: str) -> Cell:
        for c in self.cells():
            if c.shape == shape:
                return c
        raise KeyError(f"{self.name}: unknown shape {shape!r}")


_REGISTRY: dict[str, ArchSpec] = {}

ARCH_MODULES = (
    "mistral_nemo_12b", "nemotron_4_15b", "qwen1_5_32b", "kimi_k2_1t_a32b",
    "qwen2_moe_a2_7b", "schnet", "fm", "bert4rec", "dlrm_mlperf",
    "wide_deep", "minilm_embedder",
)


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(f"{__package__}.{mod}")


def get_arch(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def all_cells() -> list[Cell]:
    return [c for name in list_archs() for c in _REGISTRY[name].cells()]
