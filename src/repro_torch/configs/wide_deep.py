"""wide-deep [recsys] — n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat. [arXiv:1606.07792]"""
from __future__ import annotations

from ..models.recsys import WideDeepConfig
from .base import ArchSpec, register
from .recsys_family import (ids_label_specs, recsys_cells, retrieval_specs,
                            shape_info)

SOURCE = "arXiv:1606.07792"

CONFIG = WideDeepConfig(n_sparse=40, embed_dim=32, mlp=(1024, 512, 256),
                        vocab_per_field=1_000_000)
REDUCED = WideDeepConfig(n_sparse=6, embed_dim=8, mlp=(32, 16),
                         vocab_per_field=100)


def input_specs(shape: str, reduced: bool = False) -> dict:
    cfg = REDUCED if reduced else CONFIG
    info = shape_info(shape, reduced)
    if info["kind"] == "retrieval":
        return retrieval_specs(cfg.embed_dim, info)
    return ids_label_specs(info["batch"], cfg.n_sparse,
                           with_labels=(info["kind"] == "train"))


ARCH = register(ArchSpec(
    name="wide-deep", family="recsys", source=SOURCE,
    model_config=lambda reduced=False: REDUCED if reduced else CONFIG,
    cells=lambda: recsys_cells("wide-deep"),
    input_specs=input_specs,
))
