"""fm [recsys] — n_sparse=39 embed_dim=10 interaction=fm-2way: pairwise
<v_i, v_j> x_i x_j via the O(nk) sum-square trick. [Rendle, ICDM'10]"""
from __future__ import annotations

from ..models.recsys import FMConfig
from .base import ArchSpec, register
from .recsys_family import (ids_label_specs, recsys_cells, retrieval_specs,
                            shape_info)

SOURCE = "Rendle ICDM'10"

CONFIG = FMConfig(n_sparse=39, embed_dim=10, vocab_per_field=1_000_000)
REDUCED = FMConfig(n_sparse=6, embed_dim=10, vocab_per_field=100)


def input_specs(shape: str, reduced: bool = False) -> dict:
    cfg = REDUCED if reduced else CONFIG
    info = shape_info(shape, reduced)
    if info["kind"] == "retrieval":
        return retrieval_specs(cfg.embed_dim, info)
    return ids_label_specs(info["batch"], cfg.n_sparse,
                           with_labels=(info["kind"] == "train"))


ARCH = register(ArchSpec(
    name="fm", family="recsys", source=SOURCE,
    model_config=lambda reduced=False: REDUCED if reduced else CONFIG,
    cells=lambda: recsys_cells("fm"),
    input_specs=input_specs,
))
