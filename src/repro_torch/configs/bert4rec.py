"""bert4rec [recsys] — embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq (Cloze objective). [arXiv:1904.06690]"""
from __future__ import annotations

from ..models.recsys import bert4rec_config
from .base import ArchSpec, i32, register, sds
from .recsys_family import recsys_cells, retrieval_specs, shape_info

SOURCE = "arXiv:1904.06690"

SEQ_LEN = 200
N_ITEMS = 30_000
CONFIG = bert4rec_config(n_items=N_ITEMS)
REDUCED = bert4rec_config(n_items=200, name="bert4rec-reduced")
SEQ_LEN_REDUCED = 16


def input_specs(shape: str, reduced: bool = False) -> dict:
    cfg = REDUCED if reduced else CONFIG
    info = shape_info(shape, reduced)
    s = SEQ_LEN_REDUCED if reduced else SEQ_LEN
    if info["kind"] == "retrieval":
        return retrieval_specs(cfg.d_model, info)
    b = info["batch"]
    specs = {"tokens": sds((b, s), i32)}
    if info["kind"] == "train":
        specs["labels"] = sds((b, s), i32)
    return specs


ARCH = register(ArchSpec(
    name="bert4rec", family="recsys", source=SOURCE,
    model_config=lambda reduced=False: REDUCED if reduced else CONFIG,
    cells=lambda: recsys_cells("bert4rec"),
    input_specs=input_specs,
))
