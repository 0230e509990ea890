"""dlrm-mlperf [recsys] — n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot —
MLPerf DLRM benchmark config (Criteo 1TB table sizes). [arXiv:1906.00091]

``ONE_CARD`` is ``CONFIG`` with every table capped at 25,000,000 rows:
the published 26 tables padded to 256 rows hold 177,948,416 rows, 91.1
GB in fp32, more than one 80 GB H100; capped they hold 113,808,384
rows, 58.3 GB. Widths, the dot interaction, the MLPs and ``multi_hot``
stay as published. A deployment row-shards the tables over cards
instead (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses

from ..models.recsys import DLRMConfig
from .base import ArchSpec, f32, i32, register, sds
from .recsys_family import recsys_cells, retrieval_specs, shape_info

SOURCE = "arXiv:1906.00091 (MLPerf)"
ONE_CARD_ROWS = 25_000_000

CONFIG = DLRMConfig()                      # MLPerf table sizes baked in
ONE_CARD = dataclasses.replace(
    CONFIG, table_sizes=tuple(min(v, ONE_CARD_ROWS)
                              for v in CONFIG.table_sizes))
REDUCED = DLRMConfig(table_sizes=(64,) * 26, bot_mlp=(13, 32, 16, 8),
                     top_mlp=(32, 16, 1), embed_dim=8)


def input_specs(shape: str, reduced: bool = False) -> dict:
    cfg = REDUCED if reduced else CONFIG
    info = shape_info(shape, reduced)
    if info["kind"] == "retrieval":
        return retrieval_specs(cfg.embed_dim, info)
    b = info["batch"]
    specs = {
        "dense": sds((b, cfg.n_dense), f32),
        "sparse_ids": sds((b, cfg.n_sparse, cfg.multi_hot), i32),
    }
    if info["kind"] == "train":
        specs["labels"] = sds((b,), f32)
    return specs


ARCH = register(ArchSpec(
    name="dlrm-mlperf", family="recsys", source=SOURCE,
    model_config=lambda reduced=False: REDUCED if reduced else CONFIG,
    cells=lambda: recsys_cells("dlrm-mlperf"),
    input_specs=input_specs,
))
