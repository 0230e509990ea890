"""Shared cell and input-spec helpers for the recsys family.

Shapes (assigned):
  train_batch     batch=65,536                (training)
  serve_p99       batch=512                   (online inference)
  serve_bulk      batch=262,144               (offline scoring)
  retrieval_cand  batch=1 n_candidates=1e6    (retrieval scoring: the
                  LiveVectorLake hot-tier kernel, not a loop)
"""
from __future__ import annotations

from .base import Cell, bool_, f32, i32, sds

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    # n_candidates is carried as a capacity-padded slab (1e6 -> 512*1954 =
    # 1,000,448 rows + active mask): the hot tier's slot-array layout
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000, n_pad=1_000_448),
}
RECSYS_SHAPES_REDUCED = {
    "train_batch": dict(kind="train", batch=32),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=64),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=512),
}


def recsys_cells(arch: str) -> list[Cell]:
    return [Cell(arch, s, RECSYS_SHAPES[s]["kind"]) for s in RECSYS_SHAPES]


def shape_info(shape: str, reduced: bool = False) -> dict:
    return (RECSYS_SHAPES_REDUCED if reduced else RECSYS_SHAPES)[shape]


def retrieval_specs(embed_dim: int, shape_i: dict) -> dict:
    n = shape_i.get("n_pad", shape_i["n_candidates"])
    return {
        "query": sds((shape_i["batch"], embed_dim), f32),
        "candidates": sds((n, embed_dim), f32),
        "candidate_mask": sds((n,), bool_),
    }


def ids_label_specs(batch: int, n_fields: int, with_labels: bool) -> dict:
    specs = {"ids": sds((batch, n_fields), i32)}
    if with_labels:
        specs["labels"] = sds((batch,), f32)
    return specs
