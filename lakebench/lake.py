"""Builds the store under test from a ``History`` through the port's
public entry points: one ``ColdTier.commit`` a version, then
``LiveVectorLake(root)``, whose ``recover()`` builds the hot tier."""
from __future__ import annotations

import os

import numpy as np

from .generator import History, chunk_id, doc_id, passage_text


def write_cold(root: str, hist: History, cfg: dict, rows: np.ndarray) -> None:
    """Commit the plan into a cold tier at ``root``/cold. ``rows`` is the
    history's embedding column on the host."""
    from repro_torch.core.cold_tier import ColdTier
    from repro_torch.core.types import STATUS_SUPERSEDED, ChunkRecord

    store = cfg["store"]
    per = hist.per_doc
    cold = ColdTier(os.path.join(root, "cold"), int(cfg["dim"]),
                    checkpoint_interval=int(store["cold_checkpoint_interval"]),
                    quant_sidecar=bool(store["quantized"]))
    for c, (lo, hi) in enumerate(hist.bounds):
        ts = hist.instants[c]
        recs = [ChunkRecord(chunk_id=chunk_id(r), doc_id=doc_id(key // per),
                            position=key % per, valid_from=ts,
                            text=passage_text(key, c), embedding=emb)
                for r, key, emb in zip(range(lo, hi),
                                       hist.key[lo:hi].tolist(), rows[lo:hi])]
        closures = [{"doc_id": doc_id(key // per), "position": key % per,
                     "closed_at": ts, "status": STATUS_SUPERSEDED}
                    for key in hist.closed[c].tolist()]
        cold.commit(recs, closures, ts)


def open_lake(root: str, cfg: dict, device):
    """Open (and so recover) the store with the configuration's settings,
    and check that the ones the facade does not take are the port's
    defaults the configuration states."""
    from repro_torch.core.store import LiveVectorLake

    store = cfg["store"]
    lake = LiveVectorLake(
        root, dim=int(cfg["dim"]), hot_capacity=int(store["hot_capacity"]),
        cold_checkpoint_interval=int(store["cold_checkpoint_interval"]),
        quantized=bool(store["quantized"]),
        rescore_factor=int(store["rescore_factor"]), device=device)
    idx = lake.hot.index
    emb = lake.embedder.inner
    got = {"nprobe": idx.nprobe, "ivf_min_rows": idx.ivf_min_rows,
           "embedder_dim": emb.dim, "embedder_hashes": emb.n_hashes,
           "embedder_seed": emb.seed}
    want = {"nprobe": store["nprobe"], "ivf_min_rows": store["ivf_min_rows"],
            "embedder_dim": cfg["embedder"]["dim"],
            "embedder_hashes": cfg["embedder"]["n_hashes"],
            "embedder_seed": cfg["embedder"]["seed"]}
    if got != want:
        raise RuntimeError(f"store settings {got} differ from the "
                           f"configuration's {want}")
    return lake
