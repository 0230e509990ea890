"""schnet [gnn] — n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]

Assigned shapes span three graph regimes; per DESIGN.md
§Arch-applicability the non-molecular shapes (citation / product graphs)
use the featureful-input variant (linear projection instead of the
atom-type embedding) with pipeline-synthesized edge distances, and a
node-classification readout:

  full_graph_sm   Cora-scale     n=2,708    e=10,556      d_feat=1,433
  minibatch_lg    Reddit-scale   n=232,965  e=114,615,892 sampled
                  batch_nodes=1,024 fanout=15-10 (real neighbor sampler,
                  data/sampler.py; padded static shapes below)
  ogb_products    n=2,449,029    e=61,859,140  d_feat=100  full-batch
  molecule        30 nodes / 64 edges x batch=128, energy regression
"""
from __future__ import annotations

import dataclasses

from ..models.schnet import SchNetConfig
from .base import ArchSpec, Cell, f32, i32, register, sds

CONFIG = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                      n_rbf=300, cutoff=10.0)

# fanout (15, 10) from 1024 seeds: layer sizes 1024 / 15,360 / 153,600
_MB_SEEDS = 1024
_MB_NODES = _MB_SEEDS * (1 + 15 + 15 * 10)          # 169,984 padded nodes
_MB_EDGES = _MB_SEEDS * (15 + 15 * 10)              # 168,960 padded edges


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


# Padded sizes are repro's, so both packages see the same shapes: edge
# counts pad to multiples of 512 (repro shards edges over every mesh
# axis), node counts to multiples of 32. Padded edges carry dist > cutoff
# => exactly zero message weight (data/sampler.py convention).
SHAPES = {
    "full_graph_sm": dict(kind="train", nodes=_pad(2708, 32),
                          edges=_pad(10556, 512), d_feat=1433, classes=7,
                          true_nodes=2708, true_edges=10556),
    "minibatch_lg": dict(kind="train", nodes=_MB_NODES, edges=_MB_EDGES,
                         d_feat=602, classes=41, seeds=_MB_SEEDS),
    "ogb_products": dict(kind="train", nodes=_pad(2449029, 32),
                         edges=_pad(61859140, 512), d_feat=100,
                         classes=47, true_nodes=2449029,
                         true_edges=61859140),
    "molecule": dict(kind="train", nodes=30 * 128, edges=64 * 128,
                     graphs=128, molecular=True),
}
SHAPES_REDUCED = {
    "full_graph_sm": dict(kind="train", nodes=64, edges=256, d_feat=16,
                          classes=7),
    "minibatch_lg": dict(kind="train", nodes=84, edges=80, d_feat=16,
                         classes=5, seeds=4),
    "ogb_products": dict(kind="train", nodes=128, edges=512, d_feat=16,
                         classes=8),
    "molecule": dict(kind="train", nodes=30 * 4, edges=64 * 4, graphs=4,
                     molecular=True),
}


def model_config(reduced: bool = False, shape: str = "molecule"
                 ) -> SchNetConfig:
    info = (SHAPES_REDUCED if reduced else SHAPES)[shape]
    base = CONFIG if not reduced else dataclasses.replace(
        CONFIG, n_interactions=2, d_hidden=16, n_rbf=20)
    if info.get("molecular"):
        return base
    return dataclasses.replace(base, d_feat=info["d_feat"],
                               n_classes=info["classes"])


def input_specs(shape: str, reduced: bool = False) -> dict:
    info = (SHAPES_REDUCED if reduced else SHAPES)[shape]
    n, e = info["nodes"], info["edges"]
    specs = {
        "edge_index": sds((2, e), i32),
        "edge_dist": sds((e,), f32),
    }
    if info.get("molecular"):
        specs.update({
            "atom_z": sds((n,), i32),
            "graph_ids": sds((n,), i32),
            "energy": sds((info["graphs"],), f32),
        })
    else:
        specs.update({
            "node_feat": sds((n, info["d_feat"]), f32),
            "labels": sds((n,), i32),     # -1 = non-seed (minibatch_lg)
        })
    return specs


ARCH = register(ArchSpec(
    name="schnet", family="gnn", source="arXiv:1706.08566",
    model_config=model_config,
    cells=lambda: [Cell("schnet", s, SHAPES[s]["kind"]) for s in SHAPES],
    input_specs=input_specs,
))
