"""Shard fabric: consistent-hash scatter-gather serving layer over
shard-local LiveVectorLakes (DESIGN.md §10)."""
from .manifest import FabricManifest
from .planner import (ScatterGatherPlanner, ShardGatherError,
                      device_fanout_topk, results_equivalent)
from .rebalance import MigrationInterrupted, Rebalancer
from .ring import HashRing
from .shard import CorruptFabricManifest, ShardFabric, ShardLake

__all__ = [
    "CorruptFabricManifest", "FabricManifest", "HashRing",
    "MigrationInterrupted", "Rebalancer", "ScatterGatherPlanner",
    "ShardFabric", "ShardGatherError", "ShardLake", "device_fanout_topk",
    "results_equivalent",
]
