"""Consistent-hash router: doc_id -> owning shard set (DESIGN.md §10.1).

The ring is the standard consistent-hash construction: every shard
contributes ``vnodes`` virtual nodes (tokens = SHA-256 of
``"{shard}#{v}"``), a document hashes to a point on the same circle, and
its owners are the first ``replicas`` DISTINCT shards found walking
clockwise from that point. Properties the fabric depends on:

  - deterministic: owners depend only on (shard ids, vnodes, replicas,
    doc_id) — every process that loads the same fabric manifest routes
    identically.
  - minimal movement: adding/removing one shard re-homes only the keys
    whose successor walk crosses that shard's tokens (~1/S of the
    corpus), which is exactly the set ``diff_owners`` reports to the
    rebalancer.
  - replication: ``owners`` returns ``replicas`` distinct shards,
    primary first; a record therefore lives on R shard-local lakes and
    the planner can tolerate R-1 shard failures.

The ring itself is immutable; ``with_shard`` / ``without_shard`` /
``with_replicas`` derive the target ring a rebalance transitions to.
"""
from __future__ import annotations

import bisect
import hashlib


def _token(s: str) -> int:
    """64-bit ring position of an arbitrary string (stable across runs,
    unlike ``hash()``)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, shards: list[str], vnodes: int = 64,
                 replicas: int = 1):
        if not shards:
            raise ValueError("ring needs at least one shard")
        if len(set(shards)) != len(shards):
            raise ValueError(f"duplicate shard ids: {shards}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.shards = sorted(shards)
        self.vnodes = vnodes
        self.replicas = min(replicas, len(self.shards))
        points = [(_token(f"{s}#{v}"), s)
                  for s in self.shards for v in range(vnodes)]
        points.sort()
        self._tokens = [t for t, _ in points]
        self._owners_at = [s for _, s in points]

    # ------------------------------------------------------------------
    def owners(self, doc_id: str) -> tuple[str, ...]:
        """The ``replicas`` distinct shards owning ``doc_id``, primary
        first (clockwise successor order)."""
        start = bisect.bisect_right(self._tokens, _token(doc_id))
        out: list[str] = []
        n = len(self._tokens)
        for i in range(n):
            s = self._owners_at[(start + i) % n]
            if s not in out:
                out.append(s)
                if len(out) == self.replicas:
                    break
        return tuple(out)

    def primary(self, doc_id: str) -> str:
        return self.owners(doc_id)[0]

    # ------------------------------------------------------------------
    # derived rings (rebalance targets)
    # ------------------------------------------------------------------
    def with_shard(self, shard_id: str) -> "HashRing":
        if shard_id in self.shards:
            raise ValueError(f"shard {shard_id!r} already in ring")
        return HashRing(self.shards + [shard_id], self.vnodes,
                        self.replicas)

    def without_shard(self, shard_id: str) -> "HashRing":
        if shard_id not in self.shards:
            raise ValueError(f"shard {shard_id!r} not in ring")
        rest = [s for s in self.shards if s != shard_id]
        return HashRing(rest, self.vnodes, min(self.replicas, len(rest)))

    def with_replicas(self, replicas: int) -> "HashRing":
        return HashRing(list(self.shards), self.vnodes, replicas)

    def diff_owners(self, target: "HashRing", doc_ids) -> dict[str, tuple]:
        """{doc_id: (old_owners, new_owners)} for every doc whose owner
        SET changes between this ring and ``target`` — the rebalancer's
        migration work-list."""
        out = {}
        for d in doc_ids:
            old, new = self.owners(d), target.owners(d)
            if set(old) != set(new):
                out[d] = (old, new)
        return out

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"shards": list(self.shards), "vnodes": self.vnodes,
                "replicas": self.replicas}

    @classmethod
    def from_dict(cls, d: dict) -> "HashRing":
        return cls(list(d["shards"]), int(d["vnodes"]),
                   int(d["replicas"]))

    def __eq__(self, other) -> bool:
        return (isinstance(other, HashRing)
                and self.to_dict() == other.to_dict())

    def __repr__(self) -> str:
        return (f"HashRing(shards={self.shards}, vnodes={self.vnodes}, "
                f"replicas={self.replicas})")
