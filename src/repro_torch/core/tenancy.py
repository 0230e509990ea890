"""Tenant namespace registry (DESIGN.md §14).

Every row in every tier carries a dense int32 tenant id alongside its
embedding, persisted in the same artifacts as the authority arrays
(segment npz, cold commit segments, checkpoint sidecars, archives).
This module owns the name <-> id mapping:

  - tid 0 is the default tenant "" — a store that never names a tenant
    writes all-zero tenant columns, and readers treat an ABSENT tenant
    column as all-zero, so pre-tenancy artifacts reopen unchanged.
  - ids are allocated append-only on first ingest for a name and
    persisted IMMEDIATELY (atomic rename) to TENANTS.json under the
    store root, before any row is written with that id. Ids are never
    renumbered or reused: a persisted tenant column stays decodable
    forever.
  - visibility resolution is read-only: unknown names resolve to no id,
    i.e. a query scoped to a tenant that never ingested sees nothing
    (fail-closed), it does not error.

Cross-shard migration serializes tenant NAMES, not ids (per-shard
registries allocate independently); the importing shard re-resolves
names through its own registry.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Iterable, Optional, Sequence, Union

import numpy as np

DEFAULT_TENANT = ""

# Per-query visibility spec: None = no scoping (every row visible,
# byte-identical to the pre-tenancy behavior), a single tenant name, or
# a sequence of names.
Visibility = Optional[Union[str, Sequence[str]]]


def visibility_key(visibility: Visibility) -> tuple:
    """Hashable canonical form — used for batch grouping and memo keys.
    () means unscoped; names are deduplicated and sorted."""
    if visibility is None:
        return ()
    if isinstance(visibility, str):
        return (visibility,)
    return tuple(sorted(set(visibility)))


class TenantRegistry:
    """Append-only name -> int32 id map persisted as TENANTS.json."""

    FILENAME = "TENANTS.json"

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self._path = (os.path.join(root, self.FILENAME)
                      if root is not None else None)
        self._lock = threading.Lock()
        self._by_name: dict[str, int] = {DEFAULT_TENANT: 0}
        self._by_id: dict[int, str] = {0: DEFAULT_TENANT}
        if self._path is not None and os.path.exists(self._path):
            with open(self._path) as f:
                data = json.load(f)
            for name, tid in data.get("tenants", {}).items():
                self._by_name[name] = int(tid)
                self._by_id[int(tid)] = name

    def __len__(self) -> int:
        return len(self._by_name)

    @property
    def names(self) -> list[str]:
        return sorted(self._by_name)

    def _persist_locked(self) -> None:
        if self._path is None:
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"tenants": self._by_name}, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)

    def resolve(self, name: str) -> int:
        """Id for ``name``, allocating (and persisting) on first use.
        Write-path entry point: the id is durable before the caller
        writes any row carrying it."""
        with self._lock:
            tid = self._by_name.get(name)
            if tid is not None:
                return tid
            tid = max(self._by_id) + 1
            self._by_name[name] = tid
            self._by_id[tid] = name
            self._persist_locked()
            return tid

    def lookup(self, name: str) -> Optional[int]:
        """Read-only id for ``name``; None when never ingested."""
        with self._lock:
            return self._by_name.get(name)

    def name_of(self, tid: int) -> str:
        """Name for a persisted id (default tenant for unknown ids —
        tolerates columns written by a registry this store never saw,
        which only happens on hand-copied artifacts)."""
        with self._lock:
            return self._by_id.get(int(tid), DEFAULT_TENANT)

    def names_of(self, tids: Iterable[int]) -> list[str]:
        with self._lock:
            return [self._by_id.get(int(t), DEFAULT_TENANT) for t in tids]

    def visible_tids(self, visibility: Visibility) -> Optional[np.ndarray]:
        """Resolve a per-query visibility spec to a sorted int32 id
        array, or None for "no scoping". Unknown names contribute no
        ids (fail-closed): scoping to only-unknown tenants returns an
        EMPTY array, which masks every row."""
        if visibility is None:
            return None
        names = ([visibility] if isinstance(visibility, str)
                 else list(visibility))
        with self._lock:
            tids = sorted({self._by_name[n] for n in names
                           if n in self._by_name})
        return np.asarray(tids, np.int32)


def visible_rows(tenant_rows: np.ndarray,
                 visible: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """(N,) bool visibility mask over a per-row tenant-id column, or
    None when unscoped. This mask is AND-ed into the same pre-ranking
    validity mask the kernels already honor (alive/authority), so a
    foreign-tenant row returns idx -1 and can never be resurrected by
    the fp32 rescore — identical contract to the window-leakage guard."""
    if visible is None:
        return None
    if len(visible) == 0:
        return np.zeros(len(tenant_rows), bool)
    if len(visible) == 1:
        return np.asarray(tenant_rows) == visible[0]
    return np.isin(tenant_rows, visible)
