"""In-memory hash store with JSON persistence (paper §III-A3).

Maintains ``doc_id -> [hash_1, hash_2, ...]`` (ordered by position). This
lightweight structure performs CDC comparison without touching the vector
database or the lakehouse: <1ms in-memory lookup vs ~100ms DB query.

Persistence is atomic (write-tmp + rename) so a crash mid-save never
corrupts the store; on restart the store reflects the last committed state
and WAL reconciliation re-drives any in-flight ingest.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Iterable, Optional


class HashStore:
    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._docs: dict[str, list[str]] = {}
        self._versions: dict[str, int] = {}
        if path and os.path.exists(path):
            self.load()

    # -- CDC-facing API ------------------------------------------------
    def get(self, doc_id: str) -> list[str]:
        return list(self._docs.get(doc_id, []))

    def version(self, doc_id: str) -> int:
        return self._versions.get(doc_id, 0)

    def put(self, doc_id: str, hashes: Iterable[str], version: int) -> None:
        self._docs[doc_id] = list(hashes)
        self._versions[doc_id] = version
        if self._path:
            self.save()

    def doc_ids(self) -> list[str]:
        return sorted(self._docs)

    def remove(self, doc_id: str) -> bool:
        """Drop a document's entry (shard hand-off: the doc now lives on
        another shard's lake). Returns whether it existed."""
        existed = self._docs.pop(doc_id, None) is not None
        self._versions.pop(doc_id, None)
        if existed and self._path:
            self.save()
        return existed

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._docs

    def __len__(self) -> int:
        return len(self._docs)

    # -- persistence ----------------------------------------------------
    def save(self) -> None:
        assert self._path is not None
        payload = {"docs": self._docs, "versions": self._versions}
        d = os.path.dirname(os.path.abspath(self._path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self) -> None:
        assert self._path is not None
        with open(self._path) as f:
            payload = json.load(f)
        self._docs = {k: list(v) for k, v in payload.get("docs", {}).items()}
        self._versions = {k: int(v) for k, v in payload.get("versions", {}).items()}
