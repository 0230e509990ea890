"""Atomic, checksummed fabric manifest (DESIGN.md §10.2).

The manifest is the fabric's single commit point, exactly like the
segmented index's MANIFEST.json (index/manifest.py): state is serialized
to a temp file, fsync'd, and published with one atomic ``os.replace`` —
a crash leaves either the old epoch or the new one, never a torn state.
Two hardening layers on top of the index manifest:

  - an embedded SHA-256 over the payload, verified on load, so a
    corrupted/truncated manifest is detected (load returns None and the
    caller refuses to serve rather than routing with a garbage ring);
  - a monotonically increasing ``epoch`` — every routing change (shard
    add/remove, replica change, each migration step) commits a new
    epoch, which is what makes the rebalance protocol crash-recoverable:
    recovery reads the epoch's transition record and resumes from
    exactly the step it describes.

Manifest payload::

  {"epoch": N,
   "ring": {"shards": [...], "vnodes": V, "replicas": R},
   "transition": null | {"op": "split"|"merge"|"replicas",
                          "ring": <target ring>, "phase": "copy"|"cleanup",
                          "docs": {doc: [dst shards]}, "done": [doc, ...]}}
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

FABRIC_MANIFEST = "FABRIC.json"


class FabricManifest:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._path = os.path.join(root, FABRIC_MANIFEST)

    def exists(self) -> bool:
        return os.path.exists(self._path)

    # ------------------------------------------------------------------
    def load(self) -> dict | None:
        """Parsed + checksum-verified manifest, or None when absent or
        corrupt (the fabric refuses to route on a bad manifest)."""
        if not os.path.exists(self._path):
            return None
        try:
            with open(self._path) as f:
                rec = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
        payload, checksum = rec.get("payload"), rec.get("checksum")
        if not isinstance(payload, dict) or not checksum:
            return None
        digest = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()
        if digest != checksum:
            return None
        return payload

    def commit(self, state: dict) -> int:
        """Atomically publish a new fabric state; stamps the next epoch
        and the payload checksum. Returns the committed epoch."""
        prev = self.load()
        epoch = (prev["epoch"] + 1) if prev else 1
        payload = dict(state, epoch=epoch)
        checksum = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()
        data = json.dumps({"payload": payload, "checksum": checksum},
                          indent=1).encode()
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return epoch
