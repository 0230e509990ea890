"""Atomic on-disk manifest of live segments (DESIGN.md §7.4).

The manifest is the segmented index's commit point, exactly like the cold
tier's delta log: new segment files are written and fsync'd FIRST, then
one atomic ``os.replace`` of MANIFEST.json makes them visible and retires
their predecessors. A crash at any instant therefore leaves either the
old manifest (new files are invisible orphans, deleted on next load) or
the new one (old files are orphans) — never a dangling reference. Each
entry carries the segment's SHA-256 so a torn/corrupt segment file is
detected at load and recovery falls back to a cold-tier rebuild.
"""
from __future__ import annotations

import json
import os
import tempfile

MANIFEST_FILE = "MANIFEST.json"


class Manifest:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._path = os.path.join(root, MANIFEST_FILE)

    # ------------------------------------------------------------------
    def load(self) -> dict | None:
        """Parsed manifest, or None when absent/unreadable (caller falls
        back to a full rebuild from the cold tier)."""
        if not os.path.exists(self._path):
            return None
        try:
            with open(self._path) as f:
                m = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
        if not isinstance(m.get("segments"), list):
            return None
        return m

    def commit(self, segments: list[dict], seq: int) -> int:
        """Atomically publish the complete live-segment list:
        ``segments`` = [{"name", "checksum", "rows"}]; ``seq`` is the next
        segment-id counter so restarts never reuse an id."""
        m = self.load()
        generation = (m["generation"] + 1) if m else 1
        rec = {"generation": generation, "seq": seq, "segments": segments}
        data = json.dumps(rec, indent=1).encode()
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
        return generation

    def cleanup_orphans(self, keep: set[str],
                        quarantined: set[str] | None = None) -> int:
        """Delete seg-*.npz not referenced by ``keep`` — leftovers from a
        crash between segment write and manifest publish (or between
        publish and predecessor deletion). A quantized segment's fp32
        rescore sidecar (seg-*.f32.npy) lives or dies with its npz.
        Quarantine-aware (DESIGN.md §16): the sweep only walks the root
        itself — artifacts moved into ``quarantine/`` are out of reach
        by construction — and ``quarantined`` names are additionally
        skipped in place, so a corrupt segment awaiting its move is
        never destroyed as an "orphan" (it is forensic evidence, and it
        is no longer manifest-referenced precisely because it was
        quarantined). Returns #files removed."""
        q = quarantined or set()
        n = 0
        for fn in os.listdir(self.root):
            base = (fn[:-len(".f32.npy")] + ".npz"
                    if fn.endswith(".f32.npy") else fn)
            if fn in q or base in q:
                continue
            if fn.startswith("seg-") and fn.endswith(".npz") \
                    and fn not in keep:
                os.unlink(os.path.join(self.root, fn))
                n += 1
            elif fn.startswith("seg-") and fn.endswith(".f32.npy") \
                    and fn[:-len(".f32.npy")] + ".npz" not in keep:
                os.unlink(os.path.join(self.root, fn))
                n += 1
        return n
