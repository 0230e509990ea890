"""Cold tier: append-only columnar version store (paper §III-C2).

TPU-native stand-in for Delta Lake + Parquet (see DESIGN.md §2, §9): the
*architecture* is preserved exactly —

  - append-only segments of columnar arrays (structure-of-arrays), one
    compressed .npz per commit (plays the role of Snappy-Parquet),
  - a JSON transaction log with atomic-rename commits (the "delta log"):
    every commit is one numbered log entry referencing its segment plus the
    validity CLOSURES it applies (mark-superseded / mark-deleted are
    append-only log facts, never in-place mutations). Each entry also
    carries a ZONE MAP (min/max valid_from + the (doc, position) key set)
    so readers can prune segment loads without opening the .npz,
  - snapshot isolation + time travel: a reader resolves a snapshot at
    (version | timestamp) by folding log entries up to the target, then
    filters valid_from <= ts < valid_to. Validity filtering happens BEFORE
    any similarity ranking (temporal-leakage prevention, §III-D3).

Bounded reconstruction cost (DESIGN.md §9): the naive fold is O(total
history) per snapshot. Two read-path overlays keep it O(delta):

  - CHECKPOINTS (``_ckpt/``): every ``checkpoint_interval`` commits the
    materialized full-history fold (arrays + resolved valid_to) is
    persisted atomically and checksummed like a segment. ``snapshot()``
    seeds from the nearest checkpoint <= the target and folds only the
    delta commits. A checkpoint is a pure cache: its meta sidecar is the
    commit point (npz first, then meta; a crash in between leaves an
    orphan npz that is swept, never surfaced), and ``mark_committed``
    (WAL compensation) deletes any checkpoint/archive that baked the
    flipped version BEFORE touching the log entry, so a stale overlay can
    never outlive the flip.
  - ARCHIVES (``_archive/``): ``compact()`` rewrites runs of FULLY-CLOSED
    commits into single sorted archives with exact zone maps
    (vf/vt min-max + doc set). A point-in-time fold skips an archive
    whose validity range cannot intersect the target instant without
    opening its .npz. Originals are retained — time travel INSIDE an
    archived run falls back to the per-commit segments.

ACID story: a commit is visible iff its log entry file exists (os.replace
is atomic). Segment files are written and fsync'd before the log entry, so
a crash leaves at worst an orphaned segment, never a dangling log entry.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import tempfile
from typing import Optional

import numpy as np

from .. import obs
from ..testing.faults import FAULTS
from .hashing import blob_checksum
from .integrity import CorruptionError, Quarantine
from .types import (STATUS_ACTIVE, STATUS_SUPERSEDED,
                    VALID_TO_OPEN, ChunkRecord)

_LOG_DIR = "_log"
_SEG_DIR = "segments"
_CKPT_DIR = "_ckpt"
_ARC_DIR = "_archive"
_ZONE_KEYS_CAP = 64      # zone maps above this key count store no key list

_COLS = ("embeddings", "valid_from", "valid_to", "version", "position",
         "chunk_ids", "doc_ids", "texts", "tenant_ids")


class FaultPoint(RuntimeError):
    """Raised by the fault-injection hooks to simulate a crash mid-write
    (tests only)."""


@dataclasses.dataclass
class ColdSnapshot:
    """Materialized point-in-time view: columnar arrays over all records
    valid at the snapshot instant."""

    embeddings: np.ndarray        # (n, d) float32
    valid_from: np.ndarray        # (n,) int64
    valid_to: np.ndarray          # (n,) int64
    version: np.ndarray           # (n,) int32
    position: np.ndarray          # (n,) int64
    chunk_ids: list[str]
    doc_ids: list[str]
    texts: list[str]
    as_of: int
    # per-row tenant ids (registry-scoped); defaulted LAST so historical
    # positional construction stays valid — None only for hand-built
    # snapshots in tests, the tier always fills it
    tenant_ids: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.chunk_ids)

    def tenants(self) -> np.ndarray:
        """tenant_ids, never None (zeros for pre-tenancy snapshots)."""
        if self.tenant_ids is None:
            return np.zeros(len(self.chunk_ids), np.int32)
        return self.tenant_ids


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _Fold:
    """Mutable accumulator for a log fold: columnar chunks + the
    open-record index ((doc_id, position) -> flat row, or -1 for rows in
    zone-pruned segments that must still shadow their key)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.embs: list[np.ndarray] = []
        self.vf: list[np.ndarray] = []
        self.ver: list[np.ndarray] = []
        self.pos: list[np.ndarray] = []
        self.tids: list[np.ndarray] = []
        self.chunk_ids: list[str] = []
        self.doc_ids: list[str] = []
        self.texts: list[str] = []
        self.vt: list[int] = []               # flat, mutated by closures
        self.open_idx: dict[tuple[str, int], int] = {}
        self.n = 0
        self.last_committed_ts: Optional[int] = None
        self.max_entry_ts = 0                 # raw entries, incl uncommitted

    def close(self, doc_id: str, position: int, closed_at: int) -> None:
        row = self.open_idx.pop((doc_id, int(position)), None)
        if row is not None and row >= 0:
            self.vt[row] = int(closed_at)

    def append_rows(self, emb, vf, vt, ver, pos, chunk_ids, doc_ids, texts,
                    track_open: bool = True, tenant_ids=None) -> None:
        m = len(pos)
        if m == 0:
            return
        self.embs.append(np.asarray(emb, np.float32))
        self.vf.append(np.asarray(vf, np.int64))
        self.ver.append(np.asarray(ver, np.int32))
        self.pos.append(np.asarray(pos, np.int64))
        # absent tenant column (pre-tenancy segment/checkpoint/archive)
        # means default tenant 0 for every row
        self.tids.append(np.zeros(m, np.int32) if tenant_ids is None
                         else np.asarray(tenant_ids, np.int32))
        self.chunk_ids.extend(chunk_ids)
        self.doc_ids.extend(doc_ids)
        self.texts.extend(texts)
        self.vt.extend(int(x) for x in vt)
        if track_open:
            for i in range(m):
                if self.vt[self.n + i] == VALID_TO_OPEN:
                    self.open_idx[(doc_ids[i], int(pos[i]))] = self.n + i
        self.n += m

    def shadow(self, keys) -> None:
        """Register keys of a zone-pruned (unloaded) segment so later
        closures route to the pruned rows (a no-op) instead of wrongly
        popping an older open row for the same key."""
        for doc_id, position in keys:
            self.open_idx[(doc_id, int(position))] = -1

    def columns(self) -> dict:
        if self.n == 0:
            z = np.zeros
            return {"embeddings": z((0, self.dim), np.float32),
                    "valid_from": z(0, np.int64), "valid_to": z(0, np.int64),
                    "version": z(0, np.int32), "position": z(0, np.int64),
                    "tenant_ids": z(0, np.int32),
                    "chunk_ids": [], "doc_ids": [], "texts": []}
        return {"embeddings": np.concatenate(self.embs, axis=0),
                "valid_from": np.concatenate(self.vf),
                "valid_to": np.array(self.vt, np.int64),
                "version": np.concatenate(self.ver),
                "position": np.concatenate(self.pos),
                "tenant_ids": np.concatenate(self.tids),
                "chunk_ids": self.chunk_ids, "doc_ids": self.doc_ids,
                "texts": self.texts}


class ColdTier:
    def __init__(self, root: str, dim: int, checkpoint_interval: int = 8,
                 quant_sidecar: bool = False):
        """``quant_sidecar``: also persist int8 quantization columns
        (emb_q8/quant_scale) in every checkpoint — the store threads its
        ``quantized`` flag here so fp32 stores never pay the quantize
        pass or the extra checkpoint bytes (DESIGN.md §11)."""
        self.root = root
        self.dim = dim
        self.quant_sidecar = bool(quant_sidecar)
        self.checkpoint_interval = int(checkpoint_interval)
        for d in (_LOG_DIR, _SEG_DIR, _CKPT_DIR, _ARC_DIR):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        self.io_counters = {"segment_loads": 0, "checkpoint_loads": 0,
                            "archive_loads": 0, "segments_pruned": 0,
                            "archives_pruned": 0, "full_folds": 0,
                            "delta_folds": 0, "segments_quarantined": 0}
        # corrupt artifacts move here instead of killing the tier
        # (DESIGN.md §16); the orphan sweep below never reaches them —
        # it only walks _ckpt/ and _archive/, and quarantine/ is a
        # sibling directory
        self.quarantine = Quarantine(root, "cold")
        self._sweep_orphans()

    # ------------------------------------------------------------------
    # log handling
    # ------------------------------------------------------------------
    def _log_path(self, version: int) -> str:
        return os.path.join(self.root, _LOG_DIR, f"{version:08d}.json")

    def _seg_path(self, seg_name: str) -> str:
        return os.path.join(self.root, _SEG_DIR, seg_name)

    def _arc_path(self, arc_name: str) -> str:
        return os.path.join(self.root, _ARC_DIR, arc_name)

    def latest_version(self) -> int:
        entries = [f for f in os.listdir(os.path.join(self.root, _LOG_DIR))
                   if f.endswith(".json")]
        return max((int(f.split(".")[0]) for f in entries), default=0)

    def _read_entry(self, version: int) -> Optional[dict]:
        p = self._log_path(version)
        if not os.path.exists(p):
            return None                       # gap = never-committed number
        with open(p) as f:
            return json.load(f)

    def read_entries(self, lo: int, hi: int,
                     committed_only: bool = True) -> list[dict]:
        """Log entries with lo <= version <= hi, in version order (used by
        the temporal engine's incremental resident-history apply)."""
        out = []
        for v in range(lo, hi + 1):
            e = self._read_entry(v)
            if e is None:
                continue
            if committed_only and not e.get("committed", True):
                continue
            out.append(e)
        return out

    # ------------------------------------------------------------------
    # commits (append-only)
    # ------------------------------------------------------------------
    def commit(self, records: list[ChunkRecord],
               closures: list[dict], ts: int,
               uncommitted: bool = False,
               fail_after: Optional[str] = None) -> int:
        """One ACID commit = (appended records, validity closures).

        closures: [{"doc_id", "position", "closed_at", "status"}] marking
        previously-open records superseded/deleted at `closed_at`.
        ``uncommitted=True`` writes the segment flagged for the WAL
        reconciler (compensating-transaction support): readers skip it.
        ``fail_after`` in {"segment", "log", "checkpoint_data"} simulates
        a crash after that write (tests only).
        """
        version = self.latest_version() + 1
        seg_name = None
        checksum = None
        zone = None
        if records:
            seg_name = f"seg-{version:08d}.npz"
            emb = np.stack([np.asarray(r.embedding, dtype=np.float32)
                            for r in records])
            if emb.shape[1] != self.dim:
                raise ValueError(f"embedding dim {emb.shape[1]} != {self.dim}")
            vf = np.array([r.valid_from for r in records], np.int64)
            buf = io.BytesIO()
            np.savez_compressed(
                buf,
                embeddings=emb,
                valid_from=vf,
                valid_to=np.array([r.valid_to for r in records], np.int64),
                version=np.array([version] * len(records), np.int32),
                position=np.array([r.position for r in records], np.int64),
                chunk_ids=np.array([r.chunk_id for r in records]),
                doc_ids=np.array([r.doc_id for r in records]),
                texts=np.array([r.text for r in records]),
                parent_hash=np.array([r.parent_hash or "" for r in records]),
                tenant_ids=np.array([r.tenant_id for r in records],
                                    np.int32),
            )
            data = buf.getvalue()
            checksum = blob_checksum(data)
            _atomic_write(self._seg_path(seg_name), data)
            FAULTS.mutate("cold:segment:file", self._seg_path(seg_name))
            keys = [[r.doc_id, int(r.position)] for r in records]
            zone = {"vf_min": int(vf.min()), "vf_max": int(vf.max()),
                    "keys": keys if len(keys) <= _ZONE_KEYS_CAP else None}
        if fail_after == "segment":               # legacy per-call shim
            raise FaultPoint("crash after segment write, before log append")
        FAULTS.check("cold:commit:segment", exc=FaultPoint)

        entry = {
            "version": version,
            "ts": ts,
            "segment": seg_name,
            "checksum": checksum,
            "n_records": len(records),
            "closures": closures,
            "committed": not uncommitted,
            "zone": zone,
        }
        _atomic_write(self._log_path(version),
                      json.dumps(entry, indent=1).encode())
        if fail_after == "log":                   # legacy per-call shim
            raise FaultPoint("crash after log append, before checkpoint")
        FAULTS.check("cold:commit:log", exc=FaultPoint)

        if self.checkpoint_interval > 0 and \
                version % self.checkpoint_interval == 0:
            self.write_checkpoint(fail_after=fail_after)
        return version

    def mark_committed(self, version: int, committed: bool = True) -> None:
        """Flip the committed flag (WAL reconciliation: compensate or
        finalize a previously-uncommitted segment).

        Any checkpoint or archive that baked the flipped version — or a
        closure from it — is deleted FIRST, so a crash between the two
        steps can only lose an overlay, never surface a stale one."""
        self._invalidate_overlays(version)
        p = self._log_path(version)
        with open(p) as f:
            e = json.load(f)
        e["committed"] = committed
        _atomic_write(p, json.dumps(e, indent=1).encode())

    # ------------------------------------------------------------------
    # segment / checkpoint / archive IO
    # ------------------------------------------------------------------
    def _load_npz(self, path: str, checksum: Optional[str],
                  what: str) -> dict:
        """Verified artifact load. A checksum mismatch raises the typed
        ``CorruptionError`` (containment, DESIGN.md §16); pure caches
        (checkpoints, archives) are quarantined right here — no data is
        lost, the fold falls back to the originals. Segments carry data,
        so THEIR quarantine happens at the caller, which knows the log
        entry (zone map -> affected docs): see ``quarantine_segment``."""
        with open(path, "rb") as f:
            data = f.read()
        if checksum and blob_checksum(data) != checksum:
            if what == "checkpoint":
                self.quarantine.quarantine(
                    path, "checkpoint", "checksum mismatch at load",
                    docs=[], data_loss=False,
                    companions=(path[:-len(".npz")] + ".json",))
            elif what == "archive":
                self.quarantine.quarantine(
                    path, "archive", "checksum mismatch at load",
                    docs=[], data_loss=False)
            raise CorruptionError(
                f"{what} {os.path.basename(path)}: "
                "checksum mismatch (corruption)",
                artifact=("cold_segment" if what == "segment" else what),
                tier="cold", path=path)
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}

    def load_segment(self, seg_name: str, checksum: Optional[str]) -> dict:
        self.io_counters["segment_loads"] += 1
        return self._load_npz(self._seg_path(seg_name), checksum, "segment")

    # kept as the historical private name used elsewhere in the codebase
    _load_segment = load_segment

    def quarantine_segment(self, entry: dict, reason: str) -> dict:
        """Contain a corrupt per-commit segment: atomic move into
        quarantine/ with the affected docs recorded from the entry's
        zone map (None = zone too wide, breadth unknown). This IS data
        loss until ``ShardFabric.repair`` replays the docs from a
        replica — the log entry stays (its closures still apply), only
        its rows drop out of every fold."""
        zone = entry.get("zone") or {}
        keys = zone.get("keys")
        docs = (sorted({d for d, _ in keys})
                if keys is not None else None)
        self.io_counters["segments_quarantined"] += 1
        return self.quarantine.quarantine(
            self._seg_path(entry["segment"]), "cold_segment", reason,
            docs=docs, data_loss=True)

    # -- checkpoints ----------------------------------------------------
    def _ckpt_paths(self, version: int) -> tuple[str, str]:
        base = os.path.join(self.root, _CKPT_DIR, f"ckpt-{version:08d}")
        return base + ".npz", base + ".json"

    def checkpoints(self) -> list[dict]:
        """Metas of all durable checkpoints, ascending by version. A
        checkpoint is durable iff its meta sidecar exists (the npz is
        written first; meta is the commit point)."""
        d = os.path.join(self.root, _CKPT_DIR)
        metas = []
        for f in sorted(os.listdir(d)):
            if not f.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, f)) as fh:
                    metas.append(json.load(fh))
            except (json.JSONDecodeError, OSError):
                continue
        return metas

    def write_checkpoint(self, fail_after: Optional[str] = None) -> Optional[int]:
        """Persist the materialized full-history fold at the current
        latest version. Incremental: the fold itself seeds from the
        previous checkpoint, so cost is O(commits since last checkpoint).
        Returns the checkpoint version (None if the log is empty)."""
        version = self.latest_version()
        if version == 0:
            return None
        # pin the fold to the version just read: a commit landing on
        # another thread between the two would otherwise bake rows newer
        # than the checkpoint's stamped version (duplicated on delta fold)
        fold = self._fold(up_to_version=version)
        cols = fold.columns()
        ckpt_cols = dict(
            embeddings=cols["embeddings"], valid_from=cols["valid_from"],
            valid_to=cols["valid_to"], version=cols["version"],
            position=cols["position"], tenant_ids=cols["tenant_ids"],
            chunk_ids=np.array(cols["chunk_ids"]),
            doc_ids=np.array(cols["doc_ids"]),
            texts=np.array(cols["texts"]))
        if self.quant_sidecar:
            # quantized-scan sidecar columns (DESIGN.md §11): the int8
            # rows + fixed scale are persisted with the checkpoint so a
            # reopened store seeds its resident quantized history from
            # disk verbatim (bit-deterministic, no re-quantization)
            from ..index.quant import fixed_scale, quantize_rows
            scale = fixed_scale(self.dim)
            ckpt_cols["emb_q8"] = quantize_rows(cols["embeddings"], scale)
            ckpt_cols["quant_scale"] = scale
        buf = io.BytesIO()
        np.savez_compressed(buf, **ckpt_cols)
        data = buf.getvalue()
        npz_path, meta_path = self._ckpt_paths(version)
        _atomic_write(npz_path, data)
        FAULTS.mutate("cold:checkpoint:file", npz_path)
        if fail_after == "checkpoint_data":       # legacy per-call shim
            raise FaultPoint("crash after checkpoint npz, before meta")
        FAULTS.check("cold:checkpoint:data", exc=FaultPoint)
        meta = {"version": version, "n_rows": fold.n,
                "as_of_ts": fold.last_committed_ts or 0,
                "max_entry_ts": fold.max_entry_ts,
                "checksum": blob_checksum(data)}
        _atomic_write(meta_path, json.dumps(meta, indent=1).encode())
        return version

    def checkpoint_q8_at(self, version: int,
                         expected_rows: int) -> Optional[tuple]:
        """The persisted quantized sidecar of the checkpoint at EXACTLY
        ``version`` — (emb_q8, quant_scale) — or None. Used by the
        temporal engine to seed its resident quantized history from disk
        verbatim instead of re-quantizing: with no delta commits after
        the checkpoint, the checkpoint's row order IS the fold's."""
        for m in self.checkpoints():
            if m["version"] != version:
                continue
            cols = self._load_checkpoint(m)
            if (cols is not None and "emb_q8" in cols
                    and cols["emb_q8"].shape[0] == expected_rows):
                return cols["emb_q8"], cols["quant_scale"]
            return None
        return None

    def _best_checkpoint(self, hi: int,
                         up_to_ts: Optional[int]) -> Optional[dict]:
        best = None
        for m in self.checkpoints():
            if m["version"] > hi:
                continue
            if up_to_ts is not None and m["max_entry_ts"] > up_to_ts:
                continue
            if best is None or m["version"] > best["version"]:
                best = m
        return best

    def _load_checkpoint(self, meta: dict) -> Optional[dict]:
        npz_path, _ = self._ckpt_paths(meta["version"])
        try:
            cols = self._load_npz(npz_path, meta["checksum"], "checkpoint")
        except (IOError, OSError):
            return None                      # corrupt/missing cache: refold
        self.io_counters["checkpoint_loads"] += 1
        return cols

    # -- archives -------------------------------------------------------
    def _arc_manifest_path(self) -> str:
        return os.path.join(self.root, _ARC_DIR, "manifest.json")

    def archives(self) -> list[dict]:
        p = self._arc_manifest_path()
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return json.load(f).get("archives", [])

    def _write_arc_manifest(self, archives: list[dict]) -> None:
        _atomic_write(self._arc_manifest_path(),
                      json.dumps({"archives": archives}, indent=1).encode())

    def _invalidate_overlays(self, version: int) -> None:
        """Drop every checkpoint/archive whose contents depend on entry
        ``version`` (it covers the version, or baked one of its
        closures)."""
        for m in self.checkpoints():
            if m["version"] >= version:
                npz_path, meta_path = self._ckpt_paths(m["version"])
                for p in (meta_path, npz_path):   # meta first: commit point
                    if os.path.exists(p):
                        os.unlink(p)
        arcs = self.archives()
        keep = [a for a in arcs
                if a["hi"] < version
                and all(v < version for v, _ in a["consumed"])]
        if len(keep) != len(arcs):
            self._write_arc_manifest(keep)
            kept_files = {a["file"] for a in keep}
            d = os.path.join(self.root, _ARC_DIR)
            for a in arcs:
                if a["file"] not in kept_files:
                    p = os.path.join(d, a["file"])
                    if os.path.exists(p):
                        os.unlink(p)

    def _sweep_orphans(self) -> None:
        """Remove overlay files whose commit record never landed: ckpt
        npz without meta, archive npz missing from the manifest."""
        d = os.path.join(self.root, _CKPT_DIR)
        for f in os.listdir(d):
            if f.endswith(".npz") and not os.path.exists(
                    os.path.join(d, f[:-4] + ".json")):
                os.unlink(os.path.join(d, f))
        d = os.path.join(self.root, _ARC_DIR)
        known = {a["file"] for a in self.archives()}
        for f in os.listdir(d):
            if f.endswith(".npz") and f not in known:
                os.unlink(os.path.join(d, f))

    # ------------------------------------------------------------------
    # the fold: checkpoint seed + archive/zone pruning + delta replay
    # ------------------------------------------------------------------
    def _fold(self, up_to_version: Optional[int] = None,
              up_to_ts: Optional[int] = None,
              as_of_prune: Optional[int] = None,
              use_overlays: bool = True,
              only_doc: Optional[str] = None) -> _Fold:
        """Fold log entries up to the target into columnar state.

        ``as_of_prune`` (a target instant) enables EXACT segment/archive
        pruning for point-in-time reads: rows that cannot be valid at the
        instant are skipped, with their keys shadowed so closure routing
        is unchanged. ``only_doc`` restricts the fold to one document's
        records (history audits) using the zone-map key sets.
        ``use_overlays=False`` is the from-scratch reference fold — the
        oracle the property suite and the scaling benchmark compare
        against.
        """
        latest = self.latest_version()
        hi = latest if up_to_version is None else min(latest, up_to_version)
        fold = _Fold(self.dim)
        start = 0

        if use_overlays:
            meta = self._best_checkpoint(hi, up_to_ts)
            if meta is not None:
                cols = self._load_checkpoint(meta)
                if cols is not None:
                    sel = None
                    if only_doc is not None:
                        sel = np.asarray(
                            [d == only_doc for d in cols["doc_ids"].tolist()])
                    self._append_cols(fold, cols, sel)
                    start = meta["version"]
                    fold.last_committed_ts = meta["as_of_ts"] or None
                    fold.max_entry_ts = meta["max_entry_ts"]
            self.io_counters["delta_folds" if start else "full_folds"] += 1
        else:
            self.io_counters["full_folds"] += 1

        arch_by_lo = {}
        if use_overlays:
            arch_by_lo = {a["lo"]: a for a in self.archives()}
        # closures from post-archive entries that an archive baked into its
        # rows: (version -> {closure indices}) to skip during delta replay
        consumed_marks: dict[int, set[int]] = {}

        v = start + 1
        while v <= hi:
            a = arch_by_lo.get(v)
            if a is not None and a["hi"] <= hi and \
                    (up_to_ts is None or a["max_entry_ts"] <= up_to_ts) \
                    and not self.quarantine.is_quarantined(a["file"]):
                try:
                    self._fold_archive(fold, a, as_of_prune, only_doc,
                                       consumed_marks, hi, up_to_ts)
                except CorruptionError:
                    # the archive was quarantined inside _load_npz (it
                    # is a pure cache — the per-commit originals are
                    # retained), but its external closures may already
                    # have mutated this fold: redo the whole fold; the
                    # retry skips the quarantined file and replays the
                    # run from the original segments. Bounded: each
                    # retry retires one archive.
                    return self._fold(up_to_version, up_to_ts,
                                      as_of_prune, use_overlays, only_doc)
                v = a["hi"] + 1
                continue
            e = self._read_entry(v)
            v += 1
            if e is None:
                continue
            # Skip (not stop at) entries past the target instant: entry ts
            # is NOT monotonic in version order once a shard migration has
            # imported another document's older history (shard/rebalance),
            # and an entry's rows/closures all carry ts >= the entry's own
            # ts, so skipping it never changes validity at up_to_ts.
            if up_to_ts is not None and e["ts"] > up_to_ts:
                continue
            fold.max_entry_ts = max(fold.max_entry_ts, e["ts"])
            if not e.get("committed", True):
                continue
            consumed = consumed_marks.get(e["version"], ())
            for j, c in enumerate(e["closures"]):
                if j in consumed:
                    continue
                if only_doc is not None and c["doc_id"] != only_doc:
                    continue
                fold.close(c["doc_id"], c["position"], c["closed_at"])
            if e["segment"]:
                self._fold_segment(fold, e, as_of_prune, only_doc)
            fold.last_committed_ts = e["ts"]
        return fold

    def _append_cols(self, fold: _Fold, cols: dict,
                     sel: Optional[np.ndarray]) -> None:
        chunk_ids = cols["chunk_ids"].tolist() if hasattr(
            cols["chunk_ids"], "tolist") else list(cols["chunk_ids"])
        doc_ids = cols["doc_ids"].tolist() if hasattr(
            cols["doc_ids"], "tolist") else list(cols["doc_ids"])
        texts = cols["texts"].tolist() if hasattr(
            cols["texts"], "tolist") else list(cols["texts"])
        tids = cols.get("tenant_ids")
        if sel is not None:
            idx = np.nonzero(sel)[0]
            fold.append_rows(cols["embeddings"][idx], cols["valid_from"][idx],
                             cols["valid_to"][idx], cols["version"][idx],
                             cols["position"][idx],
                             [chunk_ids[i] for i in idx],
                             [doc_ids[i] for i in idx],
                             [texts[i] for i in idx],
                             tenant_ids=(None if tids is None
                                         else tids[idx]))
        else:
            fold.append_rows(cols["embeddings"], cols["valid_from"],
                             cols["valid_to"], cols["version"],
                             cols["position"], chunk_ids, doc_ids, texts,
                             tenant_ids=tids)

    def _fold_segment(self, fold: _Fold, e: dict,
                      as_of_prune: Optional[int],
                      only_doc: Optional[str]) -> None:
        zone = e.get("zone")
        if self.quarantine.is_quarantined(e["segment"]):
            # containment (DESIGN.md §16): the segment's rows are gone
            # from serving until repair, but the fold keeps going — its
            # keys are shadowed exactly like a zone-pruned segment so
            # later closures route to the lost rows (a no-op) instead of
            # wrongly popping an older open row for the same key. (When
            # this segment appended a key, its own entry's closures —
            # still in the log — already popped the key's previous row.)
            if zone and zone.get("keys") is not None:
                fold.shadow(zone["keys"])
            return
        if only_doc is not None and zone and zone.get("keys") is not None:
            if all(doc != only_doc for doc, _ in zone["keys"]):
                self.io_counters["segments_pruned"] += 1
                obs.add("segments_pruned", 1)
                return                       # document not in this segment
        if as_of_prune is not None and zone and zone.get("keys") is not None \
                and zone["vf_min"] > as_of_prune:
            # every row starts after the target instant: invalid for this
            # read. Shadow the keys so later closures still route here.
            fold.shadow(zone["keys"])
            self.io_counters["segments_pruned"] += 1
            obs.add("segments_pruned", 1)
            return
        try:
            seg = self.load_segment(e["segment"], e.get("checksum"))
        except CorruptionError:
            self.quarantine_segment(e, "checksum mismatch during fold")
            if zone and zone.get("keys") is not None:
                fold.shadow(zone["keys"])
            return
        doc_ids = seg["doc_ids"].tolist()
        tids = seg.get("tenant_ids")
        if only_doc is not None:
            sel = np.asarray([d == only_doc for d in doc_ids])
            if not sel.any():
                return
            idx = np.nonzero(sel)[0]
            fold.append_rows(
                seg["embeddings"][idx], seg["valid_from"][idx],
                seg["valid_to"][idx], seg["version"][idx],
                seg["position"][idx],
                [seg["chunk_ids"][i] for i in idx],
                [doc_ids[i] for i in idx],
                [seg["texts"][i] for i in idx],
                tenant_ids=(None if tids is None else tids[idx]))
        else:
            fold.append_rows(seg["embeddings"], seg["valid_from"],
                             seg["valid_to"], seg["version"],
                             seg["position"], seg["chunk_ids"].tolist(),
                             doc_ids, seg["texts"].tolist(),
                             tenant_ids=tids)

    def _fold_archive(self, fold: _Fold, a: dict,
                      as_of_prune: Optional[int],
                      only_doc: Optional[str],
                      consumed_marks: dict[int, set[int]],
                      hi: int, up_to_ts: Optional[int]) -> None:
        # external closures target rows appended BEFORE the archive; the
        # archive's own rows are final (all closed) and never enter the
        # open-record index, so applying these up front is exact.
        for c in a["external_closures"]:
            if only_doc is not None and c["doc_id"] != only_doc:
                continue
            fold.close(c["doc_id"], c["position"], c["closed_at"])
        # closures from LATER entries that were baked into archive rows
        # must not replay against older rows: mark them consumed.
        for v, j in a["consumed"]:
            consumed_marks.setdefault(v, set()).add(j)
        fold.max_entry_ts = max(fold.max_entry_ts, a["max_entry_ts"])
        if a.get("max_committed_ts"):
            fold.last_committed_ts = a["max_committed_ts"]
        if a["n_rows"] == 0:
            return
        if only_doc is not None and a.get("docs") is not None \
                and only_doc not in a["docs"]:
            self.io_counters["archives_pruned"] += 1
            obs.add("segments_pruned", 1)
            return
        if as_of_prune is not None and \
                (a["vt_max"] <= as_of_prune or a["vf_min"] > as_of_prune):
            # the whole archive's validity range misses the instant; its
            # rows are all closed, so nothing to shadow either.
            self.io_counters["archives_pruned"] += 1
            obs.add("segments_pruned", 1)
            return
        self.io_counters["archive_loads"] += 1
        cols = self._load_npz(
            os.path.join(self.root, _ARC_DIR, a["file"]),
            a["checksum"], "archive")
        order = cols["orig_order"]           # restore exact fold order
        restored = {k: cols[k][order] for k in
                    ("embeddings", "valid_from", "valid_to", "version",
                     "position", "chunk_ids", "doc_ids", "texts",
                     "closed_by_version", "closed_by_ts")}
        if "tenant_ids" in cols:             # pre-tenancy archives lack it
            restored["tenant_ids"] = cols["tenant_ids"][order]
        # rows whose CLOSING entry lies beyond this fold's cut are still
        # open as of the target: reset valid_to and let them re-enter the
        # open-record index (a snapshot must not leak future closures).
        beyond = restored["closed_by_version"].astype(np.int64) > hi
        if up_to_ts is not None:
            beyond |= restored["closed_by_ts"] > up_to_ts
        if beyond.any():
            vt = restored["valid_to"].copy()
            vt[beyond] = VALID_TO_OPEN
            restored["valid_to"] = vt
        sel = None
        if only_doc is not None:
            sel = np.asarray([d == only_doc
                              for d in restored["doc_ids"].tolist()])
        self._append_cols(fold, restored, sel)

    # ------------------------------------------------------------------
    # reads: snapshot isolation + time travel
    # ------------------------------------------------------------------
    def snapshot(self, as_of_ts: Optional[int] = None,
                 version: Optional[int] = None,
                 include_closed: bool = False,
                 from_scratch: bool = False) -> ColdSnapshot:
        """Materialize the store as of (ts | version | now).

        Seed from the nearest checkpoint <= target, fold only the delta
        commits (archives prune fully-closed runs), apply closures to
        compute valid_to; filter to records whose validity interval covers
        the target instant. include_closed=True returns ALL records up to
        the target (full history view, used for audits and storage
        stats). ``from_scratch=True`` bypasses checkpoints AND archives —
        the O(total history) reference fold the equivalence gates compare
        against.
        """
        prune = as_of_ts if (not include_closed and not from_scratch) else None
        fold = self._fold(up_to_version=version, up_to_ts=as_of_ts,
                          as_of_prune=prune,
                          use_overlays=not from_scratch)
        if as_of_ts is None:
            # "now" = the NEWEST instant the log has seen, not the last
            # entry's ts: after a shard migration imports another doc's
            # older history, version order no longer implies ts order and
            # the last entry can predate live data (an uncommitted entry
            # can only push the instant later — its rows are skipped by
            # the fold either way).
            as_of_ts = max(fold.last_committed_ts or 0, fold.max_entry_ts)
        cols = fold.columns()
        n = fold.n
        if n == 0:
            return ColdSnapshot(cols["embeddings"], cols["valid_from"],
                                cols["valid_to"], cols["version"],
                                cols["position"], [], [], [], as_of_ts,
                                tenant_ids=cols["tenant_ids"])
        if include_closed:
            mask = np.ones(n, bool)
        else:
            # THE temporal-leakage guard: validity filter BEFORE any ranking
            mask = (cols["valid_from"] <= as_of_ts) & \
                   (as_of_ts < cols["valid_to"])
        sel = np.nonzero(mask)[0]
        return ColdSnapshot(
            embeddings=cols["embeddings"][sel],
            valid_from=cols["valid_from"][sel],
            valid_to=cols["valid_to"][sel],
            version=cols["version"][sel], position=cols["position"][sel],
            chunk_ids=[cols["chunk_ids"][i] for i in sel],
            doc_ids=[cols["doc_ids"][i] for i in sel],
            texts=[cols["texts"][i] for i in sel],
            as_of=as_of_ts,
            tenant_ids=cols["tenant_ids"][sel],
        )

    def history(self, doc_id: str) -> list[dict]:
        """Full audit trail for one document: every record ever written,
        with status + validity (paper §III-A4 audit precision). The fold
        is DOC-SCOPED: zone-map key sets let it skip every segment and
        archive that never touched this document."""
        fold = self._fold(only_doc=doc_id)
        cols = fold.columns()
        out = []
        for i in range(fold.n):
            closed = cols["valid_to"][i] != VALID_TO_OPEN
            out.append({
                "position": int(cols["position"][i]),
                "chunk_id": cols["chunk_ids"][i],
                "version": int(cols["version"][i]),
                "valid_from": int(cols["valid_from"][i]),
                "valid_to": int(cols["valid_to"][i]),
                "status": STATUS_SUPERSEDED if closed else STATUS_ACTIVE,
                "text": cols["texts"][i],
            })
        out.sort(key=lambda r: (r["position"], r["valid_from"]))
        return out

    # ------------------------------------------------------------------
    # compaction: fully-closed runs -> sorted zone-mapped archives
    # ------------------------------------------------------------------
    def compact(self, min_run: int = 2,
                fail_after: Optional[str] = None) -> dict:
        """Rewrite maximal runs of consecutive FULLY-CLOSED commits into
        single sorted archives with exact zone maps. Originals are kept
        (time travel inside a run still works); the manifest rewrite is
        the single atomic commit point — a crash after an archive .npz but
        before the manifest (``fail_after="archive"``) leaves an orphan
        file that init sweeps.

        Returns {"archived_runs", "archived_rows", "skipped_shadowed"}.
        """
        latest = self.latest_version()
        covered = set()
        for a in self.archives():
            covered.update(range(a["lo"], a["hi"] + 1))

        # full attribution replay: which closure closed which row, final
        # valid_to per row, and shadowing events (append onto an open key
        # without a closure — those keys disqualify a run because closure
        # routing through an archive would diverge).
        entries: dict[int, dict] = {}
        open_idx: dict[tuple, int] = {}
        row_version: list[int] = []
        row_vt: list[int] = []
        closed_by: dict[int, tuple[int, int]] = {}
        closure_target: dict[tuple[int, int], Optional[int]] = {}
        shadowed_keys: set = set()
        rows_of: dict[int, list[int]] = {}
        seg_cache: dict[int, dict] = {}
        quarantined_versions: set[int] = set()
        n = 0
        for v in range(1, latest + 1):
            e = self._read_entry(v)
            if e is None:
                continue
            entries[v] = e
            if not e.get("committed", True):
                continue
            for j, c in enumerate(e["closures"]):
                key = (c["doc_id"], int(c["position"]))
                row = open_idx.pop(key, None)
                closure_target[(v, j)] = row
                if row is not None:
                    closed_by[row] = (v, j)
                    row_vt[row] = int(c["closed_at"])
            if e["segment"]:
                if self.quarantine.is_quarantined(e["segment"]):
                    # rows unavailable until repair: the version can't be
                    # archived (the archive would bake the hole in)
                    quarantined_versions.add(v)
                    continue
                try:
                    seg = self.load_segment(e["segment"],
                                            e.get("checksum"))
                except CorruptionError:
                    self.quarantine_segment(
                        e, "checksum mismatch during compaction")
                    quarantined_versions.add(v)
                    continue
                seg_cache[v] = seg
                m = len(seg["position"])
                rows_of[v] = list(range(n, n + m))
                for i in range(m):
                    key = (seg["doc_ids"][i], int(seg["position"][i]))
                    if key in open_idx:
                        shadowed_keys.add(key)
                    open_idx[key] = n + i
                    row_version.append(v)
                    row_vt.append(VALID_TO_OPEN)
                n += m

        def archivable(v: int) -> bool:
            e = entries.get(v)
            if e is None or v in covered or v in quarantined_versions:
                return False
            if not e.get("committed", True):
                return True                  # contributes nothing: absorb
            for r in rows_of.get(v, ()):
                if row_vt[r] == VALID_TO_OPEN:
                    return False             # still-open row
                seg = seg_cache[v]
                i = r - rows_of[v][0]
                if (seg["doc_ids"][i], int(seg["position"][i])) \
                        in shadowed_keys:
                    return False             # closure routing would diverge
            return True

        runs: list[tuple[int, int]] = []
        v = 1
        while v <= latest:
            if not archivable(v):
                v += 1
                continue
            a = v
            while v <= latest and archivable(v):
                v += 1
            b = v - 1
            run_rows = [r for w in range(a, b + 1) for r in rows_of.get(w, ())]
            if b - a + 1 >= min_run and run_rows:
                runs.append((a, b))

        new_archives = []
        for a, b in runs:
            rec = self._build_archive(a, b, entries, rows_of, seg_cache,
                                      row_vt, row_version, closed_by,
                                      closure_target)
            new_archives.append(rec)
        if fail_after == "archive" and new_archives:   # legacy shim
            raise FaultPoint("crash after archive write, before manifest")
        if new_archives:
            FAULTS.check("cold:compact:archive", exc=FaultPoint)
        if new_archives:
            manifest = sorted(self.archives() + new_archives,
                              key=lambda r: r["lo"])
            self._write_arc_manifest(manifest)
        return {"archived_runs": len(new_archives),
                "archived_rows": sum(r["n_rows"] for r in new_archives),
                "shadowed_keys": len(shadowed_keys)}

    def _build_archive(self, a: int, b: int, entries, rows_of, seg_cache,
                       row_vt, row_version, closed_by,
                       closure_target) -> dict:
        embs, vf, vt, ver, pos, tids = [], [], [], [], [], []
        chunk_ids, doc_ids, texts = [], [], []
        closed_ver, closed_ts = [], []
        for v in range(a, b + 1):
            seg = seg_cache.get(v)
            if seg is None:
                continue
            rows = rows_of[v]
            embs.append(seg["embeddings"])
            vf.append(seg["valid_from"])
            vt.extend(row_vt[r] for r in rows)
            for r in rows:
                cv, _ = closed_by[r]
                closed_ver.append(cv)
                closed_ts.append(entries[cv]["ts"])
            ver.append(seg["version"])
            pos.append(seg["position"])
            tids.append(seg["tenant_ids"] if "tenant_ids" in seg
                        else np.zeros(len(seg["valid_from"]), np.int32))
            chunk_ids.extend(seg["chunk_ids"].tolist())
            doc_ids.extend(seg["doc_ids"].tolist())
            texts.extend(seg["texts"].tolist())
        emb = np.concatenate(embs, axis=0)
        vf = np.concatenate(vf)
        vt = np.array(vt, np.int64)
        ver = np.concatenate(ver)
        pos = np.concatenate(pos)
        tids = np.concatenate(tids).astype(np.int32)
        closed_ver = np.array(closed_ver, np.int32)
        closed_ts = np.array(closed_ts, np.int64)
        m = len(vt)

        # sorted zone-map-friendly layout + the permutation to restore
        # the exact original fold order on load:
        # disk = original[order]; original[i] = disk[orig_order[i]]
        order = np.lexsort((vf, vt))         # primary: valid_to
        orig_order = np.argsort(order).astype(np.int64)

        external, consumed = [], []
        for v in range(a, b + 1):
            e = entries.get(v)
            if e is None or not e.get("committed", True):
                continue
            for j, c in enumerate(e["closures"]):
                target = closure_target.get((v, j))
                if target is None:
                    continue                 # popped nothing: exact no-op
                if a <= row_version[target] <= b:
                    continue                 # internal: baked into rows
                external.append({"doc_id": c["doc_id"],
                                 "position": int(c["position"]),
                                 "closed_at": int(c["closed_at"])})
        for r in (r for v in range(a, b + 1) for r in rows_of.get(v, ())):
            cv, cj = closed_by[r]
            if cv > b:
                consumed.append([int(cv), int(cj)])

        buf = io.BytesIO()
        np.savez_compressed(
            buf, embeddings=emb[order], valid_from=vf[order],
            valid_to=vt[order], version=ver[order], position=pos[order],
            chunk_ids=np.array(chunk_ids)[order],
            doc_ids=np.array(doc_ids)[order],
            texts=np.array(texts)[order], orig_order=orig_order,
            closed_by_version=closed_ver[order],
            closed_by_ts=closed_ts[order],
            tenant_ids=tids[order])
        data = buf.getvalue()
        fname = f"arc-{a:08d}-{b:08d}.npz"
        _atomic_write(self._arc_path(fname), data)
        FAULTS.mutate("cold:archive:file", self._arc_path(fname))

        docs = sorted(set(doc_ids))
        committed_ts = [entries[v]["ts"] for v in range(a, b + 1)
                        if v in entries and
                        entries[v].get("committed", True)]
        return {"lo": a, "hi": b, "file": fname,
                "checksum": blob_checksum(data), "n_rows": int(m),
                "vf_min": int(vf.min()), "vf_max": int(vf.max()),
                "vt_min": int(vt.min()), "vt_max": int(vt.max()),
                "max_entry_ts": max(entries[v]["ts"]
                                    for v in range(a, b + 1) if v in entries),
                "max_committed_ts": max(committed_ts) if committed_ts else None,
                "docs": docs if len(docs) <= _ZONE_KEYS_CAP else None,
                "external_closures": external,
                "consumed": consumed}

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        snap_all = self.snapshot(include_closed=True)
        snap_cur = self.snapshot()
        def _dir_bytes(d):
            p = os.path.join(self.root, d)
            return sum(os.path.getsize(os.path.join(p, f))
                       for f in os.listdir(p))
        return {"total_records": len(snap_all),
                "active_records": len(snap_cur),
                "versions": self.latest_version(),
                "disk_bytes": _dir_bytes(_SEG_DIR),
                "checkpoint_bytes": _dir_bytes(_CKPT_DIR),
                "archive_bytes": _dir_bytes(_ARC_DIR),
                "checkpoints": len(self.checkpoints()),
                "archives": len(self.archives()),
                "quarantined": sorted(self.quarantine.names()),
                "io": dict(self.io_counters)}
