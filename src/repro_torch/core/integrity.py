"""Storage integrity: typed corruption errors, quarantine, scrubbing.

Threat model (DESIGN.md §16). Every artifact the store persists — hot
segment npz + fp32 sidecar, cold segment / checkpoint / archive npz,
WAL records — already carries a SHA-256 (or CRC) written at commit
time. Before this module a verification failure was a bare ``IOError``
raised at load time: fail-stop handling for a *silent-corruption*
fault, which takes the whole store down for one rotten file and never
notices bit-rot until a read happens to trip over it.

Three cooperating mechanisms replace that:

- **Containment** (``CorruptionError`` + ``Quarantine``): a mismatch
  raises a *typed* error and atomically moves the artifact into a
  ``quarantine/`` subdirectory beside its tier root, annotated in
  ``QUARANTINE.json`` (artifact class, reason, affected docs,
  data-loss flag). Load paths treat a quarantined artifact as absent:
  caches (checkpoints, archives) fall back to the originals they were
  derived from; cold segments drop their rows from serving (degraded,
  not down); hot segments are rebuilt from cold authority. Every
  detection bumps ``corruption_detected{artifact,tier}`` and pokes the
  fault-registry listeners so the flight recorder dumps evidence.

- **Detection** (``Scrubber``): a rate-limited background job walks
  every on-disk artifact and re-verifies it against its manifest
  checksum, resuming from a persisted cursor (``SCRUB.json``) so a
  restart never loses pass progress. Scrubbing finds bit-rot *before*
  a query does; what it finds goes through the same quarantine path.

- **Repair** (``ShardFabric.repair``, see shard/shard.py): replicas
  re-derive the lost rows from their own history and the store commits
  them back with the original validity intervals baked in.

``CorruptionError`` subclasses ``IOError`` deliberately: the
pre-existing broad handlers (checkpoint refold, hot-tier full-rebuild
fallback) remain correct containment of last resort, while new code
catches the typed error to quarantine precisely.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from ..obs import REGISTRY

QUARANTINE_DIR = "quarantine"
QUARANTINE_MANIFEST = "QUARANTINE.json"
SCRUB_STATE_FILE = "SCRUB.json"


class CorruptionError(IOError):
    """Checksum mismatch on an on-disk artifact.

    ``artifact`` names the artifact class (``hot_segment``,
    ``f32_sidecar``, ``cold_segment``, ``checkpoint``, ``archive``,
    ``wal_record``), ``tier`` the storage tier, ``path`` the file."""

    def __init__(self, message: str, artifact: str = "", tier: str = "",
                 path: str = ""):
        super().__init__(message)
        self.artifact = artifact
        self.tier = tier
        self.path = path


def report_corruption(artifact: str, tier: str) -> None:
    """Detection side effects shared by every containment path: the
    ``corruption_detected{artifact,tier}`` counter plus a fault-registry
    listener poke (the flight recorder registers a listener in
    ``enable()`` — a real corruption dumps evidence exactly like an
    injected fault does)."""
    REGISTRY.counter("corruption_detected", artifact=artifact,
                     tier=tier).inc()
    try:
        from ..testing.faults import FAULTS
        FAULTS.notify(f"corruption:{tier}:{artifact}")
    except Exception:
        pass


class Quarantine:
    """Per-directory quarantine: corrupt artifacts are atomically moved
    into ``<root>/quarantine/`` (forensics preserved, orphan sweeps
    can't reach them) and annotated in ``QUARANTINE.json``. One handle
    per tier root (hot index dir, cold dir, store root for the WAL)."""

    def __init__(self, root: str, tier: str):
        self.root = root
        self.tier = tier
        self.dir = os.path.join(root, QUARANTINE_DIR)
        self._manifest = os.path.join(self.dir, QUARANTINE_MANIFEST)
        self._lock = threading.RLock()
        self._records: Optional[list[dict]] = None

    # -- manifest ------------------------------------------------------
    def _load(self) -> list[dict]:
        if self._records is None:
            try:
                with open(self._manifest, encoding="utf-8") as f:
                    self._records = json.load(f)
            except (OSError, ValueError):
                self._records = []
        return self._records

    def _save(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = self._manifest + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._records, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest)

    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._load()]

    def names(self) -> set[str]:
        with self._lock:
            return {r["file"] for r in self._load()}

    def is_quarantined(self, name: str) -> bool:
        with self._lock:
            return any(r["file"] == os.path.basename(name)
                       for r in self._load())

    # -- containment ---------------------------------------------------
    def quarantine(self, path: str, artifact: str, reason: str,
                   docs=None, data_loss: bool = False,
                   companions=()) -> dict:
        """Atomically move *path* (+ companion files, e.g. a checkpoint's
        meta sidecar) into the quarantine dir and record the event.
        Idempotent per basename; returns the (possibly merged) record.
        ``docs=None`` means the affected-doc set is unknown (e.g. a zone
        map too wide to enumerate) — repair treats that as 'every doc
        this store serves'."""
        name = os.path.basename(path)
        with self._lock:
            recs = self._load()
            os.makedirs(self.dir, exist_ok=True)
            moved = []
            for p in (path,) + tuple(companions):
                b = os.path.basename(p)
                try:
                    os.replace(p, os.path.join(self.dir, b))
                    moved.append(b)
                except OSError:
                    pass            # already moved, or never written
            for old in recs:
                if old["file"] == name:
                    old["moved"] = sorted(set(old.get("moved", []))
                                          | set(moved))
                    old["data_loss"] = bool(old.get("data_loss")
                                            or data_loss)
                    self._save()
                    return dict(old)
            rec = {"file": name, "artifact": artifact, "tier": self.tier,
                   "reason": reason, "moved": moved,
                   "docs": (sorted(docs) if docs is not None else None),
                   "data_loss": bool(data_loss), "repaired": False,
                   "ts": time.time()}
            recs.append(rec)
            self._save()
        report_corruption(artifact, self.tier)
        return dict(rec)

    # -- repair bookkeeping --------------------------------------------
    def pending(self) -> list[dict]:
        """Unrepaired records (the repair queue for this tier)."""
        with self._lock:
            return [dict(r) for r in self._load() if not r["repaired"]]

    def pending_data_loss(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._load()
                    if not r["repaired"] and r["data_loss"]]

    def mark_repaired(self, files=None) -> int:
        """Mark records repaired (all unrepaired ones, or just *files*).
        Returns how many flipped."""
        n = 0
        with self._lock:
            for r in self._load():
                if r["repaired"]:
                    continue
                if files is not None and r["file"] not in files:
                    continue
                r["repaired"] = True
                n += 1
            if n:
                self._save()
        return n


class StoreIntegrity:
    """Aggregated integrity view over one store's three tier
    quarantines (hot index dir, cold dir, WAL/store root)."""

    def __init__(self, hot: Quarantine, cold: Quarantine,
                 wal: Quarantine):
        self.hot = hot
        self.cold = cold
        self.wal = wal

    def degraded(self) -> bool:
        """True while any unrepaired data loss exists — the planner
        stamps gathers degraded and ``health()`` surfaces it."""
        return bool(self.cold.pending_data_loss()
                    or self.hot.pending())

    def hot_pending(self) -> bool:
        """Hot-tier artifacts quarantined and not yet rebuilt from cold
        authority (no data loss — cold retains the truth)."""
        return bool(self.hot.pending())

    def affected_docs(self):
        """Union of docs named by unrepaired cold data-loss records;
        None if any record's breadth is unknown."""
        docs: set[str] = set()
        for r in self.cold.pending_data_loss():
            if r["docs"] is None:
                return None
            docs.update(r["docs"])
        return docs

    def summary(self) -> dict:
        pend = self.cold.pending_data_loss()
        affected = self.affected_docs()
        return {
            "degraded": self.degraded(),
            "hot_pending": self.hot_pending(),
            "data_loss_pending": len(pend),
            "affected_docs": (sorted(affected)
                              if affected is not None else None),
            "quarantined": {
                "hot": sorted(self.hot.names()),
                "cold": sorted(self.cold.names()),
                "wal": sorted(self.wal.names()),
            },
        }


# ---------------------------------------------------------------------
# background scrubbing
# ---------------------------------------------------------------------

class Scrubber:
    """Incremental background re-verification of every on-disk artifact
    against its manifest checksum.

    The artifact walk is enumerated fresh each batch (manifests are
    small) and ordered by a stable key; the cursor — the last key
    verified — persists in ``SCRUB.json`` at the store root so passes
    survive restarts. A mismatch goes through the exact containment
    path a foreground read would take (quarantine + counters +
    recorder poke), which is the point: scrubbing finds bit-rot before
    any query reads the artifact."""

    def __init__(self, store, repair_hot: bool = True):
        self.store = store
        self.repair_hot = bool(repair_hot)
        self._state_path = os.path.join(store.root, SCRUB_STATE_FILE)
        self._lock = threading.Lock()
        self._state: Optional[dict] = None
        self._arts_cache: Optional[tuple[tuple, list]] = None
        self._pace_s = 0.0        # current batch's throttle (see scrub_once)

    # -- persisted cursor ----------------------------------------------
    def _load_state(self) -> dict:
        if self._state is None:
            try:
                with open(self._state_path, encoding="utf-8") as f:
                    self._state = json.load(f)
            except (OSError, ValueError):
                self._state = {"cursor": "", "passes": 0, "verified": 0,
                               "corrupt": 0, "last_verified_ts": {}}
        return self._state

    def _save_state(self) -> None:
        tmp = self._state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._state, f, sort_keys=True)
        os.replace(tmp, self._state_path)

    def state(self) -> dict:
        with self._lock:
            return dict(self._load_state())

    # -- artifact enumeration ------------------------------------------
    def _artifact_key(self) -> tuple:
        """Cheap change indicator for the artifact walk: hot manifest
        generation + cold version + checkpoint/archive file counts.
        Anything that adds or retires an artifact moves one of these;
        content rot does NOT (detecting that is the scrub's job, and
        the cached verify closures re-read bytes every call)."""
        st = self.store
        man = st.hot.index.manifest.load()

        def _count(d: str) -> int:
            try:
                return len(os.listdir(d))
            except OSError:
                return 0

        return (man.get("generation", 0) if man else 0,
                st.cold.latest_version(),
                _count(os.path.join(st.cold.root, "_ckpt")),
                _count(os.path.join(st.cold.root, "_archive")))

    def artifacts(self) -> list[tuple[str, str, Callable[[], bool]]]:
        """[(key, tier, verify)] sorted by key, cached until the store
        changes shape (the walk re-parses every cold log entry, which
        would otherwise dominate each background batch). ``verify``
        returns True when the artifact checks out (or vanished benignly
        — compaction and checkpoint GC race the walk), False on
        detected corruption (containment already done)."""
        key = self._artifact_key()
        if self._arts_cache is not None and self._arts_cache[0] == key:
            return self._arts_cache[1]
        out: list[tuple[str, str, Callable[[], bool]]] = []
        st = self.store
        # hot: manifest-listed segment npz (+ implied f32 sidecar)
        man = st.hot.index.manifest.load()
        if man:
            for e in man.get("segments", []):
                out.append((f"hot:seg:{e['name']}", "hot",
                            lambda e=e: self._verify_hot_segment(e)))
        # cold: committed log entries' segments
        cold = st.cold
        latest = cold.latest_version()
        for e in cold.read_entries(1, latest):
            if e.get("segment") and e.get("committed", True):
                out.append((f"cold:seg:{e['version']:08d}", "cold",
                            lambda e=e: self._verify_cold_segment(e)))
        for m in cold.checkpoints():
            out.append((f"cold:ckpt:{m['version']:08d}", "cold",
                        lambda m=m: self._verify_checkpoint(m)))
        for a in cold.archives():
            out.append((f"cold:arc:{a['file']}", "cold",
                        lambda a=a: self._verify_archive(a)))
        out.append(("wal:records", "wal", self._verify_wal))
        out.sort(key=lambda t: t[0])
        self._arts_cache = (key, out)
        return out

    # -- per-artifact verifiers ----------------------------------------
    def _verify_hot_segment(self, entry: dict) -> bool:
        from ..index.segment import verify_segment_files
        idx = self.store.hot.index
        if idx.quarantine.is_quarantined(entry["name"]):
            return True
        ok = verify_segment_files(idx.root, entry["name"],
                                  entry["checksum"])
        if ok:
            return True
        # containment: quarantine the pair; cold authority retains the
        # rows, so this is not data loss — the hot tier just needs a
        # rebuild (self-healing, no replica required)
        idx.quarantine_segment_files(entry["name"],
                                     reason="scrub checksum mismatch")
        if self.repair_hot:
            try:
                self.store.rebuild_hot()
            except Exception:
                pass
        return False

    def _verify_cold_segment(self, entry: dict) -> bool:
        from .hashing import file_checksum
        cold = self.store.cold
        name = entry["segment"]
        if cold.quarantine.is_quarantined(name):
            return True
        path = cold._seg_path(name)
        try:
            got = file_checksum(path)
        except OSError:
            return True                       # compacted away mid-walk
        if got == entry.get("checksum"):
            return True
        cold.quarantine_segment(entry, reason="scrub checksum mismatch")
        # drop the lost rows from fused serving too: re-seed from the
        # (now quarantine-skipping) fold
        self.store.temporal.invalidate()
        return False

    def _verify_checkpoint(self, meta: dict) -> bool:
        from .hashing import file_checksum
        cold = self.store.cold
        npz_path, meta_path = cold._ckpt_paths(meta["version"])
        if cold.quarantine.is_quarantined(os.path.basename(npz_path)):
            return True
        want = meta.get("checksum")
        try:
            got = file_checksum(npz_path)
        except OSError:
            return True
        if not want or got == want:
            return True
        cold.quarantine.quarantine(
            npz_path, "checkpoint", "scrub checksum mismatch",
            docs=[], data_loss=False, companions=(meta_path,))
        return False

    def _verify_archive(self, arc: dict) -> bool:
        from .hashing import file_checksum
        cold = self.store.cold
        if cold.quarantine.is_quarantined(arc["file"]):
            return True
        path = os.path.join(cold.root, "_archive", arc["file"])
        try:
            got = file_checksum(path)
        except OSError:
            return True
        if got == arc.get("checksum"):
            return True
        # archives are pure caches — the per-commit segments they were
        # folded from are retained, so the fold falls back losslessly
        cold.quarantine.quarantine(
            path, "archive", "scrub checksum mismatch",
            docs=[], data_loss=False)
        self.store.temporal.invalidate()
        return False

    def _verify_wal(self) -> bool:
        rep = self.store.wal.scrub(pace_s=self._pace_s)
        return rep["bad"] == 0

    # -- the scrub loop ------------------------------------------------
    def scrub_once(self, budget: int = 16,
                   pace_s: float = 0.0) -> dict:
        """Verify up to *budget* artifacts past the persisted cursor;
        wraps to the start when the walk is exhausted (one full wrap =
        one pass). ``pace_s`` sleeps between artifacts (GIL released)
        so a background batch interleaves with serving instead of
        monopolizing the interpreter for the whole batch — the md-raid
        style scrub throttle. Returns {"checked", "corrupt",
        "wrapped"}."""
        with self._lock:
            self._pace_s = float(pace_s)
            state = self._load_state()
            arts = self.artifacts()
            cursor = state.get("cursor", "")
            todo = [a for a in arts if a[0] > cursor]
            wrapped = False
            if not todo:
                todo = arts
                wrapped = bool(cursor)
            batch = todo[:max(1, int(budget))]
            checked = corrupt = 0
            now = time.time()
            by_tier: dict[str, list[int]] = {}    # tier -> [ok, bad]
            for key, tier, verify in batch:
                if pace_s > 0 and checked:
                    time.sleep(pace_s)
                try:
                    ok = verify()
                except Exception:
                    ok = True         # never let scrub kill the worker
                checked += 1
                tally = by_tier.setdefault(tier, [0, 0])
                if ok:
                    tally[0] += 1
                else:
                    corrupt += 1
                    tally[1] += 1
                state.setdefault("last_verified_ts", {})[tier] = now
            # metrics once per batch, not per artifact: the registry
            # locks are shared with the serving path
            for tier, (n_ok, n_bad) in by_tier.items():
                if n_ok:
                    REGISTRY.counter("scrub_verified", tier=tier).inc(n_ok)
                if n_bad:
                    REGISTRY.counter("scrub_corrupt", tier=tier).inc(n_bad)
                REGISTRY.gauge("scrub_last_ts", tier=tier).set(now)
            if batch:
                state["cursor"] = batch[-1][0]
            if wrapped or (batch and batch[-1][0] == arts[-1][0]):
                state["passes"] = state.get("passes", 0) + 1
            state["verified"] = state.get("verified", 0) + checked \
                - corrupt
            state["corrupt"] = state.get("corrupt", 0) + corrupt
            self._save_state()
            return {"checked": checked, "corrupt": corrupt,
                    "wrapped": wrapped}

    def scrub_full(self) -> dict:
        """One complete pass over every artifact (tests, repair drills)."""
        total = {"checked": 0, "corrupt": 0}
        arts = self.artifacts()
        for _ in range(len(arts) + 1):
            r = self.scrub_once(budget=max(1, len(arts)))
            total["checked"] += r["checked"]
            total["corrupt"] += r["corrupt"]
            if r["checked"] >= len(arts) or r["wrapped"]:
                break
        return total
