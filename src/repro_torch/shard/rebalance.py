"""Online rebalancing: shard split / merge / replica migration
(DESIGN.md §10.4).

Every topology change runs the same three-phase, manifest-epoch-driven
protocol against a TARGET ring derived from the current one:

  COPY    For each doc whose owner set changes, replay its full history
          (``import_history`` — original timestamps, exact validity
          intervals) onto each new owner. Each completed doc commits a
          new manifest epoch appending it to ``done``; imports are
          idempotent at event granularity, so a crash mid-doc re-runs
          that doc's copy without duplicating rows. The OLD ring stays
          authoritative: queries keep serving (the planner's ownership
          filter hides the half-built destinations) and ingests
          dual-write once a doc's copy is done.
  FLIP    One atomic manifest commit publishes the target ring. From
          this epoch on the new owners are authoritative; the stale
          copies on old owners are invisible to queries (ownership
          filter) — so the flip needs no coordination with serving.
  CLEANUP Sweep every shard for docs it no longer owns (purge serving
          state), delete directories of removed shards, and commit the
          final epoch with ``transition: null``.

Crash safety: the manifest transition record IS the recovery plan.
``resume()`` (called by ``ShardFabric.recover``) rolls the migration
forward from exactly the phase/doc the last epoch recorded — the
crash-injection suite proves a killed migration never loses a doc and
never serves one twice, at every fault point.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

from ..testing.faults import FAULTS
from .ring import HashRing


class MigrationInterrupted(RuntimeError):
    """Raised by the fault-injection hook to simulate a crash mid-
    migration (tests only)."""


class Rebalancer:
    def __init__(self, fabric, fail_at: Optional[str] = None,
                 fail_import_after: Optional[int] = None):
        """``fail_at`` in {"copy:<i>", "before_flip", "after_flip",
        "before_final"} simulates a crash at that protocol step;
        ``fail_import_after`` crashes inside the i-th doc's history
        import after N events (tests only)."""
        self.fabric = fabric
        self.fail_at = fail_at
        self.fail_import_after = fail_import_after

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def split(self, new_shard_id: str) -> dict:
        """Add a shard: ~1/S of the corpus re-homes onto it."""
        return self._transition("split",
                                self.fabric.ring.with_shard(new_shard_id))

    def merge(self, shard_id: str) -> dict:
        """Remove a shard: its docs re-home to their ring successors and
        the shard's directory is deleted after the flip."""
        return self._transition("merge",
                                self.fabric.ring.without_shard(shard_id))

    def set_replicas(self, replicas: int) -> dict:
        """Replica migration: raise/lower R; gained owners receive full
        history copies, dropped owners are purged in cleanup."""
        return self._transition("replicas",
                                self.fabric.ring.with_replicas(replicas))

    def resume(self) -> dict:
        """Roll a pending migration forward from the manifest's
        transition record (crash recovery)."""
        fabric = self.fabric
        state = fabric.manifest.load()
        t = (state or {}).get("transition")
        if t is None:
            fabric.set_transition(None)
            return {"op": None, "docs_copied": 0, "purged": 0}
        target = HashRing.from_dict(t["ring"])
        if t["phase"] == "copy":
            old_ring = HashRing.from_dict(state["ring"])
            fabric.ring = old_ring
            fabric.set_transition(t)
            return self._run(old_ring, target, t)
        fabric.ring = target
        fabric.set_transition(t)
        return self._finish(target, t, report={
            "op": t["op"], "docs_copied": 0,
            "docs_skipped": len(t.get("done", ())), "purged": 0})

    # ------------------------------------------------------------------
    # protocol
    # ------------------------------------------------------------------
    def _transition(self, op: str, target: HashRing) -> dict:
        fabric = self.fabric
        if fabric._transition is not None:
            raise RuntimeError("a migration is already in progress — "
                               "recover()/resume() it first")
        diff = fabric.ring.diff_owners(target, fabric.all_docs())
        copies = {}
        for d, (old, new) in diff.items():
            dsts = [s for s in new if s not in old]
            if dsts:
                copies[d] = dsts
        t = {"op": op, "ring": target.to_dict(), "phase": "copy",
             "docs": copies, "done": []}
        fabric.commit_state(fabric.ring.to_dict(), t)
        fabric.set_transition(t)
        return self._run(fabric.ring, target, t)

    def _run(self, old_ring: HashRing, target: HashRing, t: dict) -> dict:
        fabric = self.fabric
        copies = t["docs"]
        done = set(t.get("done", ()))
        report = {"op": t["op"], "docs_copied": 0,
                  "docs_skipped": len(done), "purged": 0}
        for i, doc in enumerate(sorted(copies)):
            if doc in done:
                continue
            self._fault(f"copy:{i}")
            src = next(s for s in old_ring.owners(doc)
                       if fabric.lake(s).has_doc(doc))
            rows, ver = fabric.lake(src).export_doc_history(doc)
            for dst in copies[doc]:
                fabric.lake(dst).import_history(
                    doc, rows, ver,
                    fail_after_events=self.fail_import_after)
            done.add(doc)
            t = dict(t, done=sorted(done))
            fabric.commit_state(old_ring.to_dict(), t)
            fabric.set_transition(t)
            report["docs_copied"] += 1
        self._fault("before_flip")
        # FLIP: one atomic epoch makes the target ring authoritative
        t = dict(t, phase="cleanup", done=sorted(done))
        fabric.commit_state(target.to_dict(), t)
        fabric.ring = target
        fabric.set_transition(t)
        self._fault("after_flip")
        return self._finish(target, t, report)

    def _finish(self, target: HashRing, t: dict, report: dict) -> dict:
        """CLEANUP phase: purge non-owned docs from every surviving
        shard, delete removed shards' directories, clear the
        transition. Every step is idempotent — resume re-sweeps."""
        fabric = self.fabric
        for s in target.shards:
            lk = fabric.lake(s)
            for doc in list(lk.doc_ids):
                if s not in target.owners(doc):
                    lk.purge_doc(doc)
                    report["purged"] += 1
        shards_root = os.path.join(fabric.root, "shards")
        if os.path.isdir(shards_root):
            for name in os.listdir(shards_root):
                if name not in target.shards:
                    fabric.drop_lake(name)
                    shutil.rmtree(os.path.join(shards_root, name),
                                  ignore_errors=True)
        self._fault("before_final")
        fabric.commit_state(target.to_dict(), None)
        fabric.set_transition(None)
        return report

    def _fault(self, point: str) -> None:
        if self.fail_at == point:                  # legacy per-run shim
            self.fail_at = None
            raise MigrationInterrupted(f"injected crash at {point}")
        FAULTS.check(f"rebalance:{point}", exc=MigrationInterrupted)
