"""repro's chaos drills run against repro_torch on the CPU
(``device="cpu"``, the kernels' plain versions). The store drills wait
on the maintenance worker's state (``drive_settled``), never on when it
happens to merge.

Chaos drills (DESIGN.md §13): the central fault registry's trigger
semantics, plus crash/fault injection under LIVE traffic — transient
and hard faults mid-compaction and mid-checkpoint while a background
maintenance worker churns, a shard killed mid-rebalance, and a shard
hard-down served in degraded mode. Every drill asserts the always-on
invariants: zero dropped docs, zero duplicated docs, oracle-equivalent
results after recovery."""
import threading

import numpy as np
import pytest

from repro_torch.core.store import LiveVectorLake
from repro_torch.index.lsm import CompactionInterrupted, SegmentedIndex
from repro_torch.serve.maintenance import StoreMaintenance
from repro_torch.shard import (MigrationInterrupted, Rebalancer,
                               ShardFabric, results_equivalent)
from repro_torch.testing.faults import FAULTS, FaultError, FaultRegistry

DIM = 64
CAP = 8192

VOCAB = ["alpha", "bravo", "carbon", "delta", "ember", "fjord",
         "glacier", "harbor", "isotope", "jetty", "kernel", "lagoon",
         "meadow", "nebula", "orchid", "plasma", "quartz", "rivet"]


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def make_stream(rng, n_docs=10, n_versions=2, chunks=2, words=5):
    stream, ts, texts = [], 0, {}
    for _ in range(n_versions):
        for i in range(n_docs):
            doc = f"doc{i}"
            if doc not in texts:
                texts[doc] = [" ".join(rng.choice(VOCAB, words))
                              for _ in range(chunks)]
            else:
                texts[doc][int(rng.integers(chunks))] = \
                    " ".join(rng.choice(VOCAB, words))
            ts += 1_000_000
            stream.append((doc, "\n\n".join(texts[doc]), ts))
    return stream


def drive(target, stream):
    for doc, text, ts in stream:
        target.ingest(doc, text, ts=ts)


def drive_settled(store, stream, maint):
    """``drive`` with the worker drained after every write: each seal and
    merge runs at the write that asked for it, as inline maintenance
    would, so which merges run (and which armed faults fire) follows
    from the stream alone, never from when the worker thread got the
    CPU."""
    for doc, text, ts in stream:
        store.ingest(doc, text, ts=ts)
        assert maint.drain(timeout=20.0)


def check_parity(oracle, target, queries, k=5, **kw):
    o = oracle.query_batch(queries, k=k, **kw)
    oe = oracle.query_batch(queries, k=4 * k, **kw)
    f = target.query_batch(queries, k=k, **kw)
    for qi in range(len(queries)):
        assert results_equivalent(o[qi], f[qi], oe[qi]), (
            [(r.doc_id, r.position, r.score) for r in o[qi]],
            [(r.doc_id, r.position, r.score) for r in f[qi]])


# ---------------------------------------------------------------------------
# fault registry semantics
# ---------------------------------------------------------------------------
class TestFaultRegistry:
    def test_default_rule_fires_first_call_once(self):
        reg = FaultRegistry()
        reg.arm("p")
        with pytest.raises(FaultError):
            reg.check("p")
        reg.check("p")                    # times=1: self-disarmed
        assert reg.fired("p") == 1

    def test_nth_trigger_then_fires_until_times_exhausted(self):
        reg = FaultRegistry()
        reg.arm("p", nth=2, times=2)
        reg.check("p")                    # call 1: below nth
        with pytest.raises(FaultError):
            reg.check("p")                # call 2: trips
        with pytest.raises(FaultError):
            reg.check("p")                # keeps firing (times=2)
        reg.check("p")                    # exhausted
        assert reg.fired("p") == 2
        assert reg.history == ["p", "p"]

    def test_probabilistic_replay_is_seed_deterministic(self):
        def run(seed):
            reg = FaultRegistry(seed=seed)
            reg.arm("p", prob=0.4, times=10**9)
            fires = []
            for _ in range(50):
                try:
                    reg.check("p")
                    fires.append(0)
                except FaultError:
                    fires.append(1)
            return fires

        assert run(7) == run(7)           # deterministic replay
        assert run(7) != run(8)           # and actually seed-sensitive
        assert 0 < sum(run(7)) < 50

    def test_prefix_rule_matches_any_suffix(self):
        reg = FaultRegistry()
        reg.arm("rebalance:copy:*", times=2)
        with pytest.raises(FaultError):
            reg.check("rebalance:copy:0")
        with pytest.raises(FaultError):
            reg.check("rebalance:copy:7")
        reg.check("rebalance:copy:8")     # exhausted
        reg.check("rebalance:before_flip")   # different point: no match

    def test_rule_exc_overrides_call_site_exc(self):
        reg = FaultRegistry()
        reg.arm("p", exc=KeyError)
        with pytest.raises(KeyError):
            reg.check("p", exc=ValueError)
        reg.arm("q")
        with pytest.raises(ValueError):
            reg.check("q", exc=ValueError)

    def test_disarm_reset_and_introspection(self):
        reg = FaultRegistry()
        reg.arm("a")
        reg.arm("b:*")
        assert reg.armed() == ["a", "b:*"]
        reg.disarm("a")
        reg.check("a")                    # disarmed: silent
        reg.reset()
        assert reg.armed() == [] and reg.fired() == 0

    def test_registry_matches_legacy_fail_at_shim(self, tmp_path):
        """Same crash, two switches: the legacy per-index ``fail_at``
        and the registry rule must interrupt the identical point with
        the identical exception type."""
        rng = np.random.default_rng(3)

        def filled(root):
            idx = SegmentedIndex(DIM, mem_capacity=4, root=root,
                                 device="cpu")
            from repro_torch.core.types import ChunkRecord
            for i in range(3):
                emb = rng.standard_normal(DIM).astype(np.float32)
                emb /= np.linalg.norm(emb)
                idx.insert([ChunkRecord(
                    chunk_id=f"c{i}", doc_id="d", position=i,
                    text=f"t{i}", embedding=emb, valid_from=i + 1)])
            return idx

        legacy = filled(str(tmp_path / "legacy"))
        legacy.fail_at = "seal:before_manifest"
        with pytest.raises(CompactionInterrupted):
            legacy.seal()

        modern = filled(str(tmp_path / "modern"))
        FAULTS.arm("lsm:seal:before_manifest")
        with pytest.raises(CompactionInterrupted):
            modern.seal()


# ---------------------------------------------------------------------------
# store-level drills under background maintenance
# ---------------------------------------------------------------------------
class TestStoreChaos:
    """repro's drills, waiting on the worker's state (``drain`` after each
    write, ``drive_settled``) instead of on when it happens to merge."""

    def _pair(self, tmp_path, **maint_kw):
        oracle = LiveVectorLake(str(tmp_path / "oracle"), dim=DIM,
                                hot_capacity=CAP, device="cpu")
        root = str(tmp_path / "chaos")
        store = LiveVectorLake(root, dim=DIM, hot_capacity=8, device="cpu")
        maint = StoreMaintenance(store, backoff_s=1e-4,
                                 **maint_kw).start()
        return oracle, store, maint, root

    def test_transient_fault_mid_compaction_worker_retries(self, tmp_path):
        oracle, store, maint, _ = self._pair(tmp_path)
        FAULTS.arm("lsm:merge:before_manifest", times=1)   # transient
        rng = np.random.default_rng(11)
        stream = make_stream(rng, n_docs=14, n_versions=2)
        drive(oracle, stream)
        drive_settled(store, stream, maint)
        assert maint.drain(timeout=20.0)
        maint.stop()
        assert FAULTS.fired("lsm:merge:before_manifest") == 1
        assert maint.worker.last_error is None    # retry converged
        assert store.hot.index.stats()["merges"] >= 1
        queries = [" ".join(rng.choice(VOCAB, 4)) for _ in range(6)]
        check_parity(oracle, store, queries)
        mid = stream[len(stream) // 2][2]
        check_parity(oracle, store, queries, at=mid)

    def test_hard_fault_mid_compaction_then_recovery(self, tmp_path):
        oracle, store, maint, root = self._pair(tmp_path)
        FAULTS.arm("lsm:merge:before_manifest", times=10**9)  # hard-down
        rng = np.random.default_rng(12)
        stream = make_stream(rng, n_docs=14, n_versions=2)
        drive(oracle, stream)
        drive_settled(store, stream, maint)
        assert maint.drain(timeout=20.0)
        # retries exhausted: loud failure, serving still correct
        assert maint.worker.last_error is not None
        queries = [" ".join(rng.choice(VOCAB, 4)) for _ in range(6)]
        check_parity(oracle, store, queries)
        maint.stop()
        FAULTS.reset()
        # crash-equivalent reopen: recovery converges, zero loss/dup
        re = LiveVectorLake(root, dim=DIM, hot_capacity=8, device="cpu")
        assert len(re.hot) == len(oracle.hot)
        check_parity(oracle, re, queries)
        check_parity(oracle, re, queries, at=stream[-1][2] // 2)

    def test_crash_mid_checkpoint_under_live_traffic(self, tmp_path):
        oracle, store, maint, root = self._pair(tmp_path,
                                                checkpoint_every=3)
        rng = np.random.default_rng(13)
        stream = make_stream(rng, n_docs=12, n_versions=2)
        drive(oracle, stream)   # before arming: FAULTS is process-wide
        FAULTS.arm("cold:checkpoint:data", times=1)        # transient
        errors = []

        def reader():
            try:
                for _ in range(30):
                    store.query("quartz rivet plasma", k=3)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=reader)
        t.start()
        drive_settled(store, stream, maint)
        t.join(30.0)
        assert maint.drain(timeout=20.0)
        maint.stop()
        assert errors == []
        assert FAULTS.fired("cold:checkpoint:data") == 1
        assert store.cold.stats()["checkpoints"] >= 1      # retry landed
        queries = [" ".join(rng.choice(VOCAB, 4)) for _ in range(6)]
        check_parity(oracle, store, queries)
        re = LiveVectorLake(root, dim=DIM, hot_capacity=8, device="cpu")
        check_parity(oracle, re, queries, at=stream[-1][2] // 2)


# ---------------------------------------------------------------------------
# fabric drills: rebalance kill + shard hard-down
# ---------------------------------------------------------------------------
class TestFabricChaos:
    def test_kill_shard_mid_rebalance_under_live_traffic(self, tmp_path):
        rng = np.random.default_rng(21)
        stream = make_stream(rng, n_docs=12, n_versions=2)
        oracle = LiveVectorLake(str(tmp_path / "oracle"), dim=DIM,
                                hot_capacity=CAP, device="cpu")
        root = str(tmp_path / "fab")
        fab = ShardFabric(root, n_shards=2, dim=DIM, hot_capacity=CAP, device="cpu")
        drive(oracle, stream)
        drive(fab, stream)
        queries = [" ".join(rng.choice(VOCAB, 4)) for _ in range(6)]

        # kill the migration on its second doc copy
        FAULTS.arm("rebalance:copy:*", nth=2, times=1)
        with pytest.raises(MigrationInterrupted):
            Rebalancer(fab).split("s02")
        assert FAULTS.fired() == 1        # the drill really fired
        # old ring stays authoritative: serving continues mid-crash
        check_parity(oracle, fab, queries)

        # live traffic lands WHILE the transition is pending
        ts = stream[-1][2]
        oracle.ingest("doc0", "umbra vertex willow", ts=ts + 1_000_000)
        fab.ingest("doc0", "umbra vertex willow", ts=ts + 1_000_000)

        # crash-equivalent reopen rolls the migration forward
        fab2 = ShardFabric(root, dim=DIM, device="cpu")
        assert fab2.manifest.load()["transition"] is None
        assert "s02" in fab2.ring.shards
        assert sorted(fab2.all_docs()) == \
            sorted(oracle.hash_store.doc_ids())      # zero dropped docs
        check_parity(oracle, fab2, queries)          # zero duplicated:
        check_parity(oracle, fab2, queries, at=ts // 2)  # dedup == oracle

    def test_one_shard_down_serves_degraded_with_markers(self, tmp_path):
        rng = np.random.default_rng(22)
        stream = make_stream(rng, n_docs=12, n_versions=2)
        root = str(tmp_path / "fab")
        fab = ShardFabric(root, n_shards=4, dim=DIM, hot_capacity=CAP,
                          degraded_reads=True, shard_retries=1, device="cpu")
        drive(fab, stream)
        queries = [" ".join(rng.choice(VOCAB, 4)) for _ in range(6)]
        full = fab.query_batch(queries, k=5)
        full_ext = fab.query_batch(queries, k=40)   # extended pool

        dead = fab.ring.shards[1]
        FAULTS.arm(f"shard:{dead}:query", times=10**9)   # hard-down
        got = fab.query_batch(queries, k=5)
        lg = fab.planner.last_gather
        assert lg["degraded"] is True
        assert lg["shards_missing"] == [dead]
        health = fab.health()
        assert health["last_gather"]["degraded"] is True
        assert health["planner"]["degraded_gathers"] >= 1
        # retries were attempted before declaring the shard down
        assert health["planner"]["shard_retries"] >= 1
        # partial top-k: every degraded result is a true full-fabric
        # result (never fabricated — checked against the extended pool,
        # since surviving rows RANK HIGHER with less competition), and
        # most of the pool survives
        full_keys = {(r.doc_id, r.position, r.valid_from)
                     for row in full_ext for r in row}
        got_n = 0
        for row in got:
            for r in row:
                assert (r.doc_id, r.position, r.valid_from) in full_keys
                got_n += 1
        assert got_n >= 0.5 * sum(len(row) for row in full)

        # the serving batcher stamps member requests with the markers
        b = fab.query_batcher(k=5)
        reqs = [b.submit(q) for q in queries[:3]]
        b.drain()
        for r in reqs:
            assert r.done and r.error is None
            assert r.info.get("degraded") is True
            assert r.info.get("shards_missing") == [dead]

    def test_r1_without_degraded_mode_still_fails_loud(self, tmp_path):
        from repro_torch.shard import ShardGatherError
        rng = np.random.default_rng(23)
        fab = ShardFabric(str(tmp_path / "fab"), n_shards=2, dim=DIM,
                          hot_capacity=CAP, device="cpu")
        drive(fab, make_stream(rng, n_docs=6, n_versions=1))
        FAULTS.arm(f"shard:{fab.ring.shards[0]}:query", times=10**9)
        with pytest.raises(ShardGatherError):
            fab.query_batch(["alpha bravo"], k=3)
