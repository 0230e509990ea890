"""repro_torch's shard fabric on the CPU (``device="cpu"``, the kernels'
plain versions): repro's shard fabric tests run against the port — ring
and manifest units, the oracle-equivalence property over shard counts S
in {1, 2, 4, 8}, replication + shard-failure tolerance, the device
fan-out hook, and crash-injected online rebalancing (split / merge /
replica migration) proving a killed migration never loses or
double-serves a doc — then parity with repro itself: the same stream
into both packages' fabrics gives equivalent answers (S in {1, 2, 4, 8},
R = 1 and 2, across an online split), a fabric root written by either
package reopens in the other, and the two ``device_fanout_topk`` agree.

Equivalence definition (the planner's guarantee, stated executably by
``repro_torch.shard.results_equivalent``): sharded results match the
single-lake oracle record for record and rank for rank wherever score
gaps exceed float noise; scores agree within (1e-5 rel, 1e-7 abs) —
BLAS/XLA round differently for different matrix shapes, so cross-layout
score BITS can differ by a few ulp; iso-score bands are unordered
(their order is layout-dependent on both sides).
"""
import tempfile

import numpy as np
import pytest

import torch

from repro.shard import Rebalancer as ReproRebalancer
from repro.shard import ShardFabric as ReproFabric
from repro.shard import device_fanout_topk as repro_fanout
from repro_torch.core.store import FaultInjected, LiveVectorLake
from repro_torch.shard import (CorruptFabricManifest, FabricManifest,
                               HashRing, MigrationInterrupted, Rebalancer,
                               ShardFabric, ShardGatherError,
                               device_fanout_topk, results_equivalent)
from repro_torch.testing import topk_agree

DIM = 64
CAP = 8192      # exact-scan hot tier on every lake: both sides exhaustive


# ---------------------------------------------------------------------------
# corpus + equivalence helpers
# ---------------------------------------------------------------------------
VOCAB = ["alpha", "bravo", "carbon", "delta", "ember", "fjord", "glacier",
         "harbor", "isotope", "jetty", "kernel", "lagoon", "meadow",
         "nebula", "orchid", "plasma", "quartz", "rivet", "summit",
         "timber", "umbra", "vertex", "willow", "xylem", "yonder", "zephyr"]


def make_stream(rng, n_docs=12, n_versions=3, chunks=3, words=6):
    """Deterministic ingest stream [(doc_id, text, ts)] with strictly
    increasing ts, updates re-rolling a random chunk each version."""
    stream = []
    ts = 0
    texts = {}
    for v in range(n_versions):
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


def make_queries(rng, n=8, words=4):
    return [" ".join(rng.choice(VOCAB, words)) for _ in range(n)]


def assert_equivalent(oracle_res, fab_res, oracle_ext):
    assert results_equivalent(oracle_res, fab_res, oracle_ext), (
        [(r.doc_id, r.position, r.valid_from, r.score)
         for r in oracle_res],
        [(r.doc_id, r.position, r.valid_from, r.score)
         for r in fab_res])


def check_parity(oracle, fab, queries, k=5, **kw):
    o = oracle.query_batch(queries, k=k, **kw)
    oe = oracle.query_batch(queries, k=4 * k, **kw)
    f = fab.query_batch(queries, k=k, **kw)
    for qi in range(len(queries)):
        assert_equivalent(o[qi], f[qi], oe[qi])


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------
class TestHashRing:
    def test_determinism_and_distinct_owners(self):
        ring = HashRing(["s0", "s1", "s2", "s3"], vnodes=32, replicas=3)
        for i in range(50):
            o1 = ring.owners(f"doc{i}")
            o2 = HashRing(["s3", "s1", "s0", "s2"], vnodes=32,
                          replicas=3).owners(f"doc{i}")
            assert o1 == o2                       # order-independent build
            assert len(set(o1)) == 3

    def test_replicas_clamped_and_validated(self):
        assert HashRing(["a", "b"], replicas=5).replicas == 2
        with pytest.raises(ValueError):
            HashRing([], replicas=1)
        with pytest.raises(ValueError):
            HashRing(["a", "a"])
        with pytest.raises(ValueError):
            HashRing(["a"], replicas=0)

    def test_minimal_movement_on_add(self):
        ring = HashRing([f"s{i}" for i in range(4)], vnodes=64)
        docs = [f"doc{i}" for i in range(400)]
        diff = ring.diff_owners(ring.with_shard("s4"), docs)
        # every changed doc gained the new shard, and only ~1/S move
        for d, (old, new) in diff.items():
            assert "s4" in new
        assert 0 < len(diff) < len(docs) // 2

    def test_remove_reverses_add(self):
        ring = HashRing(["s0", "s1", "s2"], vnodes=16, replicas=2)
        assert ring.with_shard("s3").without_shard("s3") == ring

    def test_roundtrip(self):
        ring = HashRing(["a", "b", "c"], vnodes=8, replicas=2)
        assert HashRing.from_dict(ring.to_dict()) == ring


# ---------------------------------------------------------------------------
# fabric manifest
# ---------------------------------------------------------------------------
class TestFabricManifest:
    def test_epochs_monotonic_and_atomic(self):
        with tempfile.TemporaryDirectory() as root:
            m = FabricManifest(root)
            assert m.load() is None
            assert m.commit({"ring": {"shards": ["a"]}}) == 1
            assert m.commit({"ring": {"shards": ["a", "b"]}}) == 2
            state = m.load()
            assert state["epoch"] == 2
            assert state["ring"]["shards"] == ["a", "b"]

    def test_checksum_detects_corruption(self):
        import os
        with tempfile.TemporaryDirectory() as root:
            m = FabricManifest(root)
            m.commit({"ring": {"shards": ["a"]}})
            path = os.path.join(root, "FABRIC.json")
            data = open(path).read()
            assert '"a"' in data
            open(path, "w").write(data.replace('"a"', '"b"'))
            assert m.load() is None               # checksum mismatch
            with pytest.raises(CorruptFabricManifest):
                ShardFabric(root, dim=DIM, device="cpu")


# ---------------------------------------------------------------------------
# oracle equivalence (the property of acceptance criterion 3)
# ---------------------------------------------------------------------------
class TestOracleEquivalence:
    @pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
    def test_sharded_matches_single_lake(self, n_shards):
        rng = np.random.default_rng(100 + n_shards)
        stream = make_stream(rng)
        queries = make_queries(rng)
        last_ts = stream[-1][2]
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            fab = ShardFabric(r2, n_shards=n_shards, dim=DIM,
                              hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            drive(fab, stream)
            check_parity(oracle, fab, queries)                  # current
            for ts in (stream[3][2], last_ts // 2, last_ts):    # temporal
                check_parity(oracle, fab, queries, at=ts)
            check_parity(oracle, fab, queries,                  # windows
                         window=(stream[2][2], last_ts // 2))
            check_parity(oracle, fab, queries, window=(1, last_ts + 1))

    def test_replicated_fabric_matches_oracle(self):
        rng = np.random.default_rng(7)
        stream = make_stream(rng, n_docs=10)
        queries = make_queries(rng)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            fab = ShardFabric(r2, n_shards=4, replicas=2, dim=DIM,
                              hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            drive(fab, stream)
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=stream[-1][2] // 2)
            # every doc is on exactly R owner lakes
            for doc in fab.all_docs():
                holders = [s for s in fab.ring.shards
                           if fab.lake(s).has_doc(doc)]
                assert sorted(holders) == sorted(fab.ring.owners(doc))

    def test_reopened_fabric_clock_matches_oracle(self):
        """A fresh fabric process starts with _last_ts=0; its monotonic
        clock must sync from EVERY shard before the first resolution,
        or a stale explicit ts would resolve below instants other
        shards already stored (diverging from the oracle)."""
        rng = np.random.default_rng(77)
        stream = make_stream(rng, n_docs=12)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            fab = ShardFabric(r2, n_shards=4, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            drive(fab, stream)
            del fab
            fab2 = ShardFabric(r2, device="cpu")          # bare reopen, cold clock
            s_o = oracle.ingest("doc0", "quartz rivet summit",
                                ts=2_000_000)
            s_f = fab2.ingest("doc0", "quartz rivet summit",
                              ts=2_000_000)
            assert s_o.ts == s_f.ts
            check_parity(oracle, fab2, make_queries(rng))
            check_parity(oracle, fab2, make_queries(rng), at=s_f.ts - 1)

    def test_mixed_intent_batch_and_batcher(self):
        rng = np.random.default_rng(11)
        stream = make_stream(rng, n_docs=8)
        mid = stream[-1][2] // 2
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            drive(fab, stream)
            payloads = [("alpha bravo", None, None),
                        ("carbon delta", mid, None),
                        ("ember fjord", None, (1, mid)),
                        ("glacier harbor", None, None),
                        ("isotope jetty", mid, None)]
            b = fab.query_batcher(k=4)
            reqs = [b.submit(p) for p in payloads]
            b.drain()
            for req, (text, at, window) in zip(reqs, payloads):
                assert req.done and req.error is None
                o = oracle.query_batch([text], k=4, at=at, window=window)[0]
                oe = oracle.query_batch([text], k=16, at=at,
                                        window=window)[0]
                assert_equivalent(o, req.result, oe)


# ---------------------------------------------------------------------------
# failure tolerance
# ---------------------------------------------------------------------------
class TestShardFailure:
    def _fabric(self, root, rng, replicas):
        stream = make_stream(rng, n_docs=10)
        fab = ShardFabric(root, n_shards=4, replicas=replicas, dim=DIM,
                          hot_capacity=CAP, device="cpu")
        drive(fab, stream)
        return fab, stream

    def test_r1_shard_failure_fails_the_batch(self):
        rng = np.random.default_rng(21)
        with tempfile.TemporaryDirectory() as root:
            fab, _ = self._fabric(root, rng, replicas=1)
            dead = fab.ring.shards[1]

            def boom(*a, **k):
                raise RuntimeError("shard down")
            fab.lake(dead).query_batch = boom
            with pytest.raises(ShardGatherError):
                fab.query_batch(["alpha bravo"], k=3)

    def test_r2_survives_one_dead_shard_identically(self):
        rng = np.random.default_rng(22)
        stream = make_stream(rng, n_docs=10)
        queries = make_queries(rng)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=4, replicas=2, dim=DIM,
                              hot_capacity=CAP, device="cpu")
            drive(fab, stream)
            dead = fab.ring.shards[2]

            def boom(*a, **k):
                raise RuntimeError("shard down")
            fab.lake(dead).query_batch = boom
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=stream[-1][2] // 2)
            assert fab.planner.stats["shard_failures"] > 0


# ---------------------------------------------------------------------------
# online rebalancing + crash injection
# ---------------------------------------------------------------------------
def exactly_once_docs(fab, stream):
    """Each doc's position-0 current chunk must appear exactly once in a
    query that retrieves it."""
    current = {}
    for doc, text, _ in stream:
        current[doc] = text.split("\n\n")[0]
    for doc, chunk in current.items():
        res = fab.query(chunk, k=10)
        hits = [r for r in res if r.doc_id == doc and r.position == 0]
        assert len(hits) == 1, (doc, len(hits))


class TestRebalance:
    def test_split_merge_replicas_keep_oracle_parity(self):
        rng = np.random.default_rng(31)
        stream = make_stream(rng, n_docs=12)
        queries = make_queries(rng)
        mid = stream[-1][2] // 2
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(fab, stream)
            rb = Rebalancer(fab)
            rep = rb.split("s03")
            assert rep["docs_copied"] > 0
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=mid)     # history moved
            rb.merge("s01")
            assert "s01" not in fab.ring.shards
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=mid)
            Rebalancer(fab).set_replicas(2)
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=mid)

    def test_ingest_during_copy_phase_lands_post_flip(self):
        """Docs created/updated while a migration is mid-copy must be
        served after the flip (union routing + dual-write)."""
        rng = np.random.default_rng(32)
        stream = make_stream(rng, n_docs=10, n_versions=2)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            drive(fab, stream)
            ts = stream[-1][2]
            with pytest.raises(MigrationInterrupted):
                Rebalancer(fab, fail_at="before_flip").split("s03")
            mid_stream = [("docnew", "quartz rivet summit\n\ntimber umbra",
                           ts + 1_000_000)]
            moving = sorted(fab._transition["docs"])
            for doc in moving[:1]:       # update an already-copied doc
                mid_stream.append((doc, "vertex willow xylem\n\nyonder "
                                   "zephyr alpha", ts + 2_000_000))
            drive(oracle, mid_stream)
            drive(fab, mid_stream)
            Rebalancer(fab).resume()
            assert fab.manifest.load()["transition"] is None
            queries = make_queries(rng) + ["quartz rivet summit",
                                           "vertex willow xylem"]
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=ts + 1_500_000)

    @pytest.mark.parametrize("fault", ["copy:0", "copy:1", "before_flip",
                                       "after_flip", "before_final"])
    def test_killed_split_recovers_exactly_once(self, fault):
        rng = np.random.default_rng(33)
        stream = make_stream(rng, n_docs=10)
        queries = make_queries(rng)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(fab, stream)
            with pytest.raises(MigrationInterrupted):
                Rebalancer(fab, fail_at=fault).split("s03")
            # crashed mid-migration: a FRESH fabric (new process) resumes
            # from the manifest transition record on open
            fab2 = ShardFabric(r2, dim=DIM, hot_capacity=CAP, device="cpu")
            assert fab2.manifest.load()["transition"] is None
            assert "s03" in fab2.ring.shards
            exactly_once_docs(fab2, stream)
            check_parity(oracle, fab2, queries)
            check_parity(oracle, fab2, queries, at=stream[-1][2] // 2)

    def test_killed_import_mid_doc_recovers(self):
        """Crash INSIDE a doc's history import (partial cold commits on
        the destination): the event-idempotent import resumes without
        duplicating or losing rows."""
        rng = np.random.default_rng(34)
        stream = make_stream(rng, n_docs=10)
        queries = make_queries(rng)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(fab, stream)
            with pytest.raises(FaultInjected):
                Rebalancer(fab, fail_import_after=1).split("s03")
            # bare reopen: dim/hot_capacity adopted from the manifest
            fab2 = ShardFabric(r2, device="cpu")
            assert fab2.manifest.load()["transition"] is None
            exactly_once_docs(fab2, stream)
            check_parity(oracle, fab2, queries)
            check_parity(oracle, fab2, queries, at=stream[-1][2] // 2)

    def test_killed_merge_recovers(self):
        rng = np.random.default_rng(35)
        stream = make_stream(rng, n_docs=10)
        queries = make_queries(rng)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=4, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(fab, stream)
            victim = fab.ring.shards[0]
            with pytest.raises(MigrationInterrupted):
                Rebalancer(fab, fail_at="after_flip").merge(victim)
            fab2 = ShardFabric(r2, dim=DIM, hot_capacity=CAP, device="cpu")
            assert victim not in fab2.ring.shards
            exactly_once_docs(fab2, stream)
            check_parity(oracle, fab2, queries)
            check_parity(oracle, fab2, queries, at=stream[-1][2] // 2)

    def test_doc_can_move_back_to_former_owner(self):
        """split then merge moves some docs back to a shard that once
        served them (stale cold history on the destination): event-level
        idempotent import must reconcile, not duplicate."""
        rng = np.random.default_rng(36)
        stream = make_stream(rng, n_docs=12)
        queries = make_queries(rng)
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP, device="cpu")
            drive(fab, stream)
            rb = Rebalancer(fab)
            rb.split("s03")
            rb.merge("s03")             # everything moves home again
            exactly_once_docs(fab, stream)
            check_parity(oracle, fab, queries)
            check_parity(oracle, fab, queries, at=stream[-1][2] // 2)


    @pytest.mark.parametrize("at_mid", [False, True],
                             ids=["current", "historical"])
    def test_gather_straddling_a_flip_matches_one_lake(self, at_mid):
        """R = 1: a split runs to its end (flip and cleanup) after the
        last shard of a gather has answered and before the merge. The
        merge filters ownership by the ring the scatter read, so the old
        owners' candidates of moved docs still count (repro's merge read
        the ring again and dropped them: 3-7 of 8 answers wrong)."""
        rng = np.random.default_rng(41)
        stream = make_stream(rng, n_docs=16)
        queries = make_queries(rng)
        kw = {"at": stream[-1][2] // 2} if at_mid else {}
        with tempfile.TemporaryDirectory() as r1, \
                tempfile.TemporaryDirectory() as r2:
            oracle = LiveVectorLake(r1, dim=DIM, hot_capacity=CAP,
                                    device="cpu")
            drive(oracle, stream)
            fab = ShardFabric(r2, n_shards=3, dim=DIM, hot_capacity=CAP,
                              device="cpu")
            drive(fab, stream)
            planner = fab.planner
            ring = fab.ring
            one_shard = planner._one_shard
            report = {}

            def split_after_last(s, *args, **kwargs):
                out = one_shard(s, *args, **kwargs)
                if s == ring.shards[-1] and not report:
                    report.update(Rebalancer(fab).split("s04"))
                return out

            planner._one_shard = split_after_last
            o = oracle.query_batch(queries, k=5, **kw)
            oe = oracle.query_batch(queries, k=20, **kw)
            f = fab.query_batch(queries, k=5, **kw)
            planner._one_shard = one_shard
            assert report["docs_copied"] > 0 and fab.ring is not ring
            for qi in range(len(queries)):
                assert_equivalent(o[qi], f[qi], oe[qi])
            check_parity(oracle, fab, queries, **kw)


# ---------------------------------------------------------------------------
# device fan-out hook
# ---------------------------------------------------------------------------
def repro_ids(res):
    """repro's ids with -1 at every -inf slot: repro leaves the index of
    an empty slot unspecified, the port makes it -1."""
    s, i = (np.asarray(x) for x in res)
    return np.where(np.isfinite(s), i, -1).astype(i.dtype)


class TestDeviceFanout:
    def _inputs(self, seed, S, N, d, Q):
        """Unit-length rows and queries, as the lakes' embeddings are, so
        that scores lie in [-1, 1] and 1e-5 is a few ulp of them."""
        rng = np.random.default_rng(seed)

        def unit(shape):
            x = rng.standard_normal(shape).astype(np.float32)
            return x / np.maximum(np.linalg.norm(x, axis=-1,
                                                 keepdims=True), 1e-9)
        emb = unit((S, N, d))
        mask = rng.random((S, N)) > 0.25
        return unit((Q, d)), emb, mask

    def test_matches_per_shard_dispatch(self):
        from repro_torch.kernels.topk_search.ops import topk_search
        S, N, d, Q, k = 4, 192, 32, 5, 7
        q, emb, mask = self._inputs(40, S, N, d, Q)
        s, i = device_fanout_topk(q, emb, mask, k, devices=["cpu"])
        assert s.shape == (S, Q, k) and i.shape == (S, Q, k)
        assert s.dtype == np.float32 and i.dtype == np.int32
        for si in range(S):
            rs, ri = topk_search(torch.from_numpy(q),
                                 torch.from_numpy(emb[si]),
                                 torch.from_numpy(mask[si]), k)
            assert np.array_equal(rs.numpy(), s[si])
            assert np.array_equal(ri.numpy(), i[si])

    @pytest.mark.parametrize("S", [2, 3])
    def test_split_over_devices_matches_one_device(self, S):
        """Two devices take contiguous shard blocks where they divide S
        (S = 2), else every shard runs on the first (S = 3): either way
        the blocks equal the one-device call bit for bit."""
        q, emb, mask = self._inputs(41, S, 128, 16, 3)
        base = device_fanout_topk(q, emb, mask, 5, devices=["cpu"])
        fanned = device_fanout_topk(q, emb, mask, 5,
                                    devices=["cpu", "cpu"])
        assert np.array_equal(base[0], fanned[0])
        assert np.array_equal(base[1], fanned[1])

    def test_torch_stacks_stay_where_they_lie(self):
        q, emb, mask = self._inputs(42, 3, 100, 16, 4)
        want = device_fanout_topk(q, emb, mask, 6, devices=["cpu"])
        got = device_fanout_topk(q, torch.from_numpy(emb),
                                 torch.from_numpy(mask), 6)
        assert np.array_equal(want[0], got[0])
        assert np.array_equal(want[1], got[1])

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        q, emb, mask = self._inputs(43, 2, 16, 8, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_fanout_topk(q, emb, mask, 3)

    @pytest.mark.parametrize("S,N,k", [(0, 64, 5), (3, 64, 0), (2, 0, 5),
                                       (2, 4, 9)])
    def test_empty_and_clipped_shapes_match_repro(self, S, N, k):
        q, emb, mask = self._inputs(44, S, N, 8, 3)
        got = device_fanout_topk(q, emb, mask, k, devices=["cpu"])
        want = repro_fanout(q, emb, mask, k)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(got[1], repro_ids(want))

    @pytest.mark.parametrize("S,N,d,Q,k", [(4, 192, 32, 5, 7),
                                           (8, 300, 64, 2, 20),
                                           (2, 1000, 384, 3, 10)])
    def test_matches_repro(self, S, N, d, Q, k):
        """The port against repro's vmapped kernel on the same numpy
        inputs: scores within 1e-5, ids equal wherever the reference
        scores are more than 1e-5 apart (repro at k + 1 gives the k-th
        slot its neighbour), masked slots (-inf, -1) on both sides."""
        q, emb, mask = self._inputs(45 + S, S, N, d, Q)
        mask[0, :N - 3] = False               # a shard with 3 live rows
        got = device_fanout_topk(q, emb, mask, k, devices=["cpu"])
        want = repro_fanout(q, emb, mask, k + 1)
        assert got[0].shape == (S, Q, k) and got[0].dtype == np.float32
        assert got[1].dtype == np.asarray(want[1]).dtype
        want_ids = repro_ids(want)
        for si in range(S):
            ok, err, why = topk_agree(got[0][si], got[1][si],
                                      np.asarray(want[0][si]), want_ids[si],
                                      score_atol=1e-5, gap=1e-5)
            assert ok, (si, err, why)


# ---------------------------------------------------------------------------
# parity with repro's fabric: the same stream into both packages
# ---------------------------------------------------------------------------
PARITY_DIM = 128        # benchmarks/shard_scaling.py's smoke gate
PARITY_CAP = 1 << 15


def parity_setup():
    rng = np.random.default_rng(0)
    stream = make_stream(rng, n_docs=24, n_versions=2)
    queries = make_queries(rng, n=16)
    return stream, queries


def parity_mixes(stream):
    last = stream[-1][2]
    return [{}, {"at": last // 2}, {"at": stream[5][2]},
            {"window": (stream[2][2], last // 2)}]


def assert_fabrics_agree(want_fab, got_fab, queries, mixes, k=10):
    for kw in mixes:
        want = want_fab.query_batch(queries, k=k, **kw)
        ext = want_fab.query_batch(queries, k=4 * k, **kw)
        got = got_fab.query_batch(queries, k=k, **kw)
        for qi in range(len(queries)):
            assert_equivalent(want[qi], got[qi], ext[qi])


class TestReproParity:
    @pytest.mark.parametrize("n_shards,replicas", [(1, 1), (2, 1), (4, 1),
                                                   (8, 1), (2, 2), (8, 2)])
    def test_fabrics_agree(self, tmp_path, n_shards, replicas):
        stream, queries = parity_setup()
        kw = dict(n_shards=n_shards, replicas=replicas, dim=PARITY_DIM,
                  hot_capacity=PARITY_CAP)
        ref = ReproFabric(str(tmp_path / "repro"), **kw)
        port = ShardFabric(str(tmp_path / "port"), device="cpu", **kw)
        drive(ref, stream)
        drive(port, stream)
        assert port.ring.to_dict() == ref.ring.to_dict()
        assert_fabrics_agree(ref, port, queries, parity_mixes(stream))

    def test_split_agrees(self, tmp_path):
        stream, queries = parity_setup()
        kw = dict(n_shards=2, dim=PARITY_DIM, hot_capacity=PARITY_CAP)
        ref = ReproFabric(str(tmp_path / "repro"), **kw)
        port = ShardFabric(str(tmp_path / "port"), device="cpu", **kw)
        drive(ref, stream)
        drive(port, stream)
        rep_ref = ReproRebalancer(ref).split("s02")
        rep_port = Rebalancer(port).split("s02")
        assert rep_port["docs_copied"] == rep_ref["docs_copied"] > 0
        assert port.manifest.load() == ref.manifest.load()
        assert_fabrics_agree(ref, port, queries, parity_mixes(stream))

    def test_roots_cross_between_packages(self, tmp_path):
        """FABRIC.json is byte for byte the same after the same stream,
        and a root written by either package reopens (bare) in the
        other with equivalent answers."""
        stream, queries = parity_setup()
        kw = dict(n_shards=4, replicas=2, dim=PARITY_DIM,
                  hot_capacity=PARITY_CAP)
        r_root, p_root = str(tmp_path / "repro"), str(tmp_path / "port")
        ref = ReproFabric(r_root, **kw)
        port = ShardFabric(p_root, device="cpu", **kw)
        drive(ref, stream)
        drive(port, stream)
        Rebalancer(port).split("s04")
        ReproRebalancer(ref).split("s04")
        with open(f"{r_root}/FABRIC.json", "rb") as a, \
                open(f"{p_root}/FABRIC.json", "rb") as b:
            assert a.read() == b.read()
        mixes = parity_mixes(stream)
        del ref, port
        port_of_ref = ShardFabric(r_root, device="cpu")
        ref_of_port = ReproFabric(p_root)
        assert port_of_ref.ring.to_dict() == ref_of_port.ring.to_dict()
        assert_fabrics_agree(ReproFabric(r_root), port_of_ref, queries,
                             mixes)
        assert_fabrics_agree(ref_of_port, ShardFabric(p_root, device="cpu"),
                             queries, mixes)
