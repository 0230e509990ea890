"""repro's storage-integrity tests run against repro_torch on the CPU
(``device="cpu"``, the kernels' plain versions). The hot-rebuild tests
keep repro's exact assertion (``res_key`` lists equal after the
rebuild), which the port passes.

Storage-integrity tests (DESIGN.md §16): corruption containment,
quarantine, background scrubbing, and replica-driven repair.

Battery per artifact class (hot segment npz, fp32 sidecar, cold
segment, checkpoint, archive, WAL record): inject bit-rot / torn
writes / zeroed ranges, then assert the store QUARANTINES the artifact
and keeps serving unaffected docs instead of dying; that caches
(checkpoints, archives) fall back losslessly; that the scrubber finds
rot no query has touched; and that ``ShardFabric.repair`` restores
current AND temporal results to oracle equivalence — on live fabrics
and on reopened ones.
"""
import glob
import os

import numpy as np
import pytest

from repro_torch.core.store import LiveVectorLake
from repro_torch.core.wal import WriteAheadLog
from repro_torch.serve.maintenance import StoreMaintenance
from repro_torch.shard import ShardFabric, results_equivalent
from repro_torch.testing.faults import CORRUPT_MODES, FAULTS, corrupt_file

DIM = 32

VOCAB = ["alpha", "bravo", "carbon", "delta", "ember", "fjord",
         "glacier", "harbor", "isotope", "jetty", "kernel", "lagoon"]


@pytest.fixture(autouse=True)
def _reset_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def make_stream(n_docs=4, n_versions=3):
    """Deterministic ingest stream with strictly increasing ts."""
    stream, ts = [], 0
    for v in range(n_versions):
        for i in range(n_docs):
            ts += 1_000_000
            text = (f"{VOCAB[i]} {VOCAB[(i + v) % len(VOCAB)]} "
                    f"first chunk of doc {i} version {v}.\n\n"
                    f"{VOCAB[(i + 2 * v + 1) % len(VOCAB)]} second "
                    f"chunk payload {i} {v}.")
            stream.append((f"doc{i}", text, ts))
    return stream


def build_store(root, stream=None, **kw):
    kw.setdefault("cold_checkpoint_interval", 0)
    st = LiveVectorLake(str(root), dim=DIM, **kw, device="cpu")
    for doc, text, ts in (stream or []):
        st.ingest(doc, text, ts=ts)
    return st


def res_key(results):
    return [(r.doc_id, r.position, r.valid_from, round(r.score, 4))
            for r in results]


def cold_seg_files(st):
    return sorted(glob.glob(os.path.join(st.root, "cold", "segments",
                                         "seg-*.npz")))


def hot_seg_files(st):
    return sorted(glob.glob(os.path.join(st.root, "hot_index",
                                         "seg-*.npz")))


# ---------------------------------------------------------------------------
# WAL record CRCs
# ---------------------------------------------------------------------------
class TestWalCrc:
    def _mk(self, tmp_path, n=4):
        wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
        for i in range(n):
            t = wal.begin("ingest", {"doc_id": f"d{i}", "i": i})
            wal.mark(t, "COLD_OK")
            wal.mark(t, "COMMIT")
        return wal

    def test_torn_tail_truncated_loudly(self, tmp_path):
        wal = self._mk(tmp_path)
        path = wal._path
        with open(path, "a") as f:
            f.write('{"txn": 99, "state"')       # torn mid-write
        w2 = WriteAheadLog(path)
        assert w2.truncated_records >= 1
        assert w2.state(4) == "COMMIT"
        # REGRESSION: the torn line must be PHYSICALLY gone — records
        # appended after it must survive the NEXT replay
        t = w2.begin("ingest", {"doc_id": "post"})
        w2.mark(t, "COMMIT")
        w3 = WriteAheadLog(path)
        assert w3.state(t) == "COMMIT"
        assert w3.truncated_records == 0

    def test_bad_crc_record_truncates_and_quarantines(self, tmp_path):
        wal = self._mk(tmp_path, n=4)
        path = wal._path
        with open(path) as f:
            lines = f.readlines()
        # mutate a MIDDLE record's body, keeping valid JSON: the crc no
        # longer matches => bit-rot inside a committed record
        bad_i = len(lines) // 2
        lines[bad_i] = lines[bad_i].replace('"state":"', '"state":"X')
        with open(path, "w") as f:
            f.writelines(lines)
        w2 = WriteAheadLog(path)
        # everything from the rotten record on is dropped (loudly)...
        assert w2.truncated_records >= len(lines) - bad_i
        # ...and the discarded tail is quarantined as evidence
        assert w2.quarantine.records()
        assert any(r["artifact"] == "wal_record"
                   for r in w2.quarantine.records())

    def test_live_scrub_self_heals(self, tmp_path):
        wal = self._mk(tmp_path, n=6)
        path = wal._path
        with open(path) as f:
            lines = f.readlines()
        lines[2] = lines[2].replace('"state":"', '"state":"X')
        with open(path, "w") as f:
            f.writelines(lines)
        rep = wal.scrub()
        assert rep["bad"] >= 1
        # the log was rewritten from authoritative RAM state: a fresh
        # replay sees every transaction, zero truncation
        w2 = WriteAheadLog(path)
        assert w2.truncated_records == 0
        assert wal.scrub()["bad"] == 0

    def test_pre_crc_records_replay(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        with open(path, "w") as f:     # legacy line without a crc field
            f.write('{"txn": 1, "state": "COMMIT", "ts": 0}\n')
        w = WriteAheadLog(path)
        assert w.state(1) == "COMMIT"
        assert w.truncated_records == 0


# ---------------------------------------------------------------------------
# hot tier: segment npz + fp32 sidecar
# ---------------------------------------------------------------------------
class TestHotCorruption:
    @pytest.mark.parametrize("mode", CORRUPT_MODES)
    def test_quarantine_then_rebuild_from_cold(self, tmp_path, mode):
        st = build_store(tmp_path / "s", make_stream())
        st.hot.index.seal()
        before = res_key(st.query(f"{VOCAB[0]} first chunk", k=6))
        segs = hot_seg_files(st)
        assert segs
        assert corrupt_file(segs[0], mode)
        st2 = build_store(tmp_path / "s")
        # containment: the rotten segment was quarantined, its rows
        # re-derived from cold authority — results identical
        assert res_key(st2.query(f"{VOCAB[0]} first chunk", k=6)) \
            == before
        qdir = os.path.join(st2.root, "hot_index", "quarantine")
        assert os.path.exists(os.path.join(
            qdir, os.path.basename(segs[0])))
        assert not os.path.exists(segs[0])
        # the rebuild doubles as the repair: not degraded
        assert not st2.integrity.degraded()
        assert any(r["artifact"] == "hot_segment" and r["repaired"]
                   for r in st2.hot.index.quarantine.records())

    def test_f32_sidecar_corruption_quantized(self, tmp_path):
        st = build_store(tmp_path / "s", make_stream(), quantized=True)
        st.hot.index.seal()
        before = res_key(st.query(f"{VOCAB[1]} second chunk", k=6))
        sidecars = sorted(glob.glob(os.path.join(
            st.root, "hot_index", "seg-*.f32.npy")))
        assert sidecars
        assert corrupt_file(sidecars[0], "bitflip")
        st2 = build_store(tmp_path / "s")
        assert res_key(st2.query(f"{VOCAB[1]} second chunk", k=6)) \
            == before
        assert st2.hot.index.quarantine.records()

    def test_orphan_sweep_never_deletes_quarantined(self, tmp_path):
        st = build_store(tmp_path / "s", make_stream())
        st.hot.index.seal()
        seg = hot_seg_files(st)[0]
        corrupt_file(seg, "bitflip")
        st2 = build_store(tmp_path / "s")
        qfile = os.path.join(st2.root, "hot_index", "quarantine",
                             os.path.basename(seg))
        assert os.path.exists(qfile)
        # seal + compact cycles re-run the orphan sweep repeatedly: the
        # quarantined evidence must survive every one of them
        for doc, text, ts in make_stream(n_docs=2, n_versions=2):
            st2.ingest(doc + "x", text, ts=ts + 10_000_000)
        st2.hot.index.seal()
        while st2.hot.index.compact_once():
            pass
        assert os.path.exists(qfile)


# ---------------------------------------------------------------------------
# cold tier: segments (data), checkpoints + archives (caches)
# ---------------------------------------------------------------------------
class TestColdCorruption:
    def test_segment_quarantine_keeps_serving_others(self, tmp_path):
        stream = make_stream()
        st = build_store(tmp_path / "s", stream)
        last_ts = stream[-1][2]
        # doc0's FIRST version lives in cold segment 1 alone
        seg = cold_seg_files(st)[0]
        corrupt_file(seg, "bitflip")
        st.temporal.invalidate()
        res = st.query(f"{VOCAB[0]} first chunk", k=16,
                       at=last_ts + 1)
        # the store did NOT die; doc0's rotten rows are out, others serve
        assert res is not None
        assert st.integrity.degraded()
        assert st.integrity.affected_docs() == {"doc0"}
        assert st.cold.quarantine.is_quarantined(os.path.basename(seg))
        others = st.query(f"{VOCAB[1]} first chunk", k=8,
                          at=last_ts + 1)
        assert any(r.doc_id != "doc0" for r in others)

    def test_checkpoint_corruption_falls_back(self, tmp_path):
        stream = make_stream()
        st = build_store(tmp_path / "s", stream)
        st.cold.write_checkpoint()
        last_ts = stream[-1][2]
        st.temporal.invalidate()
        before = res_key(st.query(f"{VOCAB[2]} payload", k=8,
                                  at=last_ts + 1))
        ckpts = glob.glob(os.path.join(st.root, "cold", "_ckpt",
                                       "ckpt-*.npz"))
        assert ckpts
        corrupt_file(ckpts[0], "zero")
        st.temporal.invalidate()
        after = res_key(st.query(f"{VOCAB[2]} payload", k=8,
                                 at=last_ts + 1))
        # a checkpoint is a pure cache: fold falls back, zero data loss
        assert after == before
        assert st.cold.quarantine.is_quarantined(
            os.path.basename(ckpts[0]))
        assert not st.integrity.degraded()

    def test_archive_corruption_falls_back(self, tmp_path):
        stream = make_stream(n_docs=3, n_versions=4)
        st = build_store(tmp_path / "s", stream)
        rep = st.compact_cold(min_run=2)
        arcs = glob.glob(os.path.join(st.root, "cold", "_archive",
                                      "arc-*.npz"))
        assert rep["archived_runs"] >= 1 and arcs
        mid_ts = stream[len(stream) // 2][2]
        st.temporal.invalidate()
        before = res_key(st.query(f"{VOCAB[0]} first chunk", k=8,
                                  at=mid_ts + 1))
        corrupt_file(arcs[0], "truncate")
        st.temporal.invalidate()
        after = res_key(st.query(f"{VOCAB[0]} first chunk", k=8,
                                 at=mid_ts + 1))
        # archives are overlays over retained per-commit segments: the
        # fold retries without the rotten archive, byte-equal results
        assert after == before
        assert st.cold.quarantine.is_quarantined(
            os.path.basename(arcs[0]))
        assert not st.integrity.degraded()


# ---------------------------------------------------------------------------
# deterministic injection through FAULTS.corrupt / mutate
# ---------------------------------------------------------------------------
class TestCorruptionInjection:
    @pytest.mark.parametrize("mode", CORRUPT_MODES)
    def test_cold_segment_injection(self, tmp_path, mode):
        FAULTS.corrupt("cold:segment:file", mode=mode, nth=2)
        stream = make_stream(n_docs=3, n_versions=2)
        st = build_store(tmp_path / "s", stream)
        assert FAULTS.fired("cold:segment:file") == 1
        FAULTS.reset()
        # the write path reported success; the rot is only found when
        # the fold reads the segment back
        st.temporal.invalidate()
        st.query("anything at all", k=4, at=stream[-1][2] + 1)
        assert st.integrity.degraded()
        assert len(st.cold.quarantine.pending_data_loss()) == 1

    def test_wal_record_injection(self, tmp_path):
        FAULTS.corrupt("wal:record", mode="bitflip", nth=3)
        stream = make_stream(n_docs=2, n_versions=2)
        st = build_store(tmp_path / "s", stream)
        FAULTS.reset()
        st2 = build_store(tmp_path / "s")
        # replay truncated at the rotten record and recovery resumed
        # loudly — the store still serves
        assert st2.wal.truncated_records >= 1
        assert st2.query(f"{VOCAB[0]} first", k=4)

    def test_hot_segment_injection(self, tmp_path):
        FAULTS.corrupt("hot:segment:file", mode="zero")
        st = build_store(tmp_path / "s", make_stream(n_docs=3))
        st.hot.index.seal()
        assert FAULTS.fired("hot:segment:file") == 1
        FAULTS.reset()
        st2 = build_store(tmp_path / "s")
        assert st2.hot.index.quarantine.records()
        assert len(st2.query(f"{VOCAB[0]} first chunk", k=4)) > 0


# ---------------------------------------------------------------------------
# background scrubber
# ---------------------------------------------------------------------------
class TestScrubber:
    def test_clean_store_scrubs_clean(self, tmp_path):
        st = build_store(tmp_path / "s", make_stream())
        st.hot.index.seal()
        st.cold.write_checkpoint()
        rep = st.scrubber.scrub_full()
        assert rep["corrupt"] == 0 and rep["checked"] > 0
        state = st.scrubber.state()
        assert state["passes"] >= 1 and state["corrupt"] == 0
        assert os.path.exists(os.path.join(st.root, "SCRUB.json"))

    def test_detects_rot_no_query_ever_read(self, tmp_path):
        stream = make_stream()
        st = build_store(tmp_path / "s", stream)
        st.hot.index.seal()
        seg = cold_seg_files(st)[1]
        corrupt_file(seg, "bitflip")
        # NO query touches the rotten segment — the scrubber finds it
        rep = st.scrubber.scrub_full()
        assert rep["corrupt"] == 1
        assert st.cold.quarantine.is_quarantined(os.path.basename(seg))
        assert st.integrity.degraded()

    def test_cursor_survives_reopen(self, tmp_path):
        st = build_store(tmp_path / "s", make_stream())
        st.scrubber.scrub_once(budget=2)
        cur = st.scrubber.state()["cursor"]
        assert cur
        st2 = build_store(tmp_path / "s")
        assert st2.scrubber.state()["cursor"] == cur
        st2.scrubber.scrub_once(budget=2)
        assert st2.scrubber.state()["cursor"] != cur

    def test_scrub_heals_hot_inline(self, tmp_path):
        st = build_store(tmp_path / "s", make_stream())
        st.hot.index.seal()
        before = res_key(st.query(f"{VOCAB[0]} first chunk", k=6))
        seg = hot_seg_files(st)[0]
        corrupt_file(seg, "truncate")
        rep = st.scrubber.scrub_full()
        assert rep["corrupt"] >= 1
        # hot rot self-heals in place: quarantine + rebuild from cold
        assert res_key(st.query(f"{VOCAB[0]} first chunk", k=6)) \
            == before
        assert not st.integrity.degraded()

    def test_maintenance_scrub_job(self, tmp_path):
        st = build_store(tmp_path / "s", make_stream(n_docs=2))
        sm = StoreMaintenance(st, scrub_interval_s=1e-9)
        sm.start()
        try:
            st.ingest("docz", "fresh words arrive here. second chunk.",
                      ts=10**9)
            assert sm.drain(timeout=5.0)
            assert os.path.exists(os.path.join(st.root, "SCRUB.json"))
            assert sm.scrub_now()["corrupt"] == 0
        finally:
            sm.stop()


# ---------------------------------------------------------------------------
# replica-driven repair (the tentpole drill)
# ---------------------------------------------------------------------------
def drive(target, stream):
    for doc, text, ts in stream:
        target.ingest(doc, text, ts=ts)


def check_parity(oracle, fab, queries, k=5, **kw):
    o = oracle.query_batch(queries, k=k, **kw)
    oe = oracle.query_batch(queries, k=4 * k, **kw)
    f = fab.query_batch(queries, k=k, **kw)
    for qi in range(len(queries)):
        assert results_equivalent(o[qi], f[qi], oe[qi]), (
            kw, res_key(o[qi]), res_key(f[qi]))


def mk_pair(tmp_path, stream, replicas=2, shards=2):
    oracle = build_store(tmp_path / "oracle", stream,
                         hot_capacity=4096)
    # checkpoints off: a checkpoint is a fold overlay that can mask a
    # quarantined segment's rows (lossless fallback — good in prod,
    # but these drills need REAL data loss to exercise replica repair)
    fab = ShardFabric(str(tmp_path / "fab"), n_shards=shards,
                      replicas=replicas, dim=DIM, hot_capacity=4096,
                      cold_checkpoint_interval=0, device="cpu")
    drive(fab, stream)
    return oracle, fab


QUERIES = [f"{VOCAB[0]} first chunk", f"{VOCAB[1]} second chunk",
           f"{VOCAB[3]} payload", f"{VOCAB[5]} version"]


class TestFabricRepair:
    def test_repair_restores_oracle_equivalence(self, tmp_path):
        stream = make_stream(n_docs=6, n_versions=3)
        oracle, fab = mk_pair(tmp_path, stream)
        mid_ts = stream[len(stream) // 2][2]
        last_ts = stream[-1][2]
        victim = fab.lake("s00").store
        seg = cold_seg_files(victim)[0]
        corrupt_file(seg, "bitflip")
        # scrubber detects it (no query read the segment)
        assert victim.scrubber.scrub_full()["corrupt"] == 1
        assert victim.integrity.degraded()
        # degraded serving: the gather is stamped, nothing crashes
        fab.query_batch(QUERIES, k=5, at=last_ts + 1)
        lg = fab.planner.last_gather
        assert lg["degraded"] and lg["integrity_degraded"] == ["s00"]
        # replica-driven repair: the other owner replays the history
        rep = fab.repair()
        assert rep["docs_repaired"] >= 1
        assert rep["rows_restored"] >= 1
        assert not rep["unrepairable"]
        assert not victim.integrity.degraded()
        # current + temporal + window results all oracle-equivalent
        check_parity(oracle, fab, QUERIES, k=5)
        check_parity(oracle, fab, QUERIES, k=5, at=mid_ts + 1)
        check_parity(oracle, fab, QUERIES, k=5, at=last_ts + 1)
        check_parity(oracle, fab, QUERIES, k=5,
                     window=(0, last_ts + 1))
        fab.query_batch(QUERIES[:1], k=5)
        assert fab.planner.last_gather["integrity_degraded"] == []

    def test_repair_on_reopened_fabric(self, tmp_path):
        stream = make_stream(n_docs=4, n_versions=3)
        oracle, fab = mk_pair(tmp_path, stream)
        last_ts = stream[-1][2]
        victim = fab.lake("s01").store
        seg = cold_seg_files(victim)[-1]
        corrupt_file(seg, "zero")
        assert victim.scrubber.scrub_full()["corrupt"] == 1
        del fab, victim
        # quarantine state is durable: a fresh fabric is still degraded
        fab2 = ShardFabric(str(tmp_path / "fab"), device="cpu")
        assert fab2.lake("s01").store.integrity.degraded()
        rep = fab2.repair()
        assert rep["docs_repaired"] >= 1
        assert not fab2.lake("s01").store.integrity.degraded()
        check_parity(oracle, fab2, QUERIES, k=5)
        check_parity(oracle, fab2, QUERIES, k=5, at=last_ts + 1)

    def test_health_surfaces_integrity_and_scrub(self, tmp_path):
        stream = make_stream(n_docs=3, n_versions=2)
        _, fab = mk_pair(tmp_path, stream)
        victim = fab.lake("s00").store
        corrupt_file(cold_seg_files(victim)[0], "bitflip")
        victim.scrubber.scrub_full()
        h = fab.health()
        assert h["integrity"]["s00"]["degraded"]
        assert h["integrity"]["s00"]["data_loss_pending"] == 1
        assert h["scrub"]["s00"]["passes"] >= 1
        fab.repair()
        assert not fab.health()["integrity"]["s00"]["degraded"]

    def test_anti_entropy_finds_and_merges_divergence(self, tmp_path):
        stream = make_stream(n_docs=4, n_versions=2)
        oracle, fab = mk_pair(tmp_path, stream)
        victim = fab.lake("s00").store
        seg = cold_seg_files(victim)[0]
        corrupt_file(seg, "bitflip")
        victim.scrubber.scrub_full()
        # digests now differ between the replicas for the affected doc
        ae = fab.run_anti_entropy()
        assert ae["diverged"] >= 1 and ae["repaired"]
        # after the bidirectional merge all replicas agree again
        ae2 = fab.run_anti_entropy()
        assert ae2["diverged"] == 0
        victim.integrity.cold.mark_repaired()
        check_parity(oracle, fab, QUERIES, k=5)

    def test_double_corruption_hot_and_cold(self, tmp_path):
        """The CI drill shape: bit-rot in a hot segment AND a cold
        segment of the same shard; quarantine both, keep serving, one
        repair() restores everything."""
        stream = make_stream(n_docs=5, n_versions=3)
        oracle, fab = mk_pair(tmp_path, stream)
        last_ts = stream[-1][2]
        victim = fab.lake("s00").store
        victim.hot.index.seal()
        corrupt_file(hot_seg_files(victim)[0], "bitflip")
        corrupt_file(cold_seg_files(victim)[2], "truncate")
        rep = victim.scrubber.scrub_full()
        assert rep["corrupt"] == 2
        # both quarantined; fabric still answers
        assert fab.query_batch(QUERIES[:2], k=5)
        r = fab.repair()
        assert not r["unrepairable"]
        assert not victim.integrity.degraded()
        check_parity(oracle, fab, QUERIES, k=5)
        check_parity(oracle, fab, QUERIES, k=5, at=last_ts + 1)

    def test_repair_is_idempotent(self, tmp_path):
        stream = make_stream(n_docs=3, n_versions=2)
        oracle, fab = mk_pair(tmp_path, stream)
        victim = fab.lake("s00").store
        corrupt_file(cold_seg_files(victim)[0], "bitflip")
        victim.scrubber.scrub_full()
        r1 = fab.repair()
        assert r1["rows_restored"] >= 1
        r2 = fab.repair()
        assert r2["rows_restored"] == 0 and r2["docs_repaired"] == 0
        check_parity(oracle, fab, QUERIES, k=5)
