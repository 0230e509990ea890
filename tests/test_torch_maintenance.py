"""repro's maintenance tests run against repro_torch on the CPU
(``device="cpu"``, the kernels' plain versions).

Background maintenance workers (DESIGN.md §13): bounded queues,
coalescing, retry/backoff, clean drain/stop — and a LiveVectorLake
serving correctly while seal/compaction/checkpointing run off-thread."""
import threading

import pytest

from repro_torch.core.store import LiveVectorLake
from repro_torch.serve.maintenance import MaintenanceWorker, StoreMaintenance
from repro_torch.testing.faults import FAULTS

DIM = 64


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


class TestMaintenanceWorker:
    def test_submit_runs_and_drain_blocks_until_done(self):
        w = MaintenanceWorker(name="t1")
        ran = []
        gate = threading.Event()
        w.submit("a", lambda: (gate.wait(1.0), ran.append("a")))
        w.submit("b", lambda: ran.append("b"))
        gate.set()
        assert w.drain(timeout=5.0)
        assert ran == ["a", "b"]
        w.stop()

    def test_same_key_coalesces_while_queued(self):
        w = MaintenanceWorker(name="t2")
        ran = []
        gate = threading.Event()
        # first job blocks the worker so subsequent submits stay queued
        w.submit("block", lambda: gate.wait(5.0))
        for _ in range(5):
            assert w.submit("x", lambda: ran.append("x"))
        gate.set()
        assert w.drain(timeout=5.0)
        assert ran == ["x"]                 # five wishes, one run
        w.stop()

    def test_full_queue_rejects_with_count_not_silence(self):
        w = MaintenanceWorker(name="t3", max_queue=2)
        gate = threading.Event()
        started = threading.Event()
        w.submit("block", lambda: (started.set(), gate.wait(5.0)))
        assert started.wait(5.0)            # blocker is OFF the queue
        assert w.submit("a", lambda: None)
        assert w.submit("b", lambda: None)
        assert not w.submit("c", lambda: None)   # past watermark
        from repro_torch.obs import REGISTRY
        rej = REGISTRY.counter("maintenance_rejected", worker="t3")
        assert rej.value >= 1
        gate.set()
        w.stop()

    def test_transient_fault_retried_to_success(self):
        w = MaintenanceWorker(name="t4", max_retries=3, backoff_s=1e-4)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")

        w.submit("j", flaky)
        assert w.drain(timeout=5.0)
        assert len(calls) == 3
        assert w.last_error is None
        w.stop()

    def test_retries_exhausted_counts_failure_loudly(self):
        w = MaintenanceWorker(name="t5", max_retries=1, backoff_s=1e-4)

        def doomed():
            raise RuntimeError("permanent")

        w.submit("j", doomed)
        assert w.drain(timeout=5.0)
        assert w.last_error is not None and w.last_error[0] == "j"
        from repro_torch.obs import REGISTRY
        assert REGISTRY.counter("maintenance_failures",
                                worker="t5").value == 1
        w.stop()

    def test_stop_is_idempotent_and_drains(self):
        w = MaintenanceWorker(name="t6")
        ran = []
        w.submit("a", lambda: ran.append(1))
        assert w.stop(timeout=5.0)
        assert ran == [1]
        assert w.stop(timeout=1.0)          # second stop: no-op


class TestStoreMaintenance:
    def _fill(self, store, n=12, ts0=1_000_000):
        for i in range(n):
            store.ingest(f"doc{i}",
                         f"background maintenance sentence {i}.",
                         ts=ts0 + i * 1000)

    def test_deferred_mode_serves_identically(self, tmp_path):
        # oracle: inline maintenance (the default path)
        a = LiveVectorLake(str(tmp_path / "a"), dim=DIM, hot_capacity=8, device="cpu")
        self._fill(a)
        # deferred: same ingests with maintenance on a worker
        b = LiveVectorLake(str(tmp_path / "b"), dim=DIM, hot_capacity=8, device="cpu")
        maint = StoreMaintenance(b, backoff_s=1e-4).start()
        self._fill(b)
        assert maint.drain(timeout=10.0)
        maint.stop()
        for q in ("maintenance sentence 3.", "maintenance sentence 9."):
            ra = [(r.doc_id, r.position, round(r.score, 5))
                  for r in a.query(q, k=5)]
            rb = [(r.doc_id, r.position, round(r.score, 5))
                  for r in b.query(q, k=5)]
            assert ra == rb

    def test_worker_drives_checkpoints(self, tmp_path):
        s = LiveVectorLake(str(tmp_path / "c"), dim=DIM,
                           cold_checkpoint_interval=4, device="cpu")
        maint = StoreMaintenance(s, checkpoint_every=4,
                                 backoff_s=1e-4).start()
        assert s.cold.checkpoint_interval == 0   # inline cadence off
        self._fill(s, n=10)
        maint.drain(timeout=10.0)
        maint.stop()
        assert s.cold.checkpoint_interval == 4   # restored
        assert s.cold.stats()["checkpoints"] >= 1

    def test_concurrent_ingest_and_query_under_churn(self, tmp_path):
        s = LiveVectorLake(str(tmp_path / "d"), dim=DIM, hot_capacity=8, device="cpu")
        maint = StoreMaintenance(s, backoff_s=1e-4).start()
        errors = []

        def writer():
            try:
                self._fill(s, n=24)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def reader():
            try:
                for _ in range(40):
                    s.query("maintenance sentence", k=3)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=writer),
              threading.Thread(target=reader),
              threading.Thread(target=reader)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
        assert maint.drain(timeout=10.0)
        maint.stop()
        assert errors == []
        assert len(s.hot) == 24
        r = s.query("maintenance sentence 17.", k=1)[0]
        assert r.doc_id == "doc17"

    def test_reopen_after_background_maintenance(self, tmp_path):
        root = str(tmp_path / "e")
        s = LiveVectorLake(root, dim=DIM, hot_capacity=8, device="cpu")
        maint = StoreMaintenance(s, backoff_s=1e-4).start()
        self._fill(s, n=16)
        maint.drain(timeout=10.0)
        maint.stop()
        s2 = LiveVectorLake(root, dim=DIM, hot_capacity=8, device="cpu")
        assert len(s2.hot) == 16
        r = s2.query("maintenance sentence 11.", k=1)[0]
        assert r.doc_id == "doc11"
