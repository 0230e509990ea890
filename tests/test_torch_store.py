"""End-to-end parity of repro_torch's LiveVectorLake (device="cpu", the
kernels' plain PyTorch versions) with repro's, on one ingest stream with
explicit timestamps: current, point-in-time and window answers agree
under ``repro.shard.results_equivalent`` (ids and order wherever scores
differ by more than float noise), stores written by either package
reopen in the other, a batch answers bit-identically to its queries one
by one, and the device mirrors of memtable writes and valid_to closures
never serve stale or out-of-window rows."""
import json
import os

import pytest
import torch

from repro.core.store import LiveVectorLake as ReproLake
from repro.data.corpus import generate_corpus
from repro.shard import results_equivalent
from repro_torch.core.store import LiveVectorLake as PortLake

DIM = 64
K = 5
QUERIES = ["security policy review for staff",
           "network capacity incident response",
           "metric alpha equals units revision",
           "billing archive audit records",
           "storage backup rotation keys",
           "deployment change windows schedule",
           "identity access reviews",
           "monitoring escalation paths"]


def _ingest(lake, corpus, tenants=False):
    for v, ts in enumerate(corpus.timestamps):
        for j, doc in enumerate(corpus.doc_ids()):
            tenant = ("a" if j % 2 else "b") if tenants else ""
            lake.ingest(doc, corpus.versions[v][doc], ts=ts, tenant=tenant)


def _mixes(ts):
    return ([{}] + [{"at": t} for t in ts] + [{"at": t + 1} for t in ts]
            + [{"window": (ts[0], ts[1])}, {"window": (ts[0], ts[-1] + 1)},
               {"window": (ts[1] + 7, ts[-1])}])


def _assert_equivalent(oracle, port, texts, mixes, **kw):
    for mix in mixes:
        want = oracle.query_batch(texts, k=K, **mix, **kw)
        ext = oracle.query_batch(texts, k=4 * K, **mix, **kw)
        got = port.query_batch(texts, k=K, **mix, **kw)
        for qi in range(len(texts)):
            assert len(got[qi]) == len(want[qi])
            assert results_equivalent(want[qi], got[qi], ext[qi]), \
                (mix, qi, [(r.chunk_id[:8], r.score) for r in want[qi]],
                 [(r.chunk_id[:8], r.score) for r in got[qi]])


@pytest.fixture(scope="module")
def corpus():
    return generate_corpus(n_docs=50, n_versions=3)


@pytest.fixture(scope="module", params=[4096, 256],
                ids=["memtable", "sealed-ivf"])
def lakes(request, corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"lakes{request.param}")
    repro = ReproLake(str(root / "repro"), dim=DIM,
                      hot_capacity=request.param)
    port = PortLake(str(root / "port"), dim=DIM,
                    hot_capacity=request.param, device="cpu")
    _ingest(repro, corpus)
    _ingest(port, corpus)
    return repro, port, request.param


def test_port_answers_like_repro(lakes, corpus):
    repro, port, cap = lakes
    if cap == 256:                # the stream seals and merges into IVF
        for lake in (repro, port):
            st = lake.hot.index.stats()
            assert st["partitioned_segments"] >= 1 and st["tombstones"] > 0
    _assert_equivalent(repro, port, QUERIES, _mixes(corpus.timestamps))


def test_batch_equals_sequential_bitwise(lakes, corpus):
    _, port, _ = lakes
    for mix in _mixes(corpus.timestamps):
        for n in (1, 3, 8):
            batch = port.query_batch(QUERIES[:n], k=K, **mix)
            assert batch == [port.query(q, k=K, **mix) for q in QUERIES[:n]]


def test_same_stream_writes_the_same_cold_tier(lakes):
    """The on-disk format is shared byte for byte: one ingest stream
    gives identical cold-tier segments and commit log entries."""
    repro, port, _ = lakes
    for sub in ("_log", "segments", "_ckpt"):
        a = os.path.join(repro.root, "cold", sub)
        b = os.path.join(port.root, "cold", sub)
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and names
        for name in names:
            with open(os.path.join(a, name), "rb") as fa, \
                    open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def small_corpus():
    return generate_corpus(n_docs=12, n_versions=3, seed=1)


def test_store_written_by_repro_reopens_in_port(tmp_path, small_corpus):
    root = str(tmp_path / "lake")
    repro = ReproLake(root, dim=DIM, hot_capacity=64)
    _ingest(repro, small_corpus)
    assert repro.hot.index.stats()["segments"] > 0
    port = PortLake(root, dim=DIM, hot_capacity=64, device="cpu")
    _assert_equivalent(repro, port, QUERIES, _mixes(small_corpus.timestamps))


def test_store_written_by_port_reopens_in_repro(tmp_path, small_corpus):
    root = str(tmp_path / "lake")
    port = PortLake(root, dim=DIM, hot_capacity=64, device="cpu")
    _ingest(port, small_corpus)
    assert port.hot.index.stats()["segments"] > 0
    repro = ReproLake(root, dim=DIM, hot_capacity=64)
    _assert_equivalent(repro, port, QUERIES, _mixes(small_corpus.timestamps))


def test_tenant_scoped_queries_match_repro(tmp_path, small_corpus):
    repro = ReproLake(str(tmp_path / "r"), dim=DIM, hot_capacity=64)
    port = PortLake(str(tmp_path / "p"), dim=DIM, hot_capacity=64,
                    device="cpu")
    _ingest(repro, small_corpus, tenants=True)
    _ingest(port, small_corpus, tenants=True)
    for vis in ("a", ["a", "b"], "nobody"):
        _assert_equivalent(repro, port, QUERIES[:4],
                           _mixes(small_corpus.timestamps), visibility=vis)
    for r in port.query_batch(QUERIES, k=K, visibility="a",
                              at=small_corpus.timestamps[1]):
        assert all(x.tenant == "a" for x in r)


V1 = """The quarterly revenue was 10 million dollars.

Security policy requires two factor authentication.

The incident response time target is four hours."""

V2 = """The quarterly revenue was 12 million dollars.

Security policy requires two factor authentication.

The incident response time target is four hours."""


def test_supersede_never_leaks_across_the_device_mirrors(tmp_path):
    """Leakage regression for the device copies: after the resident
    history and the fused scan block exist, superseding a chunk must
    close its valid_to on the device too, and the new vector must reach
    the fused block."""
    t1, t2 = 1_700_000_000_000_000, 1_700_000_000_500_000
    lake = PortLake(str(tmp_path / "lake"), dim=DIM, device="cpu")
    lake.ingest("doc", V1, ts=t1)
    q = "quarterly revenue million dollars"
    assert "10 million" in lake.query(q, k=1)[0].text   # builds both mirrors
    assert "10 million" in lake.query(q, k=1, at=t1)[0].text
    lake.ingest("doc", V2, ts=t2)
    assert "12 million" in lake.query(q, k=1)[0].text
    old = lake.query(q, k=3, at=t1)
    new = lake.query(q, k=3, at=t2)
    assert [r.text for r in old if "revenue" in r.text] == [V1.split("\n\n")[0]]
    assert [r.text for r in new if "revenue" in r.text] == [V2.split("\n\n")[0]]
    lake.temporal.assert_no_leakage(old, t1)
    lake.temporal.assert_no_leakage(new, t2)
    lake.temporal.assert_no_leakage(lake.query(q, k=3, at=t2 - 1), t2 - 1)
    both = lake.query(q, k=4, window=(t1, t2 + 1))
    assert {r.text for r in both if "revenue" in r.text} == \
        {V1.split("\n\n")[0], V2.split("\n\n")[0]}
    res = lake.temporal._resident_history()
    assert torch.equal(res.vt_dev[:res.n], torch.from_numpy(res.vt[:res.n]))
    assert torch.equal(res.vf_dev[:res.n], torch.from_numpy(res.vf[:res.n]))
    idx = lake.hot.index
    cap = idx.mem.capacity
    assert torch.equal(idx._cat.fused_emb[:cap], torch.from_numpy(idx.mem._emb))


def test_quantized_stores_are_refused_untouched(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PortLake(str(tmp_path / "new"), dim=DIM, quantized=True,
                 device="cpu")
    root = str(tmp_path / "q8")
    repro = ReproLake(root, dim=DIM, quantized=True)
    repro.ingest("doc", V1, ts=1_700_000_000_000_000)
    with open(os.path.join(root, "STORE.json")) as f:
        before = json.load(f)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PortLake(root, dim=DIM, device="cpu")
    with open(os.path.join(root, "STORE.json")) as f:
        assert json.load(f) == before
