"""Port parity for RAG serving: repro_torch's RAGEngine (CPU, the
attention kernels' plain versions) against repro's, each over its own
package's store fed the same ingest stream with explicit timestamps, and
with repro's generator params carried across by models/bridge.py. The
retrieved contexts and the prompts must be equal; the generated token
ids must be equal at every step up to the first one where repro's top-1
and top-2 logits are within 1e-3 (there, the packages' different sum
orders may pick either). Also: a port store whose embedder is the
transformer answers a batch bit for bit as its queries one by one, and
the serving CLI runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.store import LiveVectorLake as ReproLake
from repro.data.corpus import generate_corpus
from repro.models import transformer as rt
from repro.serve.engine import RAGEngine as ReproEngine
from repro_torch.core.store import LiveVectorLake as PortLake
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as pt
from repro_torch.models.bridge import params_from_repro
from repro_torch.models.embedder import MINILM_CONFIG, TransformerEmbedder
from repro_torch.serve.engine import GenerationResult, RAGEngine

GAP = 1e-3
GEN = dict(name="gen", vocab=30_522, d_model=128, n_layers=2, n_heads=4,
           n_kv=2, d_head=32, d_ff=256, act="swiglu")
QUERIES = ["security policy review for staff",
           "network capacity incident response",
           "metric alpha equals units revision",
           "billing archive audit records"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("rag")
    corpus = generate_corpus(n_docs=30, n_versions=3)
    repro_lake = ReproLake(str(root / "repro"), dim=64)
    port_lake = PortLake(str(root / "port"), dim=64, device="cpu")
    for lake in (repro_lake, port_lake):
        for v, ts in enumerate(corpus.timestamps):
            for doc in corpus.doc_ids():
                lake.ingest(doc, corpus.versions[v][doc], ts=ts)
    rcfg = rt.TransformerConfig(**GEN, remat=False)
    pcfg = pt.TransformerConfig(**GEN)
    rparams = rt.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_repro(jax.tree.map(np.asarray, rparams), pcfg,
                               "cpu")
    return (ReproEngine(repro_lake, rcfg, params=rparams, max_prompt=96),
            RAGEngine(port_lake, pcfg, params=params, max_prompt=96,
                      device="cpu"),
            corpus)


def repro_gaps(engine, prompt, n):
    """repro's greedy tokens for ``prompt`` and, per step, the gap
    between its top-1 and top-2 logits."""
    toks = jnp.asarray(engine.tokenizer.encode(prompt,
                                               max_len=engine.max_prompt))
    logits, cache, ln = engine._prefill(engine.params, toks[None, :])
    ids, gaps = [], []
    for _ in range(n):
        top2 = np.sort(np.asarray(logits[0], np.float64))[-2:]
        gaps.append(top2[1] - top2[0])
        cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        ids.append(int(cur[0, 0]))
        logits, cache, ln = engine._decode(engine.params, cur, cache["k"],
                                           cache["v"], ln)
    return ids, gaps


def assert_same_answer(want, got: GenerationResult, engine, n):
    assert [r.chunk_id for r in got.retrieved] == \
        [r.chunk_id for r in want.retrieved]
    assert [r.text for r in got.retrieved] == [r.text for r in want.retrieved]
    assert got.prompt == want.prompt
    assert got.n_context_chunks == want.n_context_chunks
    assert len(got.token_ids) == n
    ids, gaps = repro_gaps(engine, want.prompt, n)
    assert ids == want.token_ids
    for step, gap in enumerate(gaps):
        if gap <= GAP:
            break
        assert got.token_ids[step] == ids[step], (step, gap)


@pytest.mark.parametrize("when", ["current", "v0", "v1"])
def test_answer_matches_repro(engines, when):
    repro, port, corpus = engines
    at = None if when == "current" else corpus.timestamps[int(when[1])] + 1
    for q in QUERIES[:2]:
        want = repro.answer(q, k=3, at=at, max_new_tokens=6)
        got = port.answer(q, k=3, at=at, max_new_tokens=6)
        assert got.at == at and got.query == q
        assert all(0 <= t < GEN["vocab"] for t in got.token_ids)
        assert_same_answer(want, got, repro, 6)


def test_answer_batch_matches_repro_and_answer(engines):
    repro, port, corpus = engines
    at = corpus.timestamps[1] + 1
    want = repro.answer_batch(QUERIES, at=at, max_new_tokens=4)
    got = port.answer_batch(QUERIES, at=at, max_new_tokens=4)
    for w, g in zip(want, got):
        assert_same_answer(w, g, repro, 4)
    for q, g in zip(QUERIES, got):                 # batch == one by one
        one = port.answer(q, k=3, at=at, max_new_tokens=4)
        assert one.retrieved == g.retrieved and one.token_ids == g.token_ids
    got5 = port.answer_batch(QUERIES[:2], k=5, max_new_tokens=2)
    assert all(r.n_context_chunks == 5 for r in got5)


def test_store_with_transformer_embedder_batch_is_sequential(tmp_path):
    cfg = dataclasses.replace(MINILM_CONFIG, n_layers=2, vocab=2048)
    emb = TransformerEmbedder(cfg, max_len=32, device="cpu")
    lake = PortLake(str(tmp_path / "lake"), embedder=emb, dim=384,
                    device="cpu")
    corpus = generate_corpus(n_docs=12, n_versions=3)
    for v, ts in enumerate(corpus.timestamps):
        for doc in corpus.doc_ids():
            lake.ingest(doc, corpus.versions[v][doc], ts=ts)
    texts = QUERIES + [f"{f.name} equals units" for f in corpus.facts[:6]]
    ts = corpus.timestamps
    for kw in ({}, {"at": ts[1] + 1}, {"window": (ts[0], ts[2])}):
        for k in (3, 10):
            got = lake.query_batch(texts, k=k, **kw)
            assert got == [lake.query(t, k=k, **kw) for t in texts]
            assert all(len(r) == k for r in got)
    assert np.array_equal(emb.embed(texts[:3]),
                          emb.embed(texts)[:3])


def test_serve_cli_runs_on_cpu(tmp_path, capsys):
    root = str(tmp_path / "lake")
    lake = PortLake(root, dim=384, device="cpu")
    corpus = generate_corpus(n_docs=8, n_versions=2)
    for v, ts in enumerate(corpus.timestamps):
        for doc in corpus.doc_ids():
            lake.ingest(doc, corpus.versions[v][doc], ts=ts)
    del lake
    port_serve.main(["--root", root, "--queries", QUERIES[0], QUERIES[1],
                     "--max-new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated token ids: [") == 2
    assert "ctx[0]" in out and "batcher stats" in out
