"""Port parity for the recsys family's serving path: repro_torch's FM,
DLRM, Wide&Deep and BERT4Rec forwards, user embeddings,
``score_candidates`` and the cell bundles of ``launch/steps``, on the
CPU, against repro's on the same numpy inputs and the same weights
(repro's params carried across by ``models/bridge``). repro runs its
kernels in "ref" mode here (its CPU default).

Tolerance: rtol = atol = 1e-4 (XLA and torch sum the fp32 products of
the MLPs, the dot interaction and the bags in different orders); the
batches of ``make_smoke_args`` are equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_get_arch
from repro.launch import steps as repro_steps
from repro.models import recsys as rr
from repro.models import transformer as rtfm
from repro_torch.configs import all_cells, get_arch, list_archs
from repro_torch.configs import dlrm_mlperf
from repro_torch.launch import steps
from repro_torch.models import recsys as pr
from repro_torch.models.bridge import (recsys_params_from_repro,
                                       recsys_params_to_repro)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["bert4rec", "dlrm-mlperf", "fm", "wide-deep"]


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _dlrm(cfg_kw, seed=0):
    rcfg = rr.DLRMConfig(**cfg_kw)
    pcfg = pr.DLRMConfig(**cfg_kw)
    tree = _np_tree(rr.dlrm_init(jax.random.PRNGKey(seed), rcfg))
    return rcfg, pcfg, tree, recsys_params_from_repro(tree, "dlrm-mlperf",
                                                      pcfg, "cpu")


SMALL_DLRM = dict(table_sizes=(100,) * 26, bot_mlp=(13, 32, 16, 8),
                  top_mlp=(32, 16, 1), embed_dim=8)


# ---------------------------------------------------------------------------
# FM
# ---------------------------------------------------------------------------
def test_fm_sum_square_identity_and_parity():
    kw = dict(n_sparse=5, embed_dim=4, vocab_per_field=50)
    rcfg, pcfg = rr.FMConfig(**kw), pr.FMConfig(**kw)
    tree = _np_tree(rr.fm_init(jax.random.PRNGKey(0), rcfg))
    params = recsys_params_from_repro(tree, "fm", pcfg, "cpu")
    ids = np.random.default_rng(0).integers(0, rcfg.total_vocab,
                                            (7, 5)).astype(np.int32)
    got = pr.fm_forward(params, pcfg, _t(ids))
    # brute force: w0 + sum_i w_i + sum_{i<j} <v_i, v_j>
    w, v = tree["w"][ids], tree["v"][ids].astype(np.float64)
    pair = sum((v[:, i] * v[:, j]).sum(-1) for i in range(5)
               for j in range(i + 1, 5))
    np.testing.assert_allclose(got.numpy(), tree["w0"] + w.sum(-1) + pair,
                               **TOL)
    _close(got, rr.fm_forward(tree, rcfg, jnp.asarray(ids)))
    _close(pr.fm_user_embedding(params, pcfg, _t(ids)),
           rr.fm_user_embedding(tree, rcfg, jnp.asarray(ids)))


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------
def test_dlrm_one_hot_matches_repro():
    rcfg, pcfg, tree, params = _dlrm(SMALL_DLRM)
    rng = np.random.default_rng(1)
    dense = rng.random((6, 13)).astype(np.float32)
    sparse = rng.integers(0, 100, (6, 26, 1)).astype(np.int32)
    got = pr.dlrm_forward(params, pcfg, _t(dense), _t(sparse))
    assert got.shape == (6,)
    _close(got, rr.dlrm_forward(tree, rcfg, jnp.asarray(dense),
                                jnp.asarray(sparse)))


@pytest.mark.parametrize("weighted", [False, True])
def test_dlrm_multi_hot_ragged_matches_repro(weighted):
    rcfg, pcfg, tree, params = _dlrm(dict(SMALL_DLRM, multi_hot=4), seed=2)
    rng = np.random.default_rng(3)
    dense = rng.random((5, 13)).astype(np.float32)
    sparse = rng.integers(0, 100, (5, 26, 4)).astype(np.int32)
    lens = rng.integers(0, 5, (5, 26))               # ragged bags, some empty
    sparse = np.where(np.arange(4) < lens[..., None], sparse, -1)
    sparse[0, 3, 1] = -5                              # any negative id pads
    w = rng.random((5, 26, 4)).astype(np.float32) if weighted else None
    got = pr.dlrm_forward(params, pcfg, _t(dense), _t(sparse),
                          None if w is None else _t(w))
    _close(got, rr.dlrm_forward(tree, rcfg, jnp.asarray(dense),
                                jnp.asarray(sparse),
                                None if w is None else jnp.asarray(w)))


def test_dlrm_triu_order_is_row_major():
    iu, ju = torch.triu_indices(27, 27, offset=1)
    riu, rju = jnp.triu_indices(27, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(riu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(rju))
    assert pr.DLRMConfig().d_interact == 479


def test_dlrm_user_embedding_and_bag_injection():
    rcfg, pcfg, tree, params = _dlrm(SMALL_DLRM)
    rng = np.random.default_rng(4)
    dense = rng.random((4, 13)).astype(np.float32)
    sparse = rng.integers(0, 100, (4, 26, 1)).astype(np.int32)
    _close(pr.dlrm_user_embedding(params, pcfg, _t(dense), _t(sparse)),
           rr.dlrm_user_embedding(tree, rcfg, jnp.asarray(dense),
                                  jnp.asarray(sparse)))
    calls = []

    def bag(tables, ids, w, combiner, out=None):
        calls.append((len(tables), tuple(ids.shape)))
        return pr.embedding_bag_grouped(tables, ids, w, combiner, out=out)

    a = pr.dlrm_forward(params, pcfg, _t(dense), _t(sparse), bag=bag)
    assert calls == [(26, (4, 26, 1))]                # one grouped call
    assert torch.equal(a, pr.dlrm_forward(params, pcfg, _t(dense),
                                          _t(sparse)))


def test_dlrm_configs_match_repro():
    from repro.configs import dlrm_mlperf as rcfgmod
    full = dlrm_mlperf.CONFIG
    assert full.n_params() == rcfgmod.CONFIG.n_params()
    assert full.padded_table_sizes == rcfgmod.CONFIG.padded_table_sizes
    one = dlrm_mlperf.ONE_CARD
    assert max(one.table_sizes) == 25_000_000
    assert [i for i, (a, b) in enumerate(zip(one.table_sizes,
                                             full.table_sizes)) if a != b] \
        == [0, 9, 19, 21]
    assert sum(one.padded_table_sizes) == 113_808_384     # 58.3 GB fp32
    assert (one.embed_dim, one.bot_mlp, one.top_mlp, one.multi_hot) == \
        (full.embed_dim, full.bot_mlp, full.top_mlp, full.multi_hot)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("ids", [
    [[0, 3], [1, 2]],                    # in range
    [[-1, -4], [-2, 0]],                 # wrapped negatives
    [[4, 0], [7, 3]],                    # >= V
    [[-5, 1], [-9, -4]],                 # < -V
    [[0, 3, 4, -1, -5, -4]],
])
def test_lookup_out_of_range_raises_where_repro_fills_nan(dtype, ids):
    """``lookup`` equals repro's ``jnp.take``, NaN rows included: an id in
    [-V, -1] wraps, any other id outside [0, V) gives a NaN row."""
    table = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3),
                        dtype=dtype)
    ids = np.array(ids, np.int32)
    want = np.asarray(rr.lookup(table, jnp.asarray(ids)).astype(jnp.float32))
    tt = torch.from_numpy(np.array(table.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    got = pr.lookup(tt, _t(ids))
    assert got.dtype == tt.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the 1-d tables of FM's linear term and Wide&Deep's wide part
    want1 = np.asarray(rr.lookup(table[:, 0], jnp.asarray(ids)).astype(
        jnp.float32))
    np.testing.assert_array_equal(
        pr.lookup(tt[:, 0].contiguous(), _t(ids)).float().numpy(), want1)


OUT_OF_RANGE = np.array([[0, 1, 2, 3, 4], [-1, 7, 300, -300, 5]], np.int32)


def test_fm_forward_out_of_range_ids_match_repro():
    kw = dict(n_sparse=5, embed_dim=4, vocab_per_field=50)
    rcfg, pcfg = rr.FMConfig(**kw), pr.FMConfig(**kw)
    tree = _np_tree(rr.fm_init(jax.random.PRNGKey(1), rcfg))
    params = recsys_params_from_repro(tree, "fm", pcfg, "cpu")
    got = pr.fm_forward(params, pcfg, _t(OUT_OF_RANGE)).numpy()
    want = np.asarray(rr.fm_forward(tree, rcfg, jnp.asarray(OUT_OF_RANGE)))
    assert np.isfinite(want[0]) and np.isnan(want[1])
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_widedeep_forward_out_of_range_ids_match_repro():
    kw = dict(n_sparse=5, embed_dim=8, mlp=(32, 16), vocab_per_field=60)
    rcfg, pcfg = rr.WideDeepConfig(**kw), pr.WideDeepConfig(**kw)
    tree = _np_tree(rr.widedeep_init(jax.random.PRNGKey(2), rcfg))
    params = recsys_params_from_repro(tree, "wide-deep", pcfg, "cpu")
    got = pr.widedeep_forward(params, pcfg, _t(OUT_OF_RANGE)).numpy()
    want = np.asarray(rr.widedeep_forward(tree, rcfg,
                                          jnp.asarray(OUT_OF_RANGE)))
    assert np.isfinite(want[0]) and np.isnan(want[1])
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


# ---------------------------------------------------------------------------
# Wide & Deep, BERT4Rec
# ---------------------------------------------------------------------------
def test_widedeep_matches_repro():
    kw = dict(n_sparse=6, embed_dim=8, mlp=(32, 16), vocab_per_field=100)
    rcfg, pcfg = rr.WideDeepConfig(**kw), pr.WideDeepConfig(**kw)
    tree = _np_tree(rr.widedeep_init(jax.random.PRNGKey(0), rcfg))
    params = recsys_params_from_repro(tree, "wide-deep", pcfg, "cpu")
    ids = np.random.default_rng(5).integers(0, rcfg.total_vocab,
                                            (9, 6)).astype(np.int32)
    _close(pr.widedeep_forward(params, pcfg, _t(ids)),
           rr.widedeep_forward(tree, rcfg, jnp.asarray(ids)))
    _close(pr.widedeep_user_embedding(params, pcfg, _t(ids)),
           rr.widedeep_user_embedding(tree, rcfg, jnp.asarray(ids)))


def test_bert4rec_serve_logits_and_user_embedding():
    from repro_torch.models.bridge import params_from_repro
    rcfg = rr.bert4rec_config(n_items=200, name="bert4rec-reduced")
    pcfg = pr.bert4rec_config(n_items=200, name="bert4rec-reduced")
    assert (pcfg.vocab, pcfg.d_model, pcfg.n_layers, pcfg.d_head) == \
        (rcfg.vocab, rcfg.d_model, rcfg.n_layers, rcfg.d_head)
    tree = _np_tree(rtfm.init_params(jax.random.PRNGKey(0), rcfg))
    params = params_from_repro(tree, pcfg, "cpu")
    toks = np.random.default_rng(6).integers(4, rcfg.vocab,
                                             (3, 16)).astype(np.int32)
    hidden, _ = rtfm.forward(tree, jnp.asarray(toks), rcfg)
    want = rtfm.logits_fn(tree, hidden[:, -1:])[:, 0]
    got = pr.bert4rec_forward(params, pcfg, _t(toks))
    assert got.shape == (3, rcfg.vocab)
    _close(got, want)
    _close(pr.bert4rec_user_embedding(params, pcfg, _t(toks)),
           rr.bert4rec_user_embedding(tree, rcfg, jnp.asarray(toks)))


# ---------------------------------------------------------------------------
# retrieval scoring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k,n_blocks", [
    (300, 10, 512),        # n < n_blocks * k: repro's topk_search branch
    (300, 10, 1),          # n_blocks <= 1: the same branch
    (4096, 20, 16),        # repro's two-stage lax.top_k branch
    (1000, 7, 9),          # two-stage with a ragged last block
])
def test_score_candidates_matches_both_branches(n, k, n_blocks):
    rng = np.random.default_rng(n + k)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    c = rng.standard_normal((n, 32)).astype(np.float32)
    mask = rng.random(n) < 0.9
    s, i = pr.score_candidates(_t(q), _t(c), k=k, n_blocks=n_blocks,
                               mask=_t(mask))
    rs, ri = rr.score_candidates(jnp.asarray(q), jnp.asarray(c), k=k,
                                 n_blocks=n_blocks, mask=jnp.asarray(mask),
                                 mode="ref")
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert mask[i.numpy()].all()


# ---------------------------------------------------------------------------
# registry and cell bundles
# ---------------------------------------------------------------------------
def test_registry_matches_repro_recsys_cells():
    assert [a for a in list_archs() if get_arch(a).family == "recsys"] == \
        ARCHS
    for arch in ARCHS:
        ours, theirs = get_arch(arch), repro_get_arch(arch)
        assert ours.source == theirs.source
        assert ([(c.shape, c.kind) for c in ours.cells()]
                == [(c.shape, c.kind) for c in theirs.cells()])
        for cell in ours.cells():
            for reduced in (False, True):
                a = ours.input_specs(cell.shape, reduced)
                b = theirs.input_specs(cell.shape, reduced)
                assert list(a) == list(b)
                for name in a:
                    assert a[name].shape == tuple(b[name].shape)
                    assert str(a[name].dtype).removeprefix("torch.") == \
                        np.dtype(b[name].dtype).name
    assert len(RECSYS_CELLS) == 16


RECSYS_CELLS = [c for c in all_cells() if c.arch in ARCHS]
SERVE_CELLS = [c for c in RECSYS_CELLS if c.kind != "train"]


@pytest.mark.parametrize("cell", SERVE_CELLS, ids=lambda c: c.key)
def test_cell_bundle_matches_repro(cell):
    rb = repro_steps.build_cell(cell.arch, cell.shape, reduced=True)
    r_args = repro_steps.make_smoke_args(rb, seed=3)
    pb = steps.build_cell(cell.arch, cell.shape, reduced=True, device="cpu")
    assert (pb.arch, pb.shape, pb.kind) == (rb.arch, rb.shape, rb.kind)
    if cell.kind == "retrieval":
        p_args = steps.make_smoke_args(pb, seed=3)
        r_batch, p_batch = r_args[0], p_args[0]
    else:
        params = recsys_params_from_repro(_np_tree(r_args[0]), cell.arch,
                                          pb.model_cfg, "cpu")
        p_args = steps.make_smoke_args(pb, seed=3, params=params)
        assert p_args[0] is params
        r_batch, p_batch = r_args[1], p_args[1]
    assert list(p_batch) == list(r_batch)
    for name in r_batch:                               # the same batch
        np.testing.assert_array_equal(p_batch[name].numpy(),
                                      np.asarray(r_batch[name]))
    got = pb.fn(*p_args)
    want = rb.fn(*r_args)
    if cell.kind == "retrieval":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        assert bool(torch.isfinite(got).all())
        _close(got, want)


def test_build_cell_refuses_what_is_not_ported():
    """DLRM's train cell is ported (tests/test_torch_train_cells.py);
    SchNet is not."""
    assert steps.build_cell("dlrm-mlperf", "train_batch", reduced=True,
                            device="cpu").kind == "train"
    with pytest.raises(NotImplementedError, match="item 12"):
        steps.build_cell("schnet", "full_graph_sm", device="cpu")


def test_seeded_init_shapes():
    b = steps.build_cell("dlrm-mlperf", "serve_p99", reduced=True,
                         device="cpu")
    params, batch = steps.make_smoke_args(b, seed=0)
    sizes = [params["tables"][f"table_{i}"].shape[0] for i in range(26)]
    assert sizes == list(b.model_cfg.padded_table_sizes) == [256] * 26
    again, _ = steps.make_smoke_args(b, seed=0)
    assert all(torch.equal(p, q) for p, q in
               zip(params.parameters(), again.parameters()))
    out = b.fn(params, batch)
    assert out.shape == (8,) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch", ["fm", "dlrm-mlperf", "wide-deep"])
def test_bridge_round_trip(arch):
    rcfg = repro_get_arch(arch).model_config(True)
    pcfg = get_arch(arch).model_config(True)
    init = {"fm": rr.fm_init, "dlrm-mlperf": rr.dlrm_init,
            "wide-deep": rr.widedeep_init}[arch]
    tree = _np_tree(init(jax.random.PRNGKey(1), rcfg))
    back = recsys_params_to_repro(
        recsys_params_from_repro(tree, arch, pcfg, "cpu"), arch)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
