"""Port parity for EmbeddingBag: repro_torch's embedding_bag on CPU
tensors (its plain PyTorch version) against repro's ``embedding_bag_ref``
and repro's wrapper in "ref" mode and, where this JAX can run it, its
Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances: rtol = atol = 1e-5 in fp32 (the two packages sum the bag in
different orders: the port in slot order, XLA as an einsum), 5e-2 for a
bf16 table (repro's own kernel tests' tolerance: both round once to
bf16). NaN rows (an id >= V) must sit at the same bags."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as repro_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels.embedding_bag.plain import embedding_bag_plain


def _setup(v, d, b, bag, seed=0, pad_frac=0.3, dtype=np.float32):
    """The inputs of tests/test_kernels_embedding_bag.py."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(dtype)
    idx = rng.integers(0, v, (b, bag)).astype(np.int32)
    idx = np.where(rng.random((b, bag)) < pad_frac, -1, idx)
    w = rng.random((b, bag)).astype(np.float32)
    return table, idx, w


def port_bag(table, idx, w, combiner="sum", dtype=torch.float32):
    return eb.embedding_bag(torch.from_numpy(table).to(dtype),
                            torch.from_numpy(idx),
                            None if w is None else torch.from_numpy(w),
                            combiner)


def ref_bag(table, idx, w, combiner="sum", dtype=jnp.float32):
    return np.asarray(embedding_bag_ref(
        jnp.asarray(table, dtype), jnp.asarray(idx),
        None if w is None else jnp.asarray(w), combiner), np.float32)


@pytest.fixture
def interpret():
    """Skip where repro's Pallas kernels cannot run in interpret mode
    (the embedding-bag body calls ``pl.load``, which newer JAX releases
    removed)."""
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        pytest.skip("this JAX has no pallas.load: repro's embedding_bag "
                    "kernel cannot run in interpret mode")
    return "interpret"


# repro's four shapes (tests/test_kernels_embedding_bag.py) and L = 1
SHAPES = [
    (1000, 64, 8, 16, "sum"),
    (5000, 128, 4, 8, "mean"),
    (128, 32, 16, 4, "sum"),
    (10000, 16, 2, 32, "mean"),
    (25_000, 128, 512, 1, "sum"),          # DLRM one-hot at D = 128
    (300, 10, 64, 1, "mean"),
]


@pytest.mark.parametrize("v,d,b,bag,combiner", SHAPES)
def test_embedding_bag_matches_ref(v, d, b, bag, combiner):
    table, idx, w = _setup(v, d, b, bag)
    got = port_bag(table, idx, w, combiner)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_allclose(got.numpy(), ref_bag(table, idx, w, combiner),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,d,b,bag,combiner", SHAPES)
def test_embedding_bag_matches_repro_ref_mode(v, d, b, bag, combiner):
    table, idx, w = _setup(v, d, b, bag, seed=1)
    want = np.asarray(repro_bag(jnp.asarray(table), idx, w, combiner,
                                mode="ref"))
    np.testing.assert_allclose(port_bag(table, idx, w, combiner).numpy(),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,d,b,bag,combiner", SHAPES[:4])
def test_embedding_bag_matches_interpret(interpret, v, d, b, bag, combiner):
    table, idx, w = _setup(v, d, b, bag)
    want = np.asarray(repro_bag(jnp.asarray(table), idx, w, combiner,
                                mode=interpret))
    np.testing.assert_allclose(port_bag(table, idx, w, combiner).numpy(),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_all_padding_row(combiner):
    table, idx, w = _setup(100, 16, 4, 8)
    idx[2] = -1
    got = port_bag(table, idx, w, combiner).numpy()
    assert np.all(got[2] == 0.0)
    np.testing.assert_allclose(got, ref_bag(table, idx, w, combiner),
                               rtol=1e-5, atol=1e-5)


def test_default_weights():
    table, idx, _ = _setup(100, 16, 4, 8)
    a = port_bag(table, idx, None).numpy()
    b = port_bag(table, idx, np.ones(idx.shape, np.float32)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, ref_bag(table, idx, None), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bf16_table(combiner):
    table, idx, w = _setup(500, 64, 4, 8)
    got = port_bag(table, idx, w, combiner, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = ref_bag(table, idx, w, combiner, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_every_negative_id_is_padding():
    table, idx, w = _setup(200, 32, 16, 6)
    idx[idx < 0] = -7
    idx[0, :3] = np.iinfo(np.int32).min
    idx[1] = [-2, -1, -100, 5, -3, 7]
    for combiner in ("sum", "mean"):
        got = port_bag(table, idx, w, combiner).numpy()
        np.testing.assert_allclose(got, ref_bag(table, idx, w, combiner),
                                   rtol=1e-5, atol=1e-5)
        pads_as_minus_one = np.where(idx < 0, -1, idx).astype(np.int32)
        np.testing.assert_array_equal(
            got, port_bag(table, pads_as_minus_one, w, combiner).numpy())


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_id_out_of_range_gives_nan_row(combiner):
    v = 50
    table, idx, w = _setup(v, 8, 6, 4)
    idx[1, 2] = v                  # just past the table
    idx[3, 0] = v + 1000
    idx[4] = -1
    idx[4, 1] = v                  # out of range among pads
    got = port_bag(table, idx, w, combiner).numpy()
    want = ref_bag(table, idx, w, combiner)
    nan_rows = np.isnan(want).any(1)
    assert sorted(np.flatnonzero(nan_rows)) == [1, 3, 4]
    assert np.isnan(got[nan_rows]).all()
    assert not np.isnan(got[~nan_rows]).any()
    np.testing.assert_allclose(got[~nan_rows], want[~nan_rows], rtol=1e-5,
                               atol=1e-5)


def test_indices_cast_to_int32_and_sums_in_slot_order():
    table, idx, w = _setup(300, 16, 8, 5)
    a = port_bag(table, idx.astype(np.int64), w).numpy()
    b = port_bag(table, idx, w).numpy()
    np.testing.assert_array_equal(a, b)
    # slot order j = 0..L-1 in fp32, one rounding a term: L = 1 is exact
    t = torch.from_numpy(table)
    one = embedding_bag_plain(t, torch.from_numpy(idx[:, :1]),
                              torch.from_numpy(w[:, :1]))
    rows = t[torch.from_numpy(idx[:, 0]).clamp_min(0).long()]
    want = torch.where(torch.from_numpy(idx[:, :1]) >= 0,
                       torch.from_numpy(w[:, :1]) * rows, 0.0)
    assert torch.equal(one, want)


def test_wrapper_rejects_bad_input():
    table = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="combiner"):
        eb.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32),
                         combiner="max")
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        eb.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32),
                         torch.ones((2, 2)))
    with pytest.raises(TypeError, match="2-d"):
        eb.embedding_bag(torch.zeros((10, 4), dtype=torch.float16),
                         torch.zeros((2, 3), dtype=torch.int32))
    before = eb.launches
    eb.embedding_bag(table, np.zeros((2, 3), np.int32))
    assert eb.launches == before           # the CPU path launches nothing


@pytest.mark.parametrize("weighted", [False, True])
def test_field_of_a_multi_field_id_tensor(weighted):
    """DLRM's call: field i of (B, F, L) ids (and weights), a strided
    row view, gives repro's bag of that field."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((400, 32)).astype(np.float32)
    ids = rng.integers(-1, 400, (12, 5, 3)).astype(np.int32)
    w = rng.random((12, 5, 3)).astype(np.float32) if weighted else None
    t, tids = torch.from_numpy(table), torch.from_numpy(ids)
    tw = None if w is None else torch.from_numpy(w)
    for i in (0, 2, 4):
        got = eb.embedding_bag(t, tids[:, i], None if w is None else tw[:, i])
        want = ref_bag(table, np.ascontiguousarray(ids[:, i]),
                       None if w is None else np.ascontiguousarray(w[:, i]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        eb.embedding_bag(t, tids[:, 0, 0])


def test_row_stride_passes_row_views_and_copies_the_rest():
    ids = torch.arange(4 * 26 * 3, dtype=torch.int32).view(4, 26, 3)
    x, ld = eb._row_stride(ids[:, 7])
    assert x.data_ptr() == ids[:, 7].data_ptr() and ld == 78
    one = torch.zeros((4, 26, 1), dtype=torch.int32)
    x, ld = eb._row_stride(one[:, 3])
    assert x.data_ptr() == one[:, 3].data_ptr() and ld == 26
    t = ids[:, :, 0].t()                   # (26, 4), slots 78 apart
    x, ld = eb._row_stride(t)
    assert x.is_contiguous() and ld == 4 and torch.equal(x, t)
    x, ld = eb._row_stride(ids[:1, 2])     # one bag: its own width
    assert ld == 3


# ---------------------------------------------------------------------------
# the grouped call: F tables in one call (DLRM's 26 fields)
# ---------------------------------------------------------------------------
GROUP_V = (400, 3, 57, 1000)            # one table of 3 rows


def _group_setup(bag, weighted, seed, d=16, dtype=np.float32):
    """F tables of different V, ids (B, F, L) over each field's own table
    with 30% padding (-1 and -7), bag 0 of field 0 all padding, one bag
    holding the id V of its table (a NaN row); ids and weights as strided
    views of larger arrays (as they lie in a batch)."""
    rng = np.random.default_rng(seed)
    b, f = 9, len(GROUP_V)
    tables = [rng.standard_normal((v, d)).astype(dtype) for v in GROUP_V]
    ids = np.stack([rng.integers(0, v, (b, bag)) for v in GROUP_V], 1)
    u = rng.random((b, f, bag))
    ids = np.where(u < 0.15, -1, np.where(u < 0.3, -7, ids)).astype(np.int32)
    ids[0, 0] = -1
    ids[3, 1, bag // 2] = GROUP_V[1]
    big = np.zeros((b, f + 2, bag), np.int32)
    big[:, 1:f + 1] = ids
    w = rng.random((b, f, bag)).astype(np.float32) if weighted else None
    big_w = None
    if weighted:
        big_w = np.zeros((b, f + 1, bag), np.float32)
        big_w[:, 1:] = w
    return tables, ids, w, big, big_w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bag", [1, 3, 100])
def test_grouped_matches_repro_per_field(bag, weighted, combiner, dtype):
    tables, ids, w, big, big_w = _group_setup(bag, weighted, seed=bag)
    tdt = getattr(torch, dtype)
    tt = [torch.from_numpy(t).to(tdt) for t in tables]
    f, d = len(tables), tables[0].shape[1]
    tids = torch.from_numpy(big)[:, 1:f + 1]              # strided view
    assert not tids.is_contiguous()
    tw = None if big_w is None else torch.from_numpy(big_w)[:, 1:]
    feats = torch.full((ids.shape[0], f + 1, d), 5.0, dtype=tdt)
    before = eb.launches
    got = eb.embedding_bag_grouped(tt, tids, tw, combiner,
                                   out=feats[:, 1:])
    assert eb.launches == before                    # the CPU path
    assert got.data_ptr() == feats[:, 1:].data_ptr()
    assert bool((feats[:, 0] == 5.0).all())         # field 0 untouched
    tol = 1e-5 if dtype == "float32" else 5e-2
    for i, table in enumerate(tables):
        want = np.asarray(repro_bag(
            jnp.asarray(table, getattr(jnp, dtype)), ids[:, i],
            None if w is None else w[:, i], combiner, mode="ref"),
            np.float32)
        g = got[:, i].float().numpy()
        nan = np.isnan(want).any(1)
        np.testing.assert_array_equal(np.isnan(g).any(1), nan)
        assert np.isnan(g[nan]).all()
        np.testing.assert_allclose(g[~nan], want[~nan], rtol=tol, atol=tol)
    assert np.isnan(got[3, 1].float().numpy()).all()
    assert bool((got[0, 0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bag", [1, 5])
def test_grouped_cpu_equals_single_calls_bitwise(bag, dtype):
    tables, ids, w, big, big_w = _group_setup(bag, True, seed=11)
    tt = [torch.from_numpy(t).to(dtype) for t in tables]
    tids, tw = torch.from_numpy(ids), torch.from_numpy(w)
    for combiner in ("sum", "mean"):
        got = eb.embedding_bag_grouped(tt, tids, tw, combiner)
        assert got.shape == (ids.shape[0], len(tables), 16)
        assert got.dtype == dtype
        for i, t in enumerate(tt):
            one = eb.embedding_bag(t, tids[:, i], tw[:, i], combiner)
            assert torch.equal(got[:, i].nan_to_num(), one.nan_to_num())
            assert torch.equal(got[:, i].isnan(), one.isnan())
    plain = eb.embedding_bag_grouped_plain(tt, tids, None)
    assert torch.equal(plain.nan_to_num(), eb.embedding_bag_grouped(
        tt, tids).nan_to_num())


@pytest.mark.parametrize("what", ["dtype", "width", "device", "too_many",
                                  "none", "indices", "out", "combiner"])
def test_grouped_wrapper_rejects_bad_input(what):
    tables = [torch.zeros((10, 4)), torch.zeros((7, 4))]
    ids = torch.zeros((2, 2, 3), dtype=torch.int32)
    kw = {}
    err = ValueError
    if what == "dtype":
        tables[1] = tables[1].to(torch.bfloat16)
        err = TypeError
    elif what == "width":
        tables[1] = torch.zeros((7, 5))
        err = TypeError
    elif what == "device":
        tables[1] = torch.zeros((7, 4), device="meta")
    elif what == "too_many":
        tables = [torch.zeros((10, 4))] * (eb.MAX_TABLES + 1)
        ids = torch.zeros((2, eb.MAX_TABLES + 1, 3), dtype=torch.int32)
    elif what == "none":
        tables = []
    elif what == "indices":
        ids = torch.zeros((2, 3, 3), dtype=torch.int32)    # F != 2
    elif what == "out":
        kw["out"] = torch.zeros((2, 2, 5))
    else:
        kw["combiner"] = "max"
    match = {"device": "meta", "too_many": "65 tables", "none": "no tables",
             "indices": r"\(B, 2, L\)", "out": "out", "combiner": "combiner",
             "dtype": "one dtype", "width": "one width"}[what]
    with pytest.raises(err, match=match):
        eb.embedding_bag_grouped(tables, ids, **kw)
    # the most a group may hold is accepted
    eb.embedding_bag_grouped([torch.zeros((10, 4))] * eb.MAX_TABLES,
                             torch.zeros((2, eb.MAX_TABLES, 1),
                                         dtype=torch.int32))


# ---------------------------------------------------------------------------
# backward: the table gradient (the CPU path of embedding_bag_grouped_bwd
# and of the bags' autograd) against jax.grad of repro's "ref" mode
# ---------------------------------------------------------------------------
def _jax_table_grad(table, idx, w, combiner, g):
    import jax
    fn = lambda t: repro_bag(t, jnp.asarray(idx),              # noqa: E731
                             None if w is None else jnp.asarray(w),
                             combiner, mode="ref")
    _, vjp = jax.vjp(fn, jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("v,d,b,bag,combiner,weighted", [
    (1000, 64, 8, 16, "sum", True),
    (5000, 128, 4, 8, "mean", True),
    (128, 32, 16, 4, "sum", False),
    (64, 16, 32, 3, "mean", False),
])
def test_bag_backward_matches_jax_grad(v, d, b, bag, combiner, weighted):
    """The table gradient through torch.autograd of ``embedding_bag``
    (padding, weights, mean, and an id >= V in one bag, which adds to no
    row) against jax.vjp of repro's wrapper in "ref" mode, within 1e-5;
    and the weights' gradient against jax's at every slot, the NaN bag's
    included (a nonzero cotangent there): NaN at the same slots (``sum``:
    the out-of-range one; ``mean``: every slot but padding), within 1e-5
    elsewhere."""
    table, idx, w = _setup(v, d, b, bag, seed=5)
    idx[0, 0] = v + 3                                  # out of range
    w = w if weighted else None
    g = np.random.default_rng(6).standard_normal((b, d)).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = None if w is None else torch.from_numpy(w).requires_grad_(True)
    out = eb.embedding_bag(tt, torch.from_numpy(idx), tw, combiner)
    out.backward(torch.from_numpy(g))
    want = _jax_table_grad(table, idx, w, combiner, g)
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    untouched = np.ones(v, bool)
    untouched[idx[(idx >= 0) & (idx < v)]] = False
    assert float(tt.grad[torch.from_numpy(untouched)].abs().sum()) == 0.0
    if w is not None:
        import jax
        fn = lambda ww: repro_bag(jnp.asarray(table),           # noqa: E731
                                  jnp.asarray(idx), ww, combiner,
                                  mode="ref")
        _, vjp = jax.vjp(fn, jnp.asarray(w))
        want_w = np.asarray(vjp(jnp.asarray(g))[0])
        got_w = tw.grad.numpy()
        nan = np.isnan(want_w)
        assert nan[0, 0] and not nan[1:].any()
        if combiner == "sum":
            assert nan[0].sum() == 1
        else:
            assert (nan[0] == (idx[0] >= 0)).all()
        np.testing.assert_array_equal(np.isnan(got_w), nan)
        np.testing.assert_allclose(got_w[~nan], want_w[~nan], rtol=1e-5,
                                   atol=1e-5)


def test_grouped_backward_into_a_stack_slice():
    """DLRM's call: the grouped bags written into ``feats[:, 1:]`` of a
    stack whose field 0 is another input. autograd gives each table its
    field's gradient (jax.vjp of repro's bags, per field) and the other
    input its own slice's."""
    rng = np.random.default_rng(8)
    sizes, d, b, bag = (50, 7, 200, 3), 16, 64, 2
    tabs = [rng.standard_normal((n, d)).astype(np.float32) for n in sizes]
    idx = np.stack([rng.integers(-1, n, (b, bag)) for n in sizes],
                   1).astype(np.int32)
    g = rng.standard_normal((b, len(sizes) + 1, d)).astype(np.float32)
    tt = [torch.from_numpy(t).requires_grad_(True) for t in tabs]
    x0 = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)
                          ).requires_grad_(True)
    feats = x0.new_empty((b, len(sizes) + 1, d))
    feats[:, 0] = x0
    eb.embedding_bag_grouped(tt, torch.from_numpy(idx), None, "sum",
                             out=feats[:, 1:])
    feats.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(x0.grad.numpy(), g[:, 0])
    for f, t in enumerate(tt):
        want = _jax_table_grad(tabs[f], idx[:, f], None, "sum", g[:, f + 1])
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_bag_segments_cut_hot_rows_into_chunks():
    """A hot row's slots are cut into chunks in slot order; the backward
    over chunks of 4 equals the one over chunks of 256 within rounding,
    and both equal jax's within 1e-5. Rows no slot reaches stay 0."""
    from repro_torch.kernels.embedding_bag.plain import (
        bag_segments, embedding_bag_backward_plain)
    rng = np.random.default_rng(9)
    b, bag, d, v = 300, 1, 8, 10
    idx = rng.integers(0, 3, (b, 1, bag)).astype(np.int32)  # 3 hot rows
    idx[::7] = -1
    g = rng.standard_normal((b, 1, d)).astype(np.float32)
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    seg = bag_segments((v,), ti, None, "sum", chunk=4)
    counts = seg["count"].tolist()
    assert max(counts) == 4 and len(seg["multi_key"]) == 3
    assert seg["slot"].tolist() == sorted(
        seg["slot"].tolist(), key=lambda s: (idx.reshape(-1)[s], s))
    got = embedding_bag_backward_plain((v,), torch.float32, ti, None, "sum",
                                       tg, seg)
    ref = embedding_bag_backward_plain((v,), torch.float32, ti, None, "sum",
                                       tg)
    want = _jax_table_grad(np.zeros((v, d), np.float32), idx[:, 0], None,
                           "sum", g[:, 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got[3:].abs().sum()) == 0.0


def test_bag_backward_bf16_rounds_once():
    """A bf16 table: the gradient is the fp32 sums of the bf16 cotangent,
    rounded once to bf16."""
    table, idx, w = _setup(300, 32, 16, 4, seed=10)
    g = torch.randn(16, 1, 32, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    ti = torch.from_numpy(idx)[:, None]
    tw = torch.from_numpy(w)[:, None]
    got = eb.embedding_bag_grouped_bwd((300,), torch.bfloat16, ti, tw, "mean",
                                       g)
    want = eb.embedding_bag_grouped_bwd((300,), torch.float32, ti, tw, "mean",
                                        g.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
