"""Port parity for the masked top-k search: repro_torch's topk_search on
CPU tensors (its plain PyTorch version) against repro's topk_search in
"ref" mode (the jnp oracle) and, where this JAX can run it, its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerances: scores within 1e-5 absolute (unit vectors; the two packages
sum the dot products in different orders); ids equal at every finite
slot whose reference score is more than 1e-5 from both neighbours; the
-inf slots the same, holding index -1 in the port."""
import numpy as np
import pytest
import torch

from repro.kernels.topk_search.ops import topk_search as repro_topk
from repro.kernels.topk_search.ref import topk_search_ref
from repro_torch.kernels import common
from repro_torch.kernels.topk_search import ops as kops
from repro_torch.kernels.topk_search.plain import topk_search_plain
from repro_torch.testing import topk_agree


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def assert_parity(got, ref):
    """Port result ``got`` against a repro result ``ref``; repro leaves
    the index at a -inf slot unspecified, the port makes it -1."""
    s_r, i_r = (np.asarray(x) for x in ref)
    i_r = np.where(np.isfinite(s_r), i_r, -1)
    ok, _, why = topk_agree(got[0], got[1], s_r, i_r, score_atol=1e-5,
                            gap=1e-5)
    assert ok, why


@pytest.fixture
def interpret():
    """Skip where repro's Pallas kernels cannot run in interpret mode
    (they call ``pl.store``, which newer JAX releases removed)."""
    from jax.experimental import pallas as pl
    if not hasattr(pl, "store"):
        pytest.skip("this JAX has no pallas.store: repro's Pallas kernels "
                    "cannot run in interpret mode")
    return "interpret"


def port_topk(q, c, mask, k):
    return kops.topk_search(torch.from_numpy(q), torch.from_numpy(c),
                            torch.from_numpy(mask), k)


# the shapes of tests/test_kernels_topk.py::test_topk_matches_ref
@pytest.mark.parametrize("nq,n,d,k,bn", [
    (1, 256, 128, 5, 128),
    (4, 1000, 384, 10, 256),     # n not a multiple of bn
    (8, 512, 64, 3, 512),
    (2, 130, 384, 7, 128),
    (3, 64, 256, 64, 128),       # k == n
])
def test_plain_matches_repro_ref(nq, n, d, k, bn):
    q, c = _rand((nq, d), 1), _rand((n, d), 2)
    mask = np.random.default_rng(3).random(n) > 0.3
    got = port_topk(q, c, mask, k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == (nq, min(k, n))
    assert_parity(got, repro_topk(q, c, mask, k, bn=bn, mode="ref"))
    assert_parity(got, topk_search_ref(q, c, mask, min(k, n)))


@pytest.mark.parametrize("nq,n,d,k,bn", [
    (1, 256, 128, 5, 128), (4, 1000, 384, 10, 256), (3, 64, 256, 64, 128),
])
def test_plain_matches_repro_interpret(interpret, nq, n, d, k, bn):
    q, c = _rand((nq, d), 1), _rand((n, d), 2)
    mask = np.random.default_rng(3).random(n) > 0.3
    assert_parity(port_topk(q, c, mask, k),
                  repro_topk(q, c, mask, k, bn=bn, mode=interpret))


def test_ties_go_to_the_lower_row():
    base = _rand((20, 32), 4)
    c = np.repeat(base, 3, axis=0)                # every row three times
    q = _rand((5, 32), 5)
    mask = np.ones(60, bool)
    s, i = port_topk(q, c, mask, 12)
    order = np.argsort(-(q @ c.T), axis=1, kind="stable")[:, :12]
    # a tie group's members are consecutive rows: the kernel must list
    # them in rising row order, exactly as a stable sort does
    exact = np.repeat(np.argsort(-(q @ base.T), axis=1,
                                 kind="stable")[:, :4], 3, axis=1) * 3
    exact += np.tile(np.arange(3), 4)[None, :]
    np.testing.assert_array_equal(np.asarray(i), exact)
    np.testing.assert_array_equal(np.asarray(i)[:, :12], order)
    np.testing.assert_allclose(np.asarray(s),
                               np.take_along_axis(q @ c.T, order, 1),
                               rtol=1e-5, atol=1e-5)


def test_all_masked_returns_neg_inf_and_minus_one():
    q, c = _rand((2, 64)), _rand((100, 64))
    s, i = port_topk(q, c, np.zeros(100, bool), 5)
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
    s_j, _ = repro_topk(q, c, np.zeros(100, bool), 5, mode="ref")
    assert np.all(np.isneginf(np.asarray(s_j)))


def test_k_equals_n_with_masked_rows():
    q, c = _rand((3, 16), 6), _rand((6, 16), 7)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    s, i = port_topk(q, c, mask, 6)
    assert_parity((s, i), topk_search_ref(q, c, mask, 6))
    assert torch.all(i[:, 4:] == -1) and torch.all(torch.isneginf(s[:, 4:]))
    assert set(i[0, :4].tolist()) == {0, 2, 3, 5}


def test_k_is_clipped_to_n_and_empty_corpus():
    q, c = _rand((2, 8), 8), _rand((3, 8), 9)
    s, i = port_topk(q, c, np.ones(3, bool), 10)
    assert s.shape == (2, 3)
    s, i = kops.topk_search(torch.from_numpy(q), torch.zeros((0, 8)),
                            torch.zeros(0, dtype=torch.bool), 5)
    assert s.shape == (2, 0) and i.shape == (2, 0)


def test_plain_scores_are_batch_invariant_bitwise():
    q, c = _rand((9, 384), 10), _rand((700, 384), 11)
    mask = np.random.default_rng(12).random(700) > 0.1
    full_s, full_i = port_topk(q, c, mask, 10)
    for lo, hi in [(0, 1), (2, 4), (3, 9)]:
        s, i = port_topk(np.ascontiguousarray(q[lo:hi]), c, mask, 10)
        assert torch.equal(s, full_s[lo:hi]) and torch.equal(i, full_i[lo:hi])


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    q, c = _rand((2, 8), 13), _rand((50, 8), 14)
    before = kops.launches
    port_topk(q, c, np.ones(50, bool), 5)
    assert kops.launches == before
    meta = torch.empty((50, 8), device="meta")
    with pytest.raises(ValueError):
        kops.topk_search(torch.empty((2, 8), device="meta"), meta,
                         torch.empty(50, dtype=torch.bool, device="meta"), 5)


def test_wrapper_checks_inputs():
    q, c = torch.from_numpy(_rand((2, 8), 15)), torch.from_numpy(
        _rand((50, 8), 16))
    m = torch.ones(50, dtype=torch.bool)
    with pytest.raises(TypeError):
        kops.topk_search(q.double(), c, m, 5)
    with pytest.raises(TypeError):
        kops.topk_search(q, c, m.int(), 5)
    with pytest.raises(ValueError):
        kops.topk_search(q, c.T, torch.ones(8, dtype=torch.bool), 5)
    with pytest.raises(ValueError):
        kops.topk_search(q, c, m[:40], 5)


def test_plain_is_the_cpu_path():
    q, c = _rand((3, 32), 17), _rand((90, 32), 18)
    mask = np.random.default_rng(19).random(90) > 0.5
    a = port_topk(q, c, mask, 7)
    b = topk_search_plain(torch.from_numpy(q), torch.from_numpy(c),
                          torch.from_numpy(mask), 7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("ref_cols,agree", [(3, False), (4, True)],
                         ids=["next-unseen", "next-given"])
def test_topk_agree_reads_the_next_reference_entry(ref_cols, agree):
    """Two rows 1e-7 apart swap at the last slot: a near-tie, forgiven
    only when the reference's next entry shows the neighbour; an early
    swap across a wide gap is never forgiven."""
    s = np.array([[0.5, 0.4, 0.3000001]], np.float32)
    ref_s = np.array([[0.5, 0.4, 0.3000001, 0.3]], np.float32)[:, :ref_cols]
    ref_i = np.array([[1, 2, 4, 3]])[:, :ref_cols]
    ok, err, why = topk_agree(s, np.array([[1, 2, 3]]), ref_s, ref_i)
    assert ok == agree and err == 0.0
    assert agree or "query 0 slot 2" in why
    ok, _, why = topk_agree(s, np.array([[2, 1, 4]]), ref_s, ref_i)
    assert not ok and "slot 0" in why


# k above the card's register list (128): the card takes its radix-select path
# there; the CPU path is the same plain version at every k
@pytest.mark.parametrize("nq,n,d,k", [
    (2, 1000, 384, 129), (3, 2000, 64, 500), (2, 700, 32, 700),
    (1, 5000, 32, 4096),
])
def test_large_k_matches_repro_ref(nq, n, d, k):
    q, c = _rand((nq, d), 20), _rand((n, d), 21)
    mask = np.random.default_rng(22).random(n) > 0.3
    got = port_topk(q, c, mask, k)
    assert got[0].shape == (nq, min(k, n))
    assert_parity(got, repro_topk(q, c, mask, k, mode="ref"))
    live = int(mask.sum())
    assert torch.all(got[1][:, live:] == -1)
    assert torch.all(torch.isfinite(got[0][:, :live]))


# ---------------------------------------------------------------------------
# the launch plan of the CUDA tile scans (pure Python, no card needed)
# ---------------------------------------------------------------------------
def _covers(plan, nq):
    assert [b for b, _ in plan] == list(np.cumsum([0] + [c for _, c in plan])
                                        [:-1])
    assert sum(c for _, c in plan) == nq and all(c >= 1 for _, c in plan)


@pytest.mark.parametrize("nq,per_query,budget,want", [
    (40, 10, 1000, [(0, 40)]),                   # all fit: one launch
    (100, 10, 35, [(b, min(3, 100 - b)) for b in range(0, 100, 3)]),
    (100, 1, 70, [(0, 64), (64, 36)]),           # whole 32-query tiles
    (5, 10 ** 9, 1 << 30, [(b, 1) for b in range(5)]),  # over budget: 1
    (0, 4, 8, []),
])
def test_query_chunks(nq, per_query, budget, want):
    plan = common.query_chunks(nq, per_query, budget)
    assert plan == want
    _covers(plan, nq)


def test_select_chunks_keep_the_key_buffer_within_budget():
    # k > 128: N x 4 bytes of keys a query; 1 GiB holds 256 queries of
    # 2^20 rows, in whole 32-query tiles
    n = 1 << 20
    assert common.scan_chunks(256, n, 500, 1) == [(0, 256)]
    plan = common.scan_chunks(1000, n, 500, 1)
    assert [c for _, c in plan] == [256, 256, 256, 232]
    _covers(plan, 1000)
    plan = common.scan_chunks(300, 3 << 20, 129, 1)     # 85 a launch -> 64
    assert all(c == 64 for _, c in plan[:-1]) and plan[-1][1] == 300 - 256
    # above 2^28 rows one query's keys alone exceed 1 GiB: one a launch
    plan = common.scan_chunks(3, (1 << 28) + 1, 200, 1)
    assert plan == [(0, 1), (1, 1), (2, 1)]
    # many short rows: the grid's limit, in whole tiles
    plan = common.scan_chunks(200_000, 64, 129, 1)
    assert max(c for _, c in plan) == common.SELECT_MAX_QUERIES
    assert common.SELECT_MAX_QUERIES % 32 == 0
    _covers(plan, 200_000)


def test_list_chunks_keep_the_candidates_within_budget():
    gx, k = 528, 128
    per = gx * k
    plan = common.scan_chunks(2000, 1 << 20, k, gx)
    assert all(c * per <= common.CAND_BUDGET for _, c in plan)
    assert all(c % 32 == 0 for _, c in plan[:-1])
    _covers(plan, 2000)
    assert common.scan_chunks(32, 8192, 10, 64) == [(0, 32)]
