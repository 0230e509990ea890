"""The port's CUDA kernels against their plain PyTorch versions, on the
card (built from src/repro_torch/csrc with nvcc at first use). Every
test here needs a CUDA device and skips without one; this file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: scores within 1e-4 absolute (the kernel sums each dot
product in one fixed fmaf order, the plain version through cuBLAS), ids
equal wherever the reference scores are more than 1e-5 apart, the empty
(-inf, -1) slots identical. The int8 kernels are held to their plain
versions the same way, at both list depths (k <= 64 and 64 < k <= 128)
and on the radix-select path (k > 128). The attention kernels, against their
plain versions on the same inputs: max abs error <= 1e-4 in fp32 and
<= 2e-2 in bf16, and each output within 1e-4 (fp32: different sum
orders over D and the key columns) or 2**-7 (bf16: one rounding step of
8 significant bits) of its own value, plus 1e-4 of its row's largest.
The decode kernel's fp32 split partials are held to the plain partials
at 1e-4 before their merge, and its in-library merge to repro's merge of
the same partials (fp32: 1e-5 of each value plus 1e-5 of its row's
largest, the two sum the splits in other orders; bf16: one rounding
step). The embedding-bag kernel, against its plain
version: bit for bit where a bag has one slot (one product, rounded
once either way), else each component within 1e-5 of the sum of
|w * row| over the bag (fmaf against a product then an add: at most one
rounding a term apart); a bf16 table within one rounding step of
bf16 (2**-7 of the value plus 1e-4 of the row's largest); NaN rows (an
id >= V) at exactly the same bags.

The backward kernels, against their plain versions on the same inputs:
the forward kernel's row logsumexp within 1e-5 of max(1, |lse|) of the
plain forward's, -inf at the same rows (``testing.lse_agree``); then
flash_attention_bwd's dq, dk, dv against the plain backward's on the
kernel's o and lse, in fp32 within 1e-4 of each tensor's largest
|value|, in bf16 within one rounding step of each value plus 1e-4 of its
row's largest, floored at 1e-2 of the tensor's (``testing.grads_agree``:
both sum in fp32 and round once; a row whose exact gradient is 0 holds
only rounding noise); against the plain backward on the plain forward's
o and lse by the same rule plus, in bf16, ``o_rounding_bound`` (the two
forwards' bf16 outputs may round apart); rows that see no key get 0,
never NaN; torch.autograd through the kernels on the card against
torch.autograd through the plain forward on the CPU, bf16 at D 128, by
the rule with the bound. The bag's
backward sums in the plain version's order (slots sorted stably by row,
chunks of 256, one rounded product and one rounded add a slot): its
table gradient equals the plain one bit for bit, fp32 and bf16. Two runs
of either backward are bit for bit equal.

gather_segment_sum (SchNet's message passing) sums the plain version's
terms in its order (edges sorted stably by row, chunks of 256, one
rounded product and one rounded add an edge): its forward and the
gradient of x equal the plain ones bit for bit, NaN rows (an
out-of-range src) at the same places, and two runs too; the reduced
SchNet cells' loss and gradients repeat bit for bit on the card and stay
within 1e-4 of each leaf's largest of the CPU's."""
import numpy as np
import pytest
import torch

from repro_torch.core.types import VALID_TO_OPEN
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.plain import embedding_bag_plain
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.plain import flash_attention_plain
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.plain import (
    flash_decode_partials_plain, flash_decode_plain, merge_partials)
from repro_torch.index.quant import fixed_scale, quantize_rows
from repro_torch.kernels.temporal_mask_score import ops as tops
from repro_torch.kernels.temporal_mask_score.plain import (
    temporal_window_topk_plain, temporal_window_topk_q8_plain)
from repro_torch.kernels.topk_search import ops as kops
from repro_torch.kernels.topk_search.plain import (topk_search_plain,
                                                   topk_search_q8_plain)
from repro_torch.kernels import common
from repro_torch.testing import partials_agree, rounding_agree, topk_agree

pytestmark = pytest.mark.cuda

T0 = 1_700_000_000_000_000          # epoch microseconds, above 2**32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _agree(got, want):
    """``want``: the plain version at k + 1 (or all N rows), its last
    entry read only as the neighbour of the k-th slot (topk_agree)."""
    ok, err, why = topk_agree(got[0], got[1], want[0], want[1])
    assert ok, why
    return err


@pytest.mark.parametrize("nq,n,d,k", [
    (1, 256, 128, 5), (4, 1000, 384, 10), (8, 512, 64, 3),
    (2, 130, 384, 7), (3, 64, 256, 64), (33, 5000, 384, 10),
    (256, 8191, 384, 64), (2, 8192, 384, 5), (5, 300, 100, 17),
    (4, 3000, 384, 100), (33, 1000, 64, 128),      # the deeper list
])
def test_topk_kernel_matches_plain(dev, nq, n, d, k):
    q = torch.tensor(_rand((nq, d), 1), device=dev)
    c = torch.tensor(_rand((n, d), 2), device=dev)
    mask = torch.tensor(np.random.default_rng(3).random(n) > 0.3,
                        device=dev)
    before = kops.launches
    got = kops.topk_search(q, c, mask, k)
    assert kops.launches == before + 1
    _agree(got, topk_search_plain(q, c, mask, k + 1))


def test_topk_kernel_ties_lower_row_first(dev):
    base = _rand((40, 64), 4)
    c = torch.tensor(np.repeat(base, 5, axis=0), device=dev)   # 5 copies
    q = torch.tensor(_rand((6, 64), 5), device=dev)
    mask = torch.ones(200, dtype=torch.bool, device=dev)
    s, i = kops.topk_search(q, c, mask, 20)
    ps, pi = topk_search_plain(q, c, mask, 20)
    assert torch.equal(i, pi)              # ties: lower row id first
    assert torch.allclose(s, ps, atol=1e-4, rtol=0)


def test_topk_kernel_all_masked_and_k_equals_n(dev):
    q = torch.tensor(_rand((3, 32), 6), device=dev)
    c = torch.tensor(_rand((100, 32), 7), device=dev)
    s, i = kops.topk_search(q, c, torch.zeros(100, dtype=torch.bool,
                                              device=dev), 5)
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
    small = c[:5].contiguous()
    m = torch.tensor([True, False, True, True, False], device=dev)
    got = kops.topk_search(q, small, m, 5)
    _agree(got, topk_search_plain(q, small, m, 5))
    assert torch.all(got[1][:, 3:] == -1)


def test_topk_kernel_rejects_bad_input(dev):
    q = torch.tensor(_rand((2, 16), 8), device=dev)
    c = torch.tensor(_rand((200, 16), 9), device=dev)
    m = torch.ones(200, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        kops.topk_search(q.double(), c, m, 5)
    with pytest.raises(ValueError):
        kops.topk_search(q, c.T, m, 5)              # not contiguous
    with pytest.raises(ValueError):
        kops.topk_search(q.cpu(), c, m, 5)          # mixed devices


@pytest.mark.parametrize("which", ["topk", "temporal"])
def test_kernel_batch_invariant_bitwise(dev, which):
    d, n = 384, 3000
    q = torch.tensor(_rand((70, d), 10), device=dev)
    c = torch.tensor(_rand((n, d), 11), device=dev)
    rng = np.random.default_rng(12)
    if which == "topk":
        m = torch.tensor(rng.random(n) > 0.2, device=dev)
        run = lambda qq: kops.topk_search(qq, c, m, 10)
    else:
        vf = torch.tensor(T0 + rng.integers(0, 100, n), device=dev)
        vt = vf + torch.tensor(rng.integers(1, 100, n), device=dev)
        run = lambda qq: tops.temporal_window_topk(qq, c, vf, vt, T0 + 50,
                                                   T0 + 51, 10)
    full_s, full_i = run(q)
    for lo, hi in [(0, 1), (3, 5), (5, 38), (40, 70)]:
        s, i = run(q[lo:hi].contiguous())
        assert torch.equal(s, full_s[lo:hi]) and torch.equal(i, full_i[lo:hi])


@pytest.mark.parametrize("nq,n,d,k", [
    (2, 1000, 384, 10), (37, 4096, 384, 64), (1, 130, 64, 7),
    (256, 20000, 384, 10), (5, 3000, 384, 128),
])
def test_temporal_kernel_matches_plain(dev, nq, n, d, k):
    rng = np.random.default_rng(13)
    q = torch.tensor(_rand((nq, d), 14), device=dev)
    c = torch.tensor(_rand((n, d), 15), device=dev)
    vf = T0 + rng.integers(0, 1000, n)
    vt = np.where(rng.random(n) < 0.3, VALID_TO_OPEN,
                  vf + rng.integers(1, 500, n))
    vf = np.where(rng.random(n) < 0.1, VALID_TO_OPEN, vf)   # invisible
    t0 = T0 + rng.integers(0, 1000, nq)
    t1 = t0 + np.where(rng.random(nq) < 0.5, 1, rng.integers(1, 300, nq))
    vf_t, vt_t = torch.tensor(vf, device=dev), torch.tensor(vt, device=dev)
    before = tops.launches
    got = tops.temporal_window_topk(q, c, vf_t, vt_t, t0, t1, k)
    assert tops.launches == before + 1
    want = temporal_window_topk_plain(q, c, vf_t, vt_t,
                                      torch.tensor(t0, device=dev),
                                      torch.tensor(t1, device=dev), k + 1)
    _agree(got, want)
    s, i = (x.cpu().numpy() for x in got)
    for qi in range(nq):                      # no out-of-window id
        rows = i[qi][np.isfinite(s[qi])]
        assert np.all((vf[rows] < t1[qi]) & (t0[qi] < vt[rows]))


def test_temporal_kernel_boundary_instants(dev):
    c = torch.tensor(_rand((4, 32), 16), device=dev)
    q = torch.tensor(_rand((3, 32), 17), device=dev)
    vf = torch.tensor([T0, T0 + 10, T0 + 10, VALID_TO_OPEN], device=dev)
    vt = torch.tensor([T0 + 10, VALID_TO_OPEN, T0 + 11, VALID_TO_OPEN],
                      device=dev)
    for ts, live in [(T0 - 1, []), (T0, [0]), (T0 + 9, [0]),
                     (T0 + 10, [1, 2]), (T0 + 11, [1])]:
        s, i = tops.temporal_topk(q, c, vf, vt, ts, 4)
        for qi in range(3):
            got = sorted(int(x) for x in i[qi] if x >= 0)
            assert got == live, (ts, got)


# ---------------------------------------------------------------------------
# int8 (quantized) kernels
# ---------------------------------------------------------------------------
def _q8(n, d, seed):
    """(N, D) int8 rows of unit vectors under the fixed 1/127 scale, as
    the quantized store keeps them, with the scale."""
    scale = fixed_scale(d)
    return quantize_rows(_rand((n, d), seed), scale), scale


@pytest.mark.parametrize("nq,n,d,k", [
    (2, 8192, 384, 40), (32, 8192, 384, 128), (256, 8191, 384, 40),
    (1, 130, 64, 7), (5, 300, 100, 65), (3, 64, 256, 64), (7, 999, 36, 100),
])
def test_topk_q8_kernel_matches_plain(dev, nq, n, d, k):
    c8, scale = _q8(n, d, 20)
    c8 = torch.tensor(c8, device=dev)
    sc = torch.tensor(scale, device=dev)
    q = torch.tensor(_rand((nq, d), 21), device=dev)
    mask = torch.tensor(np.random.default_rng(22).random(n) > 0.3,
                        device=dev)
    before, before_f32 = kops.launches_q8, kops.launches
    got = kops.topk_search_q8(q, c8, scale, mask, k)
    assert kops.launches_q8 == before + 1 and kops.launches == before_f32
    _agree(got, topk_search_q8_plain(q, c8, sc, mask, k + 1))


@pytest.mark.parametrize("nq,n,d,k", [
    (2, 4096, 384, 40), (32, 20000, 384, 128), (256, 5000, 384, 40),
    (3, 130, 64, 70), (1, 777, 100, 9),
])
def test_temporal_q8_kernel_matches_plain(dev, nq, n, d, k):
    rng = np.random.default_rng(23)
    c8, scale = _q8(n, d, 24)
    c8 = torch.tensor(c8, device=dev)
    q = torch.tensor(_rand((nq, d), 25), device=dev)
    vf = T0 + rng.integers(0, 1000, n)
    vt = np.where(rng.random(n) < 0.3, VALID_TO_OPEN,
                  vf + rng.integers(1, 500, n))
    vf = np.where(rng.random(n) < 0.1, VALID_TO_OPEN, vf)   # invisible
    t0 = T0 + rng.integers(0, 1000, nq)
    t1 = t0 + np.where(rng.random(nq) < 0.5, 1, rng.integers(1, 300, nq))
    vf_t, vt_t = torch.tensor(vf, device=dev), torch.tensor(vt, device=dev)
    before, before_f32 = tops.launches_q8, tops.launches
    got = tops.temporal_window_topk_q8(q, c8, scale, vf_t, vt_t, t0, t1, k)
    assert tops.launches_q8 == before + 1 and tops.launches == before_f32
    _agree(got, temporal_window_topk_q8_plain(
        q, c8, torch.tensor(scale, device=dev), vf_t, vt_t,
        torch.tensor(t0, device=dev), torch.tensor(t1, device=dev),
        k + 1))
    s, i = (x.cpu().numpy() for x in got)
    for qi in range(nq):                      # no out-of-window id
        rows = i[qi][np.isfinite(s[qi])]
        assert np.all((vf[rows] < t1[qi]) & (t0[qi] < vt[rows]))


def test_q8_kernels_ties_lower_row_first(dev):
    c8, scale = _q8(40, 64, 26)
    c8 = torch.tensor(np.repeat(c8, 4, axis=0), device=dev)  # 4 copies
    q = torch.tensor(_rand((6, 64), 27), device=dev)
    mask = torch.ones(160, dtype=torch.bool, device=dev)
    sc = torch.tensor(scale, device=dev)
    for k in (20, 100):
        s, i = kops.topk_search_q8(q, c8, scale, mask, k)
        ps, pi = topk_search_q8_plain(q, c8, sc, mask, k)
        assert torch.equal(i, pi)          # ties: lower row id first
        assert torch.allclose(s, ps, atol=1e-4, rtol=0)
        vf = torch.full((160,), T0, device=dev)
        vt = torch.full((160,), VALID_TO_OPEN, device=dev)
        s, i = tops.temporal_window_topk_q8(q, c8, scale, vf, vt, T0,
                                            T0 + 1, k)
        assert torch.equal(i, pi)


@pytest.mark.parametrize("which", ["topk", "temporal"])
@pytest.mark.parametrize("k", [40, 128])
def test_q8_kernel_batch_invariant_bitwise(dev, which, k):
    d, n = 384, 3000
    q = torch.tensor(_rand((70, d), 28), device=dev)
    c8, scale = _q8(n, d, 29)
    c8 = torch.tensor(c8, device=dev)
    rng = np.random.default_rng(30)
    if which == "topk":
        m = torch.tensor(rng.random(n) > 0.2, device=dev)
        run = lambda qq: kops.topk_search_q8(qq, c8, scale, m, k)
    else:
        vf = torch.tensor(T0 + rng.integers(0, 100, n), device=dev)
        vt = vf + torch.tensor(rng.integers(1, 100, n), device=dev)
        run = lambda qq: tops.temporal_window_topk_q8(
            qq, c8, scale, vf, vt, T0 + 50, T0 + 51, k)
    full_s, full_i = run(q)
    for lo, hi in [(0, 1), (3, 5), (5, 38), (40, 70)]:
        s, i = run(q[lo:hi].contiguous())
        assert torch.equal(s, full_s[lo:hi]) and torch.equal(i, full_i[lo:hi])


def test_q8_kernels_all_masked_and_k_equals_n(dev):
    c8, scale = _q8(100, 32, 31)
    c8 = torch.tensor(c8, device=dev)
    q = torch.tensor(_rand((3, 32), 32), device=dev)
    s, i = kops.topk_search_q8(q, c8, scale, torch.zeros(
        100, dtype=torch.bool, device=dev), 40)
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
    vf = torch.full((100,), VALID_TO_OPEN, device=dev)      # all invisible
    s, i = tops.temporal_window_topk_q8(q, c8, scale, vf, vf, T0, T0 + 1, 40)
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
    small = c8[:5].contiguous()
    m = torch.tensor([True, False, True, True, False], device=dev)
    got = kops.topk_search_q8(q, small, scale, m, 5)
    _agree(got, topk_search_q8_plain(q, small, torch.tensor(scale,
                                                            device=dev),
                                     m, 5))
    assert torch.all(got[1][:, 3:] == -1)


def test_q8_kernels_reject_bad_input(dev):
    c8, scale = _q8(200, 16, 33)
    c8 = torch.tensor(c8, device=dev)
    q = torch.tensor(_rand((2, 16), 34), device=dev)
    m = torch.ones(200, dtype=torch.bool, device=dev)
    vf = torch.full((200,), T0, device=dev)
    with pytest.raises(TypeError):
        kops.topk_search_q8(q, c8.float(), scale, m, 5)     # not int8
    with pytest.raises(TypeError):
        tops.temporal_window_topk_q8(q, c8.float(), scale, vf, vf + 1, T0,
                                     T0 + 1, 5)
    with pytest.raises(ValueError):
        kops.topk_search_q8(q, c8, scale[:8], m, 5)         # scale width
    with pytest.raises(ValueError):
        kops.topk_search_q8(q, c8.T, scale, m, 5)           # not contiguous
    with pytest.raises(ValueError):
        kops.topk_search_q8(q.cpu(), c8, scale, m, 5)       # mixed devices


# ---------------------------------------------------------------------------
# k above the register list: the radix-select path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nq,n,k", [
    (2, 8192, 129), (33, 3000, 500), (3, 1000, 1000), (1, 20000, 4096),
    (256, 5000, 200), (5, 700, 513),
    (2, 12000, 9000),        # k > 8192: ordered by torch.sort of k slots
])
def test_large_k_kernels_match_plain(dev, nq, n, k):
    d = 384
    rng = np.random.default_rng(50)
    q = torch.tensor(_rand((nq, d), 51), device=dev)
    c = torch.tensor(_rand((n, d), 52), device=dev)
    mask = torch.tensor(rng.random(n) > 0.3, device=dev)
    before = kops.launches
    got = kops.topk_search(q, c, mask, k)
    assert kops.launches > before
    _agree(got, topk_search_plain(q, c, mask, min(k + 1, n)))
    live = int(mask.sum())
    assert torch.all(got[1][:, live:] == -1)
    c8, scale = _q8(n, d, 53)
    c8 = torch.tensor(c8, device=dev)
    sc = torch.tensor(scale, device=dev)
    _agree(kops.topk_search_q8(q, c8, scale, mask, k),
           topk_search_q8_plain(q, c8, sc, mask, min(k + 1, n)))
    vf = T0 + rng.integers(0, 1000, n)
    vt = np.where(rng.random(n) < 0.3, VALID_TO_OPEN,
                  vf + rng.integers(1, 500, n))
    t0 = T0 + rng.integers(0, 1000, nq)
    t1 = t0 + rng.integers(1, 300, nq)
    vf_t, vt_t = torch.tensor(vf, device=dev), torch.tensor(vt, device=dev)
    t0_t, t1_t = torch.tensor(t0, device=dev), torch.tensor(t1, device=dev)
    for q8 in (False, True):
        if q8:
            got = tops.temporal_window_topk_q8(q, c8, scale, vf_t, vt_t, t0,
                                               t1, k)
            want = temporal_window_topk_q8_plain(q, c8, sc, vf_t, vt_t, t0_t,
                                                 t1_t, min(k + 1, n))
        else:
            got = tops.temporal_window_topk(q, c, vf_t, vt_t, t0, t1, k)
            want = temporal_window_topk_plain(q, c, vf_t, vt_t, t0_t, t1_t,
                                              min(k + 1, n))
        _agree(got, want)
        s, i = (x.cpu().numpy() for x in got)
        for qi in range(nq):
            rows = i[qi][np.isfinite(s[qi])]
            assert np.all((vf[rows] < t1[qi]) & (t0[qi] < vt[rows]))


def test_large_k_ties_and_batch_invariance(dev):
    base = _rand((100, 64), 54)
    c = torch.tensor(np.repeat(base, 5, axis=0), device=dev)   # 5 copies
    q = torch.tensor(_rand((40, 64), 55), device=dev)
    mask = torch.ones(500, dtype=torch.bool, device=dev)
    s, i = kops.topk_search(q, c, mask, 300)
    ps, pi = topk_search_plain(q, c, mask, 300)
    assert torch.equal(i, pi)              # ties: lower row id first
    assert torch.allclose(s, ps, atol=1e-4, rtol=0)
    for lo, hi in [(0, 1), (3, 5), (5, 38)]:
        s2, i2 = kops.topk_search(q[lo:hi].contiguous(), c, mask, 300)
        assert torch.equal(s2, s[lo:hi]) and torch.equal(i2, i[lo:hi])


@pytest.mark.parametrize("budget_queries", [1, 5, 31])
def test_large_k_query_chunks_within_budget(dev, monkeypatch,
                                            budget_queries):
    """Where fewer than 32 queries' key buffers (N x 4 bytes each) fit
    the budget, each launch takes no more queries than fit, and the
    answers are those of one launch."""
    nq, n, d, k = 40, 3000, 64, 300
    q = torch.tensor(_rand((nq, d), 56), device=dev)
    c = torch.tensor(_rand((n, d), 57), device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    whole = kops.topk_search(q, c, mask, k)
    monkeypatch.setattr(common, "KEY_BUDGET", budget_queries * n * 4)
    before = kops.launches
    s, i = kops.topk_search(q, c, mask, k)
    assert kops.launches - before == -(-nq // budget_queries)
    assert torch.equal(s, whole[0]) and torch.equal(i, whole[1])


def _four_scans(dev, nq, n, d, seed, mask_p=0.3):
    """The four scans on the same seeded inputs: name -> call(k)."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(_rand((nq, d), seed + 1), device=dev)
    c = torch.tensor(_rand((n, d), seed + 2), device=dev)
    c8, scale = _q8(n, d, seed + 2)
    c8 = torch.tensor(c8, device=dev)
    mask = torch.tensor(rng.random(n) > mask_p, device=dev)
    vf = torch.tensor(T0 + rng.integers(0, 1000, n), device=dev)
    vt = vf + torch.tensor(rng.integers(1, 800, n), device=dev)
    t0 = torch.tensor(T0 + rng.integers(0, 1000, nq), device=dev)
    t1 = t0 + 400
    return {
        "topk_search": lambda qq, k: kops.topk_search(qq, c, mask, k),
        "topk_search_q8": lambda qq, k: kops.topk_search_q8(qq, c8, scale,
                                                            mask, k),
        "temporal_window_topk": lambda qq, k, a=None: tops.
        temporal_window_topk(qq, c, vf, vt, t0 if a is None else t0[a],
                             t1 if a is None else t1[a], k),
        "temporal_window_topk_q8": lambda qq, k, a=None: tops.
        temporal_window_topk_q8(qq, c8, scale, vf, vt,
                                t0 if a is None else t0[a],
                                t1 if a is None else t1[a], k),
    }, q


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name", ["topk_search", "topk_search_q8",
                                  "temporal_window_topk",
                                  "temporal_window_topk_q8"])
def test_select_path_head_is_the_list_path_bitwise(dev, name):
    """The select path's first 128 entries at k = 500 are the list path's
    answer at k = 128, scores and ids bit for bit."""
    scans, q = _four_scans(dev, 40, 9000, 384, 60)
    s5, i5 = scans[name](q, 500)
    s1, i1 = scans[name](q, 128)
    assert torch.equal(_bits(s5[:, :128]), _bits(s1))
    assert torch.equal(i5[:, :128], i1)


@pytest.mark.parametrize("name", ["topk_search", "topk_search_q8",
                                  "temporal_window_topk",
                                  "temporal_window_topk_q8"])
def test_select_path_alone_equals_batch_across_chunks(dev, monkeypatch,
                                                      name):
    """k = 500: each query alone, and the batch split into chunks of 3
    queries, equal the batch in one launch, bit for bit."""
    nq, n = 40, 6000
    scans, q = _four_scans(dev, nq, n, 384, 61)
    whole = scans[name](q, 500)
    temporal = name.startswith("temporal")
    for a in (0, 17, 39):
        one = (scans[name](q[a:a + 1], 500, slice(a, a + 1)) if temporal
               else scans[name](q[a:a + 1], 500))
        assert torch.equal(_bits(one[0][0]), _bits(whole[0][a]))
        assert torch.equal(one[1][0], whole[1][a])
    monkeypatch.setattr(common, "KEY_BUDGET", 3 * n * 4)
    mod = tops if temporal else kops
    attr = "launches_q8" if name.endswith("_q8") else "launches"
    before = getattr(mod, attr)
    s, i = scans[name](q, 500)
    assert getattr(mod, attr) - before == -(-nq // 3)
    assert torch.equal(_bits(s), _bits(whole[0])) and torch.equal(i,
                                                                  whole[1])


@pytest.mark.parametrize("k", [100, 131, 500, 1003, 4500])
def test_ties_straddling_row_blocks_go_to_the_lower_row(dev, k):
    """Nine copies of each of 1000 rows, 1000 rows apart, so that every
    group of equal scores spans several 4096-row blocks of the select
    path; where the k-th slot splits a group, the lower rows win."""
    base = _rand((1000, 64), 62)
    c = torch.tensor(np.tile(base, (9, 1)), device=dev)
    q = torch.tensor(_rand((5, 64), 63), device=dev)
    mask = torch.ones(9000, dtype=torch.bool, device=dev)
    mask[4000:4003] = False
    s, i = kops.topk_search(q, c, mask, k)
    ps, pi = topk_search_plain(q, c, mask, k)
    assert torch.equal(i, pi)
    assert torch.allclose(s, ps, atol=1e-4, rtol=0)
    c8, scale = _q8(1000, 64, 62)
    c8 = torch.tensor(np.tile(c8, (9, 1)), device=dev)
    s, i = kops.topk_search_q8(q, c8, scale, mask, k)
    ps, pi = topk_search_q8_plain(q, c8, torch.tensor(scale, device=dev),
                                  mask, k)
    assert torch.equal(i, pi)


def test_select_path_k_equals_n_and_fewer_valid_rows(dev):
    """k = N, k = valid rows + 1 and every row masked: the valid rows in
    order, then (-inf, -1)."""
    n, d = 700, 384
    q = torch.tensor(_rand((3, d), 64), device=dev)
    c = torch.tensor(_rand((n, d), 65), device=dev)
    mask = torch.tensor(np.random.default_rng(66).random(n) > 0.5,
                        device=dev)
    live = int(mask.sum())
    for k in (n, live + 1, 129):
        s, i = kops.topk_search(q, c, mask, k)
        _agree((s, i), topk_search_plain(q, c, mask, min(k + 1, n)))
        assert torch.all(i[:, live:] == -1)
        assert torch.all(torch.isneginf(s[:, live:]))
        assert torch.all(i[:, :min(k, live)] >= 0)
    for k in (129, n):
        s, i = kops.topk_search(q, c, torch.zeros_like(mask), k)
        assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
        c8, scale = _q8(n, d, 65)
        s, i = tops.temporal_window_topk_q8(
            q, torch.tensor(c8, device=dev), scale,
            torch.full((n,), T0, device=dev),
            torch.full((n,), T0 + 5, device=dev), T0 + 5, T0 + 9, k)
        assert torch.all(torch.isneginf(s)) and torch.all(i == -1)


@pytest.mark.parametrize("k", [10, 300])
def test_zero_scores_of_either_sign_tie_by_row(dev, k):
    """Rows orthogonal to the query score exactly 0 (the kernels sum from
    +0, so never -0), queries holding -0.0 score as those holding +0.0,
    and the zeros tie by row id on both paths."""
    d, n = 64, 1000
    rng = np.random.default_rng(67)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c[::2, :32] = 0.0                     # even rows: 0 against the query
    c[::4, 32:] = -c[::4, 32:]
    q = np.zeros((2, d), np.float32)
    q[:, 32:] = 0.0
    q[1, 32:] = -0.0
    q[:, :32] = -np.abs(rng.standard_normal(32)).astype(np.float32)
    c[1::2, :32] = np.abs(c[1::2, :32])   # odd rows: negative scores
    ct = torch.tensor(c, device=dev)
    qt = torch.tensor(q, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    s, i = kops.topk_search(qt, ct, mask, k)
    ps, pi = topk_search_plain(qt, ct, mask, k)
    assert torch.equal(i, pi)
    assert torch.equal(i[0], i[1]) and torch.equal(s[0], s[1])
    zeros = min(k, n // 2)
    assert torch.all(s[:, :zeros] == 0)
    assert torch.equal(i[0, :zeros].cpu(), torch.arange(0, 2 * zeros, 2,
                                                        dtype=torch.int32))


@pytest.mark.parametrize("n,d", [(5001, 37), (5001, 100), (4099, 3)])
@pytest.mark.parametrize("k", [40, 500])
def test_q8_ragged_n_and_unaligned_d(dev, n, d, k):
    """int8 rows whose D is not a multiple of 16 (no 16-byte copies)
    or of 4, with N past a whole tile, on both paths."""
    rng = np.random.default_rng(68)
    q = torch.tensor(_rand((7, d), 69), device=dev)
    c8, scale = _q8(n, d, 70)
    c8 = torch.tensor(c8, device=dev)
    sc = torch.tensor(scale, device=dev)
    mask = torch.tensor(rng.random(n) > 0.2, device=dev)
    _agree(kops.topk_search_q8(q, c8, scale, mask, k),
           topk_search_q8_plain(q, c8, sc, mask, k + 1))
    vf = torch.tensor(T0 + rng.integers(0, 100, n), device=dev)
    vt = vf + torch.tensor(rng.integers(1, 100, n), device=dev)
    t0 = torch.tensor(T0 + rng.integers(0, 100, 7), device=dev)
    _agree(tops.temporal_window_topk_q8(q, c8, scale, vf, vt, t0, t0 + 50,
                                        k),
           temporal_window_topk_q8_plain(q, c8, sc, vf, vt, t0, t0 + 50,
                                         k + 1))


def test_lookup_out_of_range_ids_give_nan_rows_on_the_card(dev):
    """FM's and Wide&Deep's ``lookup`` on the card: wrapped negatives,
    NaN rows for ids outside [-V, V), no device assert, and the CPU's
    answer."""
    from repro_torch.models.recsys import lookup

    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, 3, 4, -1], [-5, -4, 9, 2]], dtype=torch.int32)
    for t in (table, table.to(torch.bfloat16)):
        got = lookup(t.to(dev), ids.to(dev))
        torch.cuda.synchronize()
        want = lookup(t, ids)
        assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
        assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())
        assert int(torch.isnan(got).any(-1).sum()) == 3


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------
def _randn(shape, seed, dev, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.tensor(x, device=dev).to(dtype)


def _attention_agree(got, want, dtype):
    tol, rel = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2 ** -7)
    assert float((got.float() - want.float()).abs().max()) <= tol
    ok, ratio = rounding_agree(got, want, rel)
    assert ok, f"an output is {ratio:.3g} x its limit from plain"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal", [
    (4, 12, 12, 128, 128, 32, False), (1, 32, 8, 256, 256, 128, True),
    (2, 8, 2, 100, 300, 64, True), (1, 4, 1, 77, 77, 32, False),
    (1, 2, 2, 64, 40, 128, True),          # rows that see no key: 0
    (16, 2, 2, 200, 200, 32, False),       # BERT4Rec: both tiles ragged
    # bf16 runs these on the tensor cores: ragged Sq / Skv (not multiples
    # of 64), Sq > Skv, D 64 and 128, GQA groups 1 and 4
    (2, 8, 2, 200, 333, 128, True), (1, 4, 4, 200, 333, 64, True),
    (1, 8, 2, 333, 200, 128, True), (2, 4, 4, 300, 100, 64, True),
    (1, 8, 2, 130, 390, 128, False), (3, 4, 4, 65, 129, 64, False),
])
def test_flash_attention_kernel_matches_plain(dev, dtype, b, h, kv, sq, skv,
                                              d, causal):
    q = _randn((b, h, sq, d), 60, dev, dtype)
    k = _randn((b, kv, skv, d), 61, dev, dtype)
    v = _randn((b, kv, skv, d), 62, dev, dtype)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1 and got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal)
    _attention_agree(got, want, dtype)
    if sq > skv and causal:
        assert torch.all(got[:, :, :sq - skv] == 0)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,cache_len,bs", [
    (1, 32, 8, 320, 128, 257, 512), (2, 8, 2, 1088, 64, 1000, 512),
    (3, 4, 4, 700, 32, 1, 256), (1, 32, 8, 4096, 128, 4096, 512),
    (2, 16, 2, 300, 128, 0, 128),          # empty prefix: 0
    # bs=None: the splits chosen for the card, B > 1
    (3, 32, 8, 320, 128, 0, None), (3, 32, 8, 320, 128, 1, None),
    (2, 8, 2, 300, 64, 17, None), (2, 32, 8, 4096, 128, 4096, None),
    (4, 4, 4, 700, 32, 271, None), (2, 16, 2, 1000, 128, 999, None),
])
def test_flash_decode_kernel_matches_plain(dev, dtype, b, h, kv, s, d,
                                           cache_len, bs):
    q = _randn((b, h, d), 63, dev, dtype)
    kc = _randn((b, kv, s, d), 64, dev, dtype)
    vc = _randn((b, kv, s, d), 65, dev, dtype)
    before = fd_ops.launches
    got = fd_ops.flash_decode(q, kc, vc, cache_len=cache_len, bs=bs)
    torch.cuda.synchronize()
    assert fd_ops.launches == before + 1 and got.dtype == dtype
    want = flash_decode_plain(q, kc, vc, cache_len, bs or 512)
    _attention_agree(got, want, dtype)
    # the partials kernel at the split the call used
    split = bs or fd_ops.choose_split(kv, cache_len, _sms(dev))
    got_p = fd_ops.flash_decode_partials(q, kc, vc, cache_len, split)
    ok, _, why = partials_agree(
        got_p, flash_decode_partials_plain(q, kc, vc, cache_len, split))
    assert ok, why
    # the in-library merge against repro's merge of those partials
    merged = merge_partials(*got_p)
    if dtype == torch.float32:
        ok, ratio = rounding_agree(got, merged, 1e-5, 1e-5)
    else:
        ok, ratio = rounding_agree(got, merged.to(dtype), 2 ** -7)
    assert ok, f"merge: {ratio:.3g} x its limit"
    if cache_len == 0:
        assert torch.all(got == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len", [1, 271, 4000])
def test_flash_decode_batch_invariant_bitwise(dev, monkeypatch, dtype,
                                              cache_len):
    """A request's output is the same bits alone and inside a batch of 4
    (the chosen splits do not depend on B), and each ``flash_decode``
    call is one library call (partials and merge kernels inside it)."""
    q = _randn((4, 32, 128), 70, dev, dtype)
    kc = _randn((4, 8, 4096, 128), 71, dev, dtype)
    vc = _randn((4, 8, 4096, 128), 72, dev, dtype)
    lib, fn = fd_ops._entry()
    calls = []

    def counted(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(fd_ops, "_fwd", (lib, counted))
    before = fd_ops.launches
    batch = fd_ops.flash_decode(q, kc, vc, cache_len=cache_len)
    alone = [fd_ops.flash_decode(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                 cache_len=cache_len) for i in range(4)]
    torch.cuda.synchronize()
    assert len(calls) == 5 and fd_ops.launches == before + 5
    for i in range(4):
        assert torch.equal(alone[i][0], batch[i])


def test_attention_kernels_reject_bad_input(dev):
    q = _randn((1, 4, 16, 48), 66, dev, torch.float32)        # D = 48
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        fd_ops.flash_decode(q[:, :, 0].contiguous(), q, q)
    q = _randn((1, 4, 16, 32), 67, dev, torch.float32)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), q.half(), q.half())


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------
def _bag_inputs(v, d, b, bag, seed, dev, dtype=torch.float32, pad=0.3):
    """Ids over the whole table (V - 1 among them), ``pad`` of the slots
    padding (-1 and -7), bag 0 all padding, bag 1 holding the id V."""
    rng = np.random.default_rng(seed)
    table = torch.empty((v, d), dtype=dtype, device=dev).normal_(
        generator=torch.Generator(device=dev).manual_seed(seed))
    idx = rng.integers(0, v, (b, bag))
    idx[-1, -1] = v - 1
    slots = rng.random((b, bag))
    idx = np.where(slots < pad / 2, -1, np.where(slots < pad, -7, idx))
    idx[0] = -1
    if b > 2:
        idx[1, bag // 2] = v
    w = rng.random((b, bag)).astype(np.float32)
    return (table, torch.tensor(idx, dtype=torch.int32, device=dev),
            torch.tensor(w, device=dev))


def _bag_agree(got, want, table, idx, w, combiner):
    nan = torch.isnan(want).any(1)
    assert torch.equal(torch.isnan(got).any(1), nan)
    assert bool(torch.isnan(got[nan]).all())
    g, t = got[~nan].float(), want[~nan].float()
    if idx.shape[1] == 1 and table.dtype == torch.float32:
        assert torch.equal(g, t)
    elif table.dtype == torch.bfloat16:
        ok, ratio = rounding_agree(g, t, 2 ** -7)
        assert ok, f"an output is {ratio:.3g} x its limit from plain"
    else:
        scale = embedding_bag_plain(table.abs(), idx, w.abs(), combiner)
        lim = 1e-5 * scale[~nan].float()
        assert bool(((g - t).abs() <= lim).all())


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,bag,dtype", [
    (100_000, 128, 512, 1, torch.float32),     # DLRM one-hot
    (50_000, 128, 300, 100, torch.float32),    # multi-hot, 100 slots
    (1000, 64, 33, 8, torch.float32),          # ragged last block
    (5000, 10, 64, 4, torch.float32),          # D % 4 != 0: one a lane
    (2000, 200, 16, 3, torch.float32),         # two column passes
    (50_000, 128, 300, 100, torch.bfloat16),
    (3000, 256, 40, 5, torch.bfloat16),
    (3000, 12, 40, 5, torch.bfloat16),         # D % 8 != 0
])
def test_embedding_bag_kernel_matches_plain(dev, combiner, v, d, b, bag,
                                            dtype):
    table, idx, w = _bag_inputs(v, d, b, bag, 70, dev, dtype)
    before = eb_ops.launches
    got = eb_ops.embedding_bag(table, idx, w, combiner)
    torch.cuda.synchronize()
    assert eb_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, d)
    want = embedding_bag_plain(table, idx, w, combiner)
    _bag_agree(got, want, table, idx, w, combiner)
    assert torch.all(got[0] == 0)                   # all padding


def test_embedding_bag_kernel_rows_past_2_pow_24(dev):
    """idx * D passes 2**31 above 16.8M rows at D = 128: the kernel's row
    offsets are 64-bit. A bf16 table of 17M rows (4.4 GB)."""
    v = 17_000_000
    table = torch.empty((v, 128), dtype=torch.bfloat16, device=dev)
    table.normal_(generator=torch.Generator(device=dev).manual_seed(71))
    idx = torch.randint(1 << 24, v, (4096, 1), dtype=torch.int32,
                        device=dev)
    idx[:4, 0] = torch.tensor([v - 1, 1 << 24, (1 << 24) + 1, 0])
    w = torch.ones((4096, 1), device=dev)
    got = eb_ops.embedding_bag(table, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(got, embedding_bag_plain(table, idx, w))
    assert torch.equal(got[0], table[v - 1])


def test_embedding_bag_kernel_unaligned_and_default_weights(dev):
    flat = torch.randn(1000 * 16 + 1, device=dev)
    table = flat[1:].view(1000, 16)                 # 4 bytes off 16
    idx = torch.randint(-2, 1000, (50, 6), dtype=torch.int32, device=dev)
    got = eb_ops.embedding_bag(table, idx)
    want = embedding_bag_plain(table, idx)
    _bag_agree(got, want, table, idx, torch.ones_like(idx, dtype=torch.float),
               "sum")
    assert torch.equal(got, eb_ops.embedding_bag(
        table, idx.long(), torch.ones((50, 6), device=dev)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bag", [1, 4])
def test_embedding_bag_kernel_reads_fields_in_place(dev, weighted, bag):
    """DLRM's call: field i of (B, 26, L) ids and weights, read through
    its row stride (null weights: unit weights), equals the launch on
    contiguous copies bit for bit."""
    table, _, _ = _bag_inputs(30_000, 128, 8, 1, 72, dev)
    rng = np.random.default_rng(72)
    ids = torch.tensor(rng.integers(-1, 30_000, (300, 26, bag)),
                       dtype=torch.int32, device=dev)
    ids[5, 7, 0] = 30_000                           # a NaN bag
    w = torch.tensor(rng.random((300, 26, bag)), dtype=torch.float32,
                     device=dev) if weighted else None
    for i in (0, 7, 25):
        wi = None if w is None else w[:, i]
        before = eb_ops.launches
        got = eb_ops.embedding_bag(table, ids[:, i], wi, "mean")
        torch.cuda.synchronize()
        assert eb_ops.launches == before + 1
        want = eb_ops.embedding_bag(
            table, ids[:, i].contiguous(),
            torch.ones((300, bag), device=dev) if wi is None
            else wi.contiguous(), "mean")
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
        _bag_agree(got, embedding_bag_plain(table, ids[:, i], wi, "mean"),
                   table, ids[:, i], torch.ones((300, bag), device=dev)
                   if wi is None else wi, "mean")


def test_embedding_bag_kernel_rejects_bad_input(dev):
    table = torch.randn((10, 8), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag(table.t(), torch.zeros((2, 1), dtype=torch.int32,
                                                    device=dev))
    with pytest.raises(ValueError, match="indices on cpu"):
        eb_ops.embedding_bag(table, torch.zeros((2, 1), dtype=torch.int32))
    before = eb_ops.launches
    out = eb_ops.embedding_bag(table, torch.zeros((0, 3), dtype=torch.int32,
                                                  device=dev))
    assert out.shape == (0, 8) and eb_ops.launches == before


def _group_inputs(vs, d, b, bag, seed, dev, dtype=torch.float32):
    """Tables of the V in ``vs``; ids (B, F, L) as a strided view of a
    (B, F + 2, L) tensor, each field over its own table with 30% padding
    (-1 and -7), bag 0 of every field all padding, bag 1 of field 0
    holding the id V (a NaN row); weights as a strided view too."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = [torch.empty((v, d), dtype=dtype, device=dev).normal_(
        generator=gen) for v in vs]
    f = len(vs)
    ids = np.stack([rng.integers(0, v, (b, bag)) for v in vs], 1)
    u = rng.random((b, f, bag))
    ids = np.where(u < 0.15, -1, np.where(u < 0.3, -7, ids))
    ids[0] = -1
    ids[1, 0, bag // 2] = vs[0]
    big = torch.zeros((b, f + 2, bag), dtype=torch.int32, device=dev)
    big[:, 1:f + 1] = torch.tensor(ids, dtype=torch.int32, device=dev)
    w = torch.rand((b, f + 1, bag), generator=gen, device=dev)[:, 1:]
    return tables, big[:, 1:f + 1], w


DLRM_LIKE = (30_000, 3, 1441, 200_000, 62, 17_245)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("bag,d,dtype", [
    (1, 128, torch.float32),        # DLRM one-hot
    (4, 128, torch.float32),
    (100, 128, torch.float32),      # multi-hot: depth 8
    (100, 128, torch.bfloat16),     # 8-byte chunks, 32 lanes
    (5, 256, torch.bfloat16),       # 16-byte chunks
    (3, 10, torch.float32),         # 8-byte chunks, 5 lanes
    (3, 12, torch.bfloat16),
    (2, 200, torch.float32),        # two column passes
])
def test_embedding_bag_grouped_matches_plain(dev, weighted, combiner, bag,
                                             d, dtype):
    tables, ids, w = _group_inputs(DLRM_LIKE, d, 300, bag, 80, dev, dtype)
    w = w if weighted else None
    f = len(tables)
    feats = torch.full((300, f + 1, d), 3.0, dtype=dtype, device=dev)
    before = eb_ops.launches
    got = eb_ops.embedding_bag_grouped(tables, ids, w, combiner,
                                       out=feats[:, 1:])
    torch.cuda.synchronize()
    assert eb_ops.launches == before + 1
    assert bool((feats[:, 0] == 3.0).all())         # field 0 untouched
    ones = torch.ones(ids.shape, device=dev)
    for i, t in enumerate(tables):
        wi = None if w is None else w[:, i]
        _bag_agree(got[:, i], embedding_bag_plain(t, ids[:, i], wi, combiner),
                   t, ids[:, i], ones[:, i] if wi is None else wi, combiner)
        assert torch.all(got[0, i] == 0)            # all padding
    assert bool(torch.isnan(got[1, 0]).all())


@pytest.mark.parametrize("bag,dtype", [(1, torch.float32),
                                       (7, torch.float32),
                                       (100, torch.bfloat16)])
def test_embedding_bag_grouped_equals_single_calls_bitwise(dev, bag, dtype):
    """The F = 1 entry (one launch a table) equals the grouped call field
    by field, and a bag alone (a group of one bag) equals the same bag
    inside the group, bit for bit."""
    tables, ids, w = _group_inputs(DLRM_LIKE, 128, 200, bag, 81, dev, dtype)
    got = eb_ops.embedding_bag_grouped(tables, ids, w, "mean")
    for i, t in enumerate(tables):
        one = eb_ops.embedding_bag(t, ids[:, i], w[:, i], "mean")
        assert torch.equal(got[:, i].nan_to_num(), one.nan_to_num())
        assert torch.equal(got[:, i].isnan(), one.isnan())
    for b_, f_ in ((2, 0), (57, 3), (199, 5)):
        alone = eb_ops.embedding_bag_grouped(
            [tables[f_]], ids[b_:b_ + 1, f_:f_ + 1], w[b_:b_ + 1, f_:f_ + 1],
            "mean")
        assert torch.equal(alone[0, 0], got[b_, f_])


def test_embedding_bag_grouped_rejects_bad_input(dev):
    t = torch.randn((10, 8), device=dev)
    ids = torch.zeros((2, 2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag_grouped([t, torch.randn((8, 8), device=dev).t()],
                                     ids)
    with pytest.raises(ValueError, match="on cpu"):
        eb_ops.embedding_bag_grouped([t, torch.randn((8, 8))], ids)
    with pytest.raises(TypeError, match="one dtype"):
        eb_ops.embedding_bag_grouped([t, t.to(torch.bfloat16)], ids)
    with pytest.raises(ValueError, match="65 tables"):
        eb_ops.embedding_bag_grouped([t] * 65, torch.zeros(
            (2, 65, 1), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="out"):
        eb_ops.embedding_bag_grouped([t, t], ids, out=torch.empty(
            (2, 8, 2), device=dev).transpose(1, 2))
    before = eb_ops.launches
    out = eb_ops.embedding_bag_grouped([t, t], ids[:0])
    assert out.shape == (0, 2, 8) and eb_ops.launches == before


FIRST_CALLS_FROM_THREADS = r"""
import threading
import numpy as np
import torch
from repro_torch.index.quant import fixed_scale, quantize_rows
from repro_torch.kernels.temporal_mask_score import ops as tops
from repro_torch.kernels.temporal_mask_score.plain import (
    temporal_window_topk_q8_plain)
from repro_torch.kernels.topk_search import ops as kops
from repro_torch.kernels.topk_search.plain import topk_search_q8_plain
from repro_torch.testing import topk_agree

rng = np.random.default_rng(7)
x = rng.standard_normal((5000, 384)).astype(np.float32)
x /= np.linalg.norm(x, axis=1, keepdims=True)
q = x[:8] + 0.05 * rng.standard_normal((8, 384)).astype(np.float32)
c8 = torch.from_numpy(quantize_rows(x, fixed_scale(384)))
sc = torch.from_numpy(fixed_scale(384))
mask = torch.from_numpy(rng.random(5000) > 0.2)
vf = torch.from_numpy(rng.integers(0, 50, 5000))
vt = vf + torch.from_numpy(rng.integers(1, 50, 5000))
t0 = torch.from_numpy(rng.integers(0, 60, 8))
t1 = t0 + 10
qt = torch.from_numpy(q)
want = {"topk": topk_search_q8_plain(qt, c8, sc, mask, 11),
        "window": temporal_window_topk_q8_plain(qt, c8, sc, vf, vt, t0, t1,
                                                11)}
dev = torch.device("cuda", 0)
args = {"topk": (qt.to(dev), c8.to(dev), sc, mask.to(dev), 10),
        "window": (qt.to(dev), c8.to(dev), sc, vf.to(dev), vt.to(dev),
                   t0.to(dev), t1.to(dev), 10)}
fns = {"topk": kops.topk_search_q8, "window": tops.temporal_window_topk_q8}
gate = threading.Barrier(8)
got, errors = {}, []

def user(i):
    name = ("topk", "window")[i % 2]
    try:
        gate.wait(60)
        got[i] = (name, [t.cpu() for t in fns[name](*args[name])])
    except Exception as e:
        errors.append(repr(e))

threads = [threading.Thread(target=user, args=(i,)) for i in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
assert not errors, errors
assert len(got) == 8
for i, (name, (s, ids)) in sorted(got.items()):
    ok, err, why = topk_agree(s, ids, *want[name])
    assert ok, (i, name, err, why)
assert kops.launches_q8 == 4 and tops.launches_q8 == 4
print("ok")
"""


def test_first_q8_calls_from_eight_threads(dev):
    """Eight threads make a fresh process's first ``topk_search_q8`` and
    ``temporal_window_topk_q8`` calls at once (as the planner's scatter
    pool or the maintenance worker can): every answer equals the plain
    version's, and every launch is counted."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", FIRST_CALLS_FROM_THREADS],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------
from repro_torch.kernels.embedding_bag.plain import (  # noqa: E402
    embedding_bag_backward_plain)
from repro_torch.kernels.flash_attention.plain import (  # noqa: E402
    flash_attention_bwd_plain, o_rounding_bound)
from repro_torch.testing import lse_agree  # noqa: E402


def _grads_agree(got, want, dtype, bound=(None,) * 3):
    """``bound``: ``o_rounding_bound``'s, used in bf16 only."""
    from repro_torch.testing import grads_agree
    bf16 = dtype == torch.bfloat16
    for g, w, e in zip(got, want, bound):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        ok, ratio = grads_agree(g, w, bf16, e if bf16 else None)
        assert ok, f"a gradient is {ratio:.3g} x its limit from plain"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal", [
    (1, 4, 4, 128, 128, 64, True), (2, 8, 2, 100, 300, 64, True),
    (1, 4, 1, 77, 77, 32, False), (1, 8, 2, 130, 390, 128, False),
    (1, 32, 8, 256, 256, 128, True),       # Mistral-NeMo's heads
    (16, 2, 2, 200, 200, 32, False),       # BERT4Rec
    (1, 2, 2, 100, 40, 128, True),         # 60 rows that see no key
    (2, 4, 4, 65, 129, 64, False),
    (1, 10, 2, 200, 333, 128, True),       # GQA 5 (Qwen1.5-32B's group)
    (1, 12, 2, 333, 200, 64, True),        # GQA 6 (Nemotron-4), Sq > Skv
    (1, 4, 2, 191, 257, 64, False),        # Sq, Skv off the 64/128 tiles
    (1, 4, 2, 257, 191, 128, True),
    (1, 8, 2, 4096, 4096, 128, True),      # a 4096-token causal layer
])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, b, h, kv, sq,
                                                  skv, d, causal):
    """bf16 at D 64 and 128 runs the tensor-core body (its own launch
    count moves), fp32 and bf16 at D 32 the CUDA-core body."""
    q = _randn((b, h, sq, d), 90, dev, dtype)
    k = _randn((b, kv, skv, d), 91, dev, dtype)
    v = _randn((b, kv, skv, d), 92, dev, dtype)
    do = _randn((b, h, sq, d), 93, dev, dtype)
    o, lse = fa_ops.flash_attention_with_lse(q, k, v, causal)
    assert torch.equal(o, fa_ops.flash_attention(q, k, v, causal))
    o_p, lse_p = flash_attention_plain(q, k, v, causal, return_lse=True)
    ok, ratio = lse_agree(lse, lse_p)
    assert ok, f"lse is {ratio:.3g} x its limit from plain"
    before, before_tc = fa_ops.bwd_launches, fa_ops.bwd_tc_launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == before + 1
    tc = dtype == torch.bfloat16 and d in (64, 128)
    assert fa_ops.bwd_tc_launches == before_tc + tc
    _grads_agree(got, flash_attention_bwd_plain(q, k, v, o, do, lse, causal),
                 dtype)
    # the chain: the plain backward on the plain forward's o and lse
    _grads_agree(got, flash_attention_bwd_plain(q, k, v, o_p, do, lse_p,
                                                causal), dtype,
                 o_rounding_bound(q, k, v, o_p, do, lse_p, causal))
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if causal and sq > skv:
        assert bool(torch.isneginf(lse[:, :, :sq - skv]).all())
        assert float(got[0][:, :, :sq - skv].abs().max()) == 0.0


def test_flash_attention_autograd_on_the_card(dev):
    """torch.autograd through flash_attention launches the forward with
    its lse and the backward kernel once; the output is the serving
    output bit for bit and the grads are flash_attention_bwd's."""
    q, k, v = (_randn(s, 94 + i, dev, torch.bfloat16) for i, s in
               enumerate([(1, 8, 200, 128), (1, 2, 200, 128),
                          (1, 2, 200, 128)]))
    do = _randn((1, 8, 200, 128), 97, dev, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    out = fa_ops.flash_attention(*leaves, causal=True)
    out.backward(do)
    assert (fa_ops.launches, fa_ops.bwd_launches) == (f0 + 1, b0 + 1)
    assert torch.equal(out.detach(), fa_ops.flash_attention(q, k, v, True))
    o, lse = fa_ops.flash_attention_with_lse(q, k, v, True)
    want = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, True)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_tensor_core_attention_from_a_fresh_thread(dev):
    """A thread that has made no CUDA call yet, whose allocations the
    caching allocator serves from freed blocks (as autograd's device
    thread after a larger call), runs the bf16 forward and backward on
    the tensor cores bit for bit with the main thread: a launch makes the
    device's primary context current before it encodes its tensor maps
    (``cuTensorMapEncodeTiled`` fails with "invalid argument" without
    one)."""
    import threading
    q, do = (_randn((1, 8, 200, 128), 110 + i, dev, torch.bfloat16)
             for i in range(2))
    k, v = (_randn((1, 2, 200, 128), 112 + i, dev, torch.bfloat16)
            for i in range(2))
    o, lse = fa_ops.flash_attention_with_lse(q, k, v, True)
    want = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, True)
    spare = (fa_ops.flash_attention_with_lse(q, k, v, True),
             fa_ops.flash_attention_bwd(q, k, v, o, do, lse, True))
    del spare                   # freed blocks for the thread's outputs
    out, errors = {}, []

    def run():
        try:
            out["fwd"] = fa_ops.flash_attention_with_lse(q, k, v, True)
            out["bwd"] = fa_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                                    True)
            torch.cuda.synchronize()
        except Exception as exc:                   # noqa: BLE001
            errors.append(exc)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    assert torch.equal(out["fwd"][0], o) and torch.equal(out["fwd"][1], lse)
    assert all(torch.equal(x, y) for x, y in zip(out["bwd"], want))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_card_vs_cpu_plain(dev, causal):
    """bf16 at D 128 (the wgmma forward): torch.autograd through
    flash_attention on the card against torch.autograd through the plain
    forward on the CPU, the output and dq, dk, dv by grads_agree, the
    grads with o_rounding_bound (the CPU's gradient reads the fp32
    output, the card's its bf16 rounding)."""
    from repro_torch.testing import grads_agree
    x = [_randn(s, 100 + i, dev, torch.bfloat16) for i, s in
         enumerate([(1, 8, 300, 128), (1, 2, 300, 128), (1, 2, 300, 128),
                    (1, 8, 300, 128)])]
    card = [t.clone().requires_grad_(True) for t in x[:3]]
    cpu = [t.cpu().requires_grad_(True) for t in x[:3]]
    out = fa_ops.flash_attention(*card, causal=causal)
    out.backward(x[3])
    want, lse = flash_attention_plain(*cpu, causal=causal, return_lse=True)
    want.backward(x[3].cpu())
    bound = o_rounding_bound(*(t.detach() for t in cpu), want.detach(),
                             x[3].cpu(), lse.detach(), causal)
    for got, ref, e in zip([out.detach()] + [t.grad for t in card],
                           [want.detach()] + [t.grad for t in cpu],
                           (None,) + bound):
        assert got.dtype == torch.bfloat16
        ok, ratio = grads_agree(got.cpu(), ref, True, e)
        assert ok, f"{ratio:.3g} x its limit from the CPU"


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("bag,d,dtype,hot", [
    (1, 128, torch.float32, False),     # DLRM one-hot
    (1, 128, torch.float32, True),      # every id below 3: long runs
    (4, 128, torch.float32, False),
    (100, 64, torch.float32, True),
    (3, 10, torch.float32, False),      # D % 4 != 0
    (2, 200, torch.float32, False),     # two column passes
    (4, 128, torch.bfloat16, True),
])
def test_embedding_bag_bwd_kernel_matches_plain(dev, weighted, combiner, bag,
                                                d, dtype, hot):
    tables, ids, w = _group_inputs(DLRM_LIKE, d, 3000, bag, 95, dev, dtype)
    if hot:
        ids = torch.where(ids >= 0, ids % 3, ids)
    w = w if weighted else None
    sizes = [t.shape[0] for t in tables]
    g = _randn((3000, len(tables) + 1, d), 96, dev, dtype)[:, 1:]
    before = eb_ops.bwd_launches
    got = eb_ops.embedding_bag_grouped_bwd(sizes, dtype, ids, w, combiner, g)
    torch.cuda.synchronize()
    assert eb_ops.bwd_launches == before + 1
    assert got.dtype == dtype and got.shape == (sum(sizes), d)
    want = embedding_bag_backward_plain(sizes, dtype, ids, w, combiner, g)
    assert torch.equal(got, want)
    again = eb_ops.embedding_bag_grouped_bwd(sizes, dtype, ids, w, combiner,
                                             g)
    assert torch.equal(got, again)


def test_embedding_bag_autograd_on_the_card(dev):
    """DLRM's call under autograd: the grouped bags into feats[:, 1:] of a
    stack, backward through it, one backward launch; each table's grad
    is its rows of embedding_bag_grouped_bwd's stacked gradient."""
    tables, ids, _ = _group_inputs(DLRM_LIKE, 128, 512, 1, 98, dev,
                                   torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in tables]
    x0 = torch.randn(512, 128, device=dev, requires_grad=True)
    feats = x0.new_empty((512, len(tables) + 1, 128))
    feats[:, 0] = x0
    eb_ops.embedding_bag_grouped(leaves, ids, None, "sum", out=feats[:, 1:])
    g = _randn(tuple(feats.shape), 99, dev, torch.float32)
    b0 = eb_ops.bwd_launches
    feats.backward(g)
    assert eb_ops.bwd_launches == b0 + 1
    assert torch.equal(x0.grad, g[:, 0])
    sizes = [t.shape[0] for t in tables]
    want = eb_ops.embedding_bag_grouped_bwd(sizes, torch.float32, ids, None,
                                            "sum", g[:, 1:])
    row = 0
    for leaf, n in zip(leaves, sizes):
        assert torch.equal(leaf.grad, want[row:row + n])
        row += n


# ---------------------------------------------------------------------------
# gather_segment_sum (SchNet's message passing): the kernel sums the plain
# version's terms in its order, so the two agree bit for bit (NaN rows at
# the same places), and two runs do too.
# ---------------------------------------------------------------------------
def _same(a, b) -> bool:
    """Equal bit for bit where not NaN, NaN at the same places (the card
    returns its canonical NaN for any arithmetic on one)."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0.0, a),
                            torch.where(b.isnan(), 0.0, b)))


def _segment_inputs(dev, n, n_out, e, d, seed, hot=False, bad=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n_out, e)
    if hot:                                   # a sampled batch's padding
        src[::2] = 0
        dst[::2] = 0
    if bad:                                   # jnp.take's fill, dropped dst
        src[::17] = n + 5
        src[1::19] -= n
        dst[::13] = -1
        dst[2::23] = n_out
    x = _randn((n, d), seed + 1, dev, torch.float32)
    w = _randn((e, d), seed + 2, dev, torch.float32)
    return (x, w, torch.tensor(src, device=dev, dtype=torch.int32),
            torch.tensor(dst, device=dev, dtype=torch.int32))


@pytest.mark.parametrize("n,n_out,e,d,hot,bad,weighted", [
    (3840, 3840, 8192, 64, False, False, True),        # molecule
    (3840, 128, 3840, 1, False, False, False),         # energy readout
    (5000, 5000, 40_000, 64, True, False, True),       # a hot row 0
    (700, 600, 9000, 64, False, True, True),           # NaN rows, dropped
    (300, 200, 5000, 100, False, False, True),         # two column passes
    (1000, 1000, 3000, 16, False, True, False),
])
def test_gather_segment_sum_kernel_matches_plain(dev, n, n_out, e, d, hot,
                                                 bad, weighted):
    from repro_torch.kernels.segment_sum import (EdgePlan, gather_segment_sum,
                                                 segment_sum_plain,
                                                 weight_grad)
    from repro_torch.kernels.segment_sum import ops as ss_ops
    x, w, src, dst = _segment_inputs(dev, n, n_out, e, d, 200 + e, hot, bad)
    w = w if weighted else None
    plan = EdgePlan(src, dst, n, n_out)
    xg = x.clone().requires_grad_(True)
    wg = None if w is None else w.clone().requires_grad_(True)
    before = ss_ops.launches
    out = gather_segment_sum(xg, None, None, n_out, wg, plan=plan)
    g = _randn((n_out, d), 300 + e, dev, torch.float32)
    out.backward(g)
    torch.cuda.synchronize()
    assert ss_ops.launches == before + 2           # forward, dx
    assert _same(out, segment_sum_plain(x, w, plan.fwd))
    assert _same(xg.grad, segment_sum_plain(g, w, plan.bwd))
    if w is not None:
        assert _same(wg.grad, weight_grad(x, g, plan))
    if bad:
        assert bool(out.isnan().any())
    again = gather_segment_sum(x, src, dst, n_out, w)
    assert _same(out.detach(), again)


def test_gather_segment_sum_rejects_bad_input(dev):
    from repro_torch.kernels.segment_sum import EdgePlan, gather_segment_sum
    x, w, src, dst = _segment_inputs(dev, 50, 40, 300, 8, 7)
    with pytest.raises(TypeError, match="float32"):
        gather_segment_sum(x.double(), src, dst, 40, w.double())
    with pytest.raises(ValueError, match="plan wants"):
        gather_segment_sum(x, src, dst, 40, w[:-1])
    plan = EdgePlan(src.cpu(), dst.cpu(), 50, 40)
    with pytest.raises(ValueError, match="plan on"):
        gather_segment_sum(x, None, None, 40, w, plan=plan)


def test_schnet_step_repeats_on_the_card(dev):
    """The reduced SchNet cells' loss and gradients, twice on the card from
    the same params and batch: bit for bit, with no aten op on the path
    that adds at indices (atomics on the card; index_select's backward,
    the control, is one), and within 1e-4 of each leaf's largest of the
    CPU's."""
    from repro_torch.launch import steps
    from repro_torch.testing import accumulating_ops
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves, tree_map
    x = torch.zeros((3, 2), device=dev, requires_grad=True)
    idx = torch.tensor([0, 1, 1], device=dev)
    assert accumulating_ops(
        lambda: x.index_select(0, idx).sum().backward()) != []
    for shape in ("molecule", "minibatch_lg"):
        cell = steps.build_cell("schnet", shape, reduced=True, device=dev)
        params, _, batch, _ = steps.make_smoke_args(cell, seed=3)
        vg = grad_accum_value_and_grad(cell.loss)
        out = []
        assert accumulating_ops(lambda: out.append(vg(params, batch))) == []
        l1, g1 = out[0]
        l2, g2 = vg(tree_map(lambda t: t.detach().clone(), params), batch)
        assert torch.equal(l1, l2)
        for (name, a), (_, b) in zip(leaves(g1), leaves(g2)):
            assert torch.equal(a, b), name
        cpu = tree_map(lambda t: t.detach().cpu(), params)
        lc, gc = vg(cpu, {k: v.cpu() for k, v in batch.items()})
        assert abs(float(l1) - float(lc)) <= 1e-4 * max(1.0, abs(float(lc)))
        for (name, a), (_, b) in zip(leaves(g1), leaves(gc)):
            lim = 1e-4 * max(float(b.abs().max()), 1e-30)
            assert float((a.cpu() - b).abs().max()) <= lim, name
