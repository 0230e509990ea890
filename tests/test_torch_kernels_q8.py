"""Port parity for the int8 (quantized) scan kernels: repro_torch's
topk_search_q8 / temporal_window_topk_q8 on CPU tensors (their plain
PyTorch versions) against repro's wrappers in "ref" mode (the Pallas
kernels' function: fp32 scale-folded queries against int8 rows widened
to fp32) and, where this JAX can run it, against the Pallas kernels in
interpret mode, on the same numpy inputs. repro's default CPU mode
("host") also quantizes each query to int8, so its candidate pool is a
different function; the stores are held to it after the rescore, by
recall (tests/test_torch_store.py).

Tolerances: scores within 1e-5 absolute (the packages sum the dot
products in different orders); ids equal at every finite slot whose
reference score is more than 1e-5 from both neighbours; the -inf slots
the same, holding index -1. The IVF member scan runs the same host code
(kernels/qscan.py) in both packages and is held bit for bit."""
import numpy as np
import pytest
import torch

from repro.core.ivf import IVFIndex as ReproIVF
from repro.kernels.qscan import asym_scores_host as repro_asym
from repro.kernels.temporal_mask_score.ops import (
    temporal_window_topk_q8 as repro_window_q8)
from repro.kernels.temporal_mask_score.ref import (
    temporal_window_topk_q8_ref as repro_window_q8_ref)
from repro.kernels.topk_search.ops import topk_search_q8 as repro_topk_q8
from repro.kernels.topk_search.ref import topk_search_q8_ref
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.types import VALID_TO_OPEN
from repro_torch.index.quant import (data_scale, fixed_scale, fold_scale,
                                     quantize_rows)
from repro_torch.kernels.qscan import asym_scores_host
from repro_torch.kernels.temporal_mask_score import ops as tops
from repro_torch.kernels.topk_search import ops as kops
from repro_torch.kernels.topk_search.plain import topk_search_q8_plain

from test_torch_kernels_temporal import T0, _history, _windows, assert_in_window
from test_torch_kernels_topk import _rand, assert_parity, interpret  # noqa: F401


def _q8(n, d, seed, scale=None):
    """int8 rows of unit vectors: under the fixed 1/127 scale (the store's
    fused block and resident history) or their own data scale."""
    c = _rand((n, d), seed)
    scale = fixed_scale(d) if scale is None else scale(c)
    return quantize_rows(c, scale), scale


def port_topk_q8(q, c8, scale, mask, k):
    return kops.topk_search_q8(torch.from_numpy(q), torch.from_numpy(c8),
                               scale, torch.from_numpy(mask), k)


def port_window_q8(q, c8, scale, vf, vt, t0s, t1s, k):
    return tops.temporal_window_topk_q8(
        torch.from_numpy(q), torch.from_numpy(c8), scale,
        torch.from_numpy(vf), torch.from_numpy(vt), t0s, t1s, k)


# the shapes of tests/test_kernels_topk.py, plus a ragged N, k == n and a
# k on the kernel's deeper list (65..128)
SHAPES = [
    (1, 256, 128, 5), (4, 1000, 384, 10), (8, 512, 64, 3),
    (2, 130, 384, 7), (3, 64, 256, 64), (5, 333, 96, 40),
    (2, 700, 64, 100),
]


@pytest.mark.parametrize("scale", [None, data_scale], ids=["fixed", "data"])
@pytest.mark.parametrize("nq,n,d,k", SHAPES)
def test_topk_q8_plain_matches_repro_ref(nq, n, d, k, scale):
    q = _rand((nq, d), 1)
    c8, sc = _q8(n, d, 2, scale)
    mask = np.random.default_rng(3).random(n) > 0.3
    got = port_topk_q8(q, c8, sc, mask, k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == (nq, min(k, n))
    assert_parity(got, repro_topk_q8(q, c8, sc, mask, k, mode="ref"))
    assert_parity(got, topk_search_q8_ref(fold_scale(q, sc), c8, mask,
                                          min(k, n)))


@pytest.mark.parametrize("nq,n,d,k", [(1, 256, 128, 5), (4, 1000, 384, 10),
                                      (3, 64, 256, 64)])
def test_topk_q8_plain_matches_repro_interpret(interpret, nq, n, d, k):
    q = _rand((nq, d), 1)
    c8, sc = _q8(n, d, 2)
    mask = np.random.default_rng(3).random(n) > 0.3
    bn = 128 if n < 512 else 256
    assert_parity(port_topk_q8(q, c8, sc, mask, k),
                  repro_topk_q8(q, c8, sc, mask, k, bn=bn, mode=interpret))


@pytest.mark.parametrize("nq,n,d,k", SHAPES)
def test_window_q8_plain_matches_repro_ref(nq, n, d, k):
    q = _rand((nq, d), 4)
    c8, sc = _q8(n, d, 5)
    vf, vt = _history(n, 6)
    t0s, t1s = _windows(nq, 7)
    got = port_window_q8(q, c8, sc, vf, vt, t0s, t1s, k)
    assert got[0].shape == (nq, min(k, n)) and got[1].dtype == torch.int32
    assert_parity(got, repro_window_q8(q, c8, sc, vf, vt, t0s, t1s, k,
                                       mode="ref"))
    assert_parity(got, repro_window_q8_ref(fold_scale(q, sc), c8, vf, vt,
                                           t0s, t1s, min(k, n)))
    assert_in_window(got[1], got[0], vf, vt, t0s, t1s)


@pytest.mark.parametrize("nq,n,d,k", [(1, 256, 128, 5), (4, 1000, 384, 10),
                                      (3, 64, 256, 64)])
def test_window_q8_plain_matches_repro_interpret(interpret, nq, n, d, k):
    q = _rand((nq, d), 4)
    c8, sc = _q8(n, d, 5)
    vf, vt = _history(n, 6)
    t0s, t1s = _windows(nq, 7)
    bn = 128 if n < 512 else 256
    assert_parity(port_window_q8(q, c8, sc, vf, vt, t0s, t1s, k),
                  repro_window_q8(q, c8, sc, vf, vt, t0s, t1s, k, bn=bn,
                                  mode=interpret))


def test_q8_masked_and_invisible_rows_never_rank_even_when_best():
    q = _rand((2, 64), 8)
    c8, sc = _q8(300, 64, 9)
    best = np.argsort(-(q @ c8.T.astype(np.float32))[0])[:20]
    mask = np.ones(300, bool)
    mask[best] = False
    s, i = port_topk_q8(q, c8, sc, mask, 30)
    assert not set(np.asarray(i).ravel().tolist()) & set(best.tolist())
    assert_parity((s, i), topk_search_q8_ref(fold_scale(q, sc), c8, mask, 30))
    vf = np.full(300, T0, np.int64)
    vt = np.full(300, VALID_TO_OPEN, np.int64)
    vf[best] = VALID_TO_OPEN                  # tenant-invisible rows
    for t0, t1 in [(T0 + 5, T0 + 6), (0, VALID_TO_OPEN)]:
        s, i = port_window_q8(q, c8, sc, vf, vt, t0, t1, 30)
        assert not set(np.asarray(i).ravel().tolist()) & set(best.tolist())
        assert_parity((s, i), repro_window_q8(q, c8, sc, vf, vt, t0, t1, 30,
                                              mode="ref"))


@pytest.mark.parametrize("which", ["topk", "window"])
def test_q8_ties_go_to_the_lower_row(which):
    base, sc = _q8(20, 32, 10)
    c8 = np.repeat(base, 3, axis=0)           # every row three times
    q = _rand((5, 32), 11)
    if which == "topk":
        s, i = port_topk_q8(q, c8, sc, np.ones(60, bool), 12)
    else:
        s, i = port_window_q8(q, c8, sc, np.full(60, T0, np.int64),
                              np.full(60, VALID_TO_OPEN, np.int64), T0,
                              T0 + 1, 12)
    exact = fold_scale(q, sc) @ base.T.astype(np.float32)
    want = np.repeat(np.argsort(-exact, axis=1, kind="stable")[:, :4],
                     3, axis=1) * 3 + np.tile(np.arange(3), 4)[None, :]
    np.testing.assert_array_equal(np.asarray(i), want)


def test_q8_empty_slots_are_neg_inf_and_minus_one():
    q = _rand((3, 16), 12)
    c8, sc = _q8(6, 16, 13)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    s, i = port_topk_q8(q, c8, sc, mask, 6)           # k == n
    assert torch.all(i[:, 4:] == -1) and torch.all(torch.isneginf(s[:, 4:]))
    assert set(i[0, :4].tolist()) == {0, 2, 3, 5}
    s, i = port_topk_q8(q, c8, sc, np.zeros(6, bool), 4)
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
    vf, vt = _history(6, 14, invisible=0.0)
    s, i = port_window_q8(q, c8, sc, vf, vt, T0 - 100, T0 - 50, 5)
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)
    s, i = port_topk_q8(q, np.zeros((0, 16), np.int8), sc, np.zeros(0, bool),
                        5)
    assert s.shape == (3, 0) and i.shape == (3, 0)


@pytest.mark.parametrize("which", ["topk", "window"])
def test_q8_scores_are_batch_invariant_bitwise(which):
    q = _rand((9, 384), 15)
    c8, sc = _q8(700, 384, 16)
    mask = np.random.default_rng(17).random(700) > 0.1
    vf, vt = _history(700, 18)
    t0s = T0 + np.arange(9, dtype=np.int64) * 100
    t1s = t0s + 300

    def run(lo, hi):
        qq = np.ascontiguousarray(q[lo:hi])
        if which == "topk":
            return port_topk_q8(qq, c8, sc, mask, 40)
        return port_window_q8(qq, c8, sc, vf, vt, t0s[lo:hi], t1s[lo:hi], 40)

    full_s, full_i = run(0, 9)
    for lo, hi in [(0, 1), (2, 4), (3, 9)]:
        s, i = run(lo, hi)
        assert torch.equal(s, full_s[lo:hi]) and torch.equal(i, full_i[lo:hi])


def test_q8_plain_is_the_cpu_path_and_counts_no_launch():
    q = _rand((3, 32), 19)
    c8, sc = _q8(90, 32, 20)
    mask = np.random.default_rng(21).random(90) > 0.5
    before = (kops.launches, kops.launches_q8, tops.launches,
              tops.launches_q8)
    a = port_topk_q8(q, c8, sc, mask, 7)
    port_window_q8(q, c8, sc, *_history(90, 22), T0, T0 + 1, 7)
    assert (kops.launches, kops.launches_q8, tops.launches,
            tops.launches_q8) == before
    b = topk_search_q8_plain(torch.from_numpy(q), torch.from_numpy(c8),
                             torch.from_numpy(sc), torch.from_numpy(mask), 7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_q8_wrappers_check_inputs():
    q = torch.from_numpy(_rand((2, 8), 23))
    c8, sc = _q8(50, 8, 24)
    c8 = torch.from_numpy(c8)
    m = torch.ones(50, dtype=torch.bool)
    vf, vt = (torch.from_numpy(x) for x in _history(50, 25))
    with pytest.raises(TypeError):                 # an fp32 corpus
        kops.topk_search_q8(q, c8.float(), sc, m, 5)
    with pytest.raises(TypeError):
        tops.temporal_window_topk_q8(q, c8.float(), sc, vf, vt, T0, T0 + 1, 5)
    with pytest.raises(ValueError):                # scale of the wrong width
        kops.topk_search_q8(q, c8, sc[:4], m, 5)
    with pytest.raises(ValueError):
        tops.temporal_window_topk_q8(q, c8, sc[:4], vf, vt, T0, T0 + 1, 5)
    with pytest.raises(ValueError):
        kops.topk_search_q8(q, c8, sc, m[:40], 5)
    with pytest.raises(ValueError):                # other devices
        meta = torch.empty((50, 8), dtype=torch.int8, device="meta")
        kops.topk_search_q8(torch.empty((2, 8), device="meta"), meta, sc,
                            torch.empty(50, dtype=torch.bool, device="meta"),
                            5)


def test_qscan_is_repro_qscan_bitwise():
    """kernels/qscan.py is a copy of repro's: the host integer scan gives
    the same bits."""
    qs = fold_scale(_rand((5, 64), 26), fixed_scale(64))
    c8, _ = _q8(300, 64, 27)
    np.testing.assert_array_equal(asym_scores_host(qs, c8),
                                  repro_asym(qs, c8))


@pytest.mark.parametrize("masked", [False, True])
def test_quantized_ivf_search_is_repro_bitwise(masked):
    """The quantized IVF member scan (core/ivf.py -> kernels/qscan.py)
    runs the same host code in both packages: bit-identical results."""
    n, d = 3000, 64
    emb = _rand((n, d), 28)
    q = _rand((6, d), 29)
    mask = (np.random.default_rng(30).random(n) > 0.2) if masked else None
    out = []
    for cls in (IVFIndex, ReproIVF):
        ivf = cls(n_centroids=32, seed=0)
        ivf.build(emb)
        c8, sc = quantize_rows(emb, data_scale(emb)), data_scale(emb)
        ivf.attach_quantized(c8, sc, lambda rows: emb[rows],
                             rescore_factor=4)
        out.append(ivf.search(q, k=10, nprobe=4, mask=mask))
    (s, i, st), (s_r, i_r, st_r) = out
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(i, i_r)
    assert st.fraction_scanned == st_r.fraction_scanned
    assert np.all(i >= 0) and (mask is None or np.all(mask[i]))


# k above the card's register list (128): a quantized store's pool at
# query k > 32 (rescore_factor 4)
@pytest.mark.parametrize("nq,n,d,k", [
    (2, 1000, 384, 129), (3, 2000, 96, 500), (1, 5000, 32, 4096),
])
def test_q8_large_k_matches_repro_ref(nq, n, d, k):
    q = _rand((nq, d), 40)
    c8, sc = _q8(n, d, 41)
    mask = np.random.default_rng(42).random(n) > 0.3
    assert_parity(port_topk_q8(q, c8, sc, mask, k),
                  repro_topk_q8(q, c8, sc, mask, k, mode="ref"))
    vf, vt = _history(n, 43)
    t0s, t1s = _windows(nq, 44)
    got = port_window_q8(q, c8, sc, vf, vt, t0s, t1s, k)
    assert_parity(got, repro_window_q8(q, c8, sc, vf, vt, t0s, t1s, k,
                                       mode="ref"))
    assert_in_window(got[1], got[0], vf, vt, t0s, t1s)
