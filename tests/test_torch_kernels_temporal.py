"""Port parity for the validity-masked temporal top-k: repro_torch's
temporal_window_topk / temporal_topk on CPU tensors (the plain PyTorch
version) against repro's NumPy ref (through its wrappers' "ref" mode)
and, where this JAX can run it, its Pallas kernel in interpret mode, on
the same numpy inputs, with real epoch-microsecond timestamps
(above 2**32), boundary instants, VALID_TO_OPEN and the empty-interval
tenant trick (valid_from = VALID_TO_OPEN).

Tolerances: scores within 1e-5 absolute; ids equal at finite slots
whose reference score is more than 1e-5 from both neighbours; the -inf
slots the same, holding index -1 in the port; no out-of-window id."""
import numpy as np
import pytest
import torch

from repro.core.types import VALID_TO_OPEN as REPRO_OPEN
from repro.kernels.temporal_mask_score.ops import (
    temporal_topk as repro_point, temporal_window_topk as repro_window)
from repro.kernels.temporal_mask_score.ref import (
    temporal_topk_ref as repro_point_ref,
    temporal_window_topk_ref as repro_window_ref)
from repro_torch.core.types import VALID_TO_OPEN
from repro_torch.kernels.temporal_mask_score import ops as tops
from repro_torch.kernels.temporal_mask_score.ref import (
    temporal_topk_ref, temporal_window_topk_ref)

from test_torch_kernels_topk import _rand, assert_parity, interpret  # noqa: F401

T0 = 1_700_000_000_000_000          # epoch microseconds (> 2**32)


def _history(n, seed, invisible=0.1):
    rng = np.random.default_rng(seed)
    vf = T0 + rng.integers(0, 1_000, n).astype(np.int64)
    vt = np.where(rng.random(n) < 0.3, VALID_TO_OPEN,
                  vf + rng.integers(1, 500, n)).astype(np.int64)
    vf = np.where(rng.random(n) < invisible, VALID_TO_OPEN, vf)
    return vf, vt


def _windows(nq, seed):
    """Per-query windows: half of them point queries [ts, ts + 1)."""
    rng = np.random.default_rng(seed)
    t0s = T0 + rng.integers(0, 1_000, nq).astype(np.int64)
    t1s = t0s + np.where(rng.random(nq) < 0.5, 1,
                         rng.integers(1, 400, nq)).astype(np.int64)
    return t0s, t1s


def port_window(q, c, vf, vt, t0s, t1s, k):
    return tops.temporal_window_topk(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(vf),
        torch.from_numpy(vt), t0s, t1s, k)


def assert_in_window(idx, scores, vf, vt, t0s, t1s):
    idx, scores = np.asarray(idx), np.asarray(scores)
    for qi in range(idx.shape[0]):
        rows = idx[qi][np.isfinite(scores[qi])]
        assert np.all((vf[rows] < t1s[qi]) & (t0s[qi] < vt[rows]))


def test_open_sentinel_is_int64_max_in_both():
    assert VALID_TO_OPEN == REPRO_OPEN == np.iinfo(np.int64).max


@pytest.mark.parametrize("nq,n,d,k", [
    (1, 256, 128, 5), (4, 1000, 384, 10), (8, 512, 64, 3),
    (2, 130, 384, 7), (3, 64, 256, 64),
])
def test_window_matches_repro_ref(nq, n, d, k):
    q, c = _rand((nq, d), 1), _rand((n, d), 2)
    vf, vt = _history(n, 3)
    t0s, t1s = _windows(nq, 4)
    got = port_window(q, c, vf, vt, t0s, t1s, k)
    assert got[0].shape == (nq, min(k, n)) and got[1].dtype == torch.int32
    assert_parity(got, repro_window(q, c, vf, vt, t0s, t1s, k, mode="ref"))
    assert_parity(got, repro_window_ref(q, c, vf, vt, t0s, t1s, k))
    assert_in_window(got[1], got[0], vf, vt, t0s, t1s)


@pytest.mark.parametrize("nq,n,d,k", [(1, 256, 128, 5), (4, 1000, 384, 10),
                                      (3, 64, 256, 64)])
def test_window_matches_repro_interpret(interpret, nq, n, d, k):
    q, c = _rand((nq, d), 1), _rand((n, d), 2)
    vf, vt = _history(n, 3)
    t0s, t1s = _windows(nq, 4)
    bn = 128 if n < 512 else 256
    assert_parity(port_window(q, c, vf, vt, t0s, t1s, k),
                  repro_window(q, c, vf, vt, t0s, t1s, k, bn=bn,
                               mode=interpret))


@pytest.mark.parametrize("ts_off,live", [
    (-1, []), (0, [0]), (9, [0]), (10, [1, 2]), (11, [1]), (10**12, [1]),
])
def test_point_query_boundary_instants(ts_off, live):
    """valid_from <= ts < valid_to, exactly, at the interval ends; row 3
    is tenant-invisible (vf = VALID_TO_OPEN) and never returned."""
    c, q = _rand((4, 32), 5), _rand((3, 32), 6)
    vf = np.array([T0, T0 + 10, T0 + 10, VALID_TO_OPEN], np.int64)
    vt = np.array([T0 + 10, VALID_TO_OPEN, T0 + 11, VALID_TO_OPEN],
                  np.int64)
    ts = T0 + ts_off
    s, i = tops.temporal_topk(torch.from_numpy(q), torch.from_numpy(c),
                              torch.from_numpy(vf), torch.from_numpy(vt),
                              ts, 4)
    for qi in range(3):
        assert sorted(int(x) for x in i[qi] if x >= 0) == live
    assert_parity((s, i), repro_point(q, c, vf, vt, ts, 4, mode="ref"))
    assert_parity((s, i), repro_point_ref(q, c, vf, vt, ts, 4))


def test_invisible_rows_never_rank_even_when_best():
    """The empty-interval tenant trick: the best-scoring rows get
    vf = VALID_TO_OPEN and must come back neither in a point query nor
    in the widest window."""
    q, c = _rand((2, 64), 7), _rand((300, 64), 8)
    best = np.argsort(-(q @ c.T)[0])[:20]
    vf = np.full(300, T0, np.int64)
    vt = np.full(300, VALID_TO_OPEN, np.int64)
    vf[best] = VALID_TO_OPEN
    for t0, t1 in [(T0 + 5, T0 + 6), (0, VALID_TO_OPEN)]:
        s, i = port_window(q, c, vf, vt, t0, t1, 30)
        assert not set(np.asarray(i).ravel().tolist()) & set(best.tolist())
        assert_parity((s, i), repro_window_ref(
            q, c, vf, vt, np.full(2, t0, np.int64), np.full(2, t1, np.int64),
            30))


def test_no_candidate_window_is_all_minus_one():
    q, c = _rand((3, 16), 9), _rand((50, 16), 10)
    vf, vt = _history(50, 11, invisible=0.0)
    s, i = port_window(q, c, vf, vt, T0 - 100, T0 - 50, 5)   # before all
    assert torch.all(torch.isneginf(s)) and torch.all(i == -1)


def test_port_ref_is_repro_ref():
    """The port's NumPy oracle (used by the engine's fused=False path)
    is a copy of repro's: identical outputs, bit for bit."""
    q, c = _rand((4, 48), 12), _rand((200, 48), 13)
    vf, vt = _history(200, 14)
    t0s = np.array([T0, T0 + 100, T0 + 500, T0 + 999], np.int64)
    t1s = t0s + np.array([1, 50, 1, 2], np.int64)
    for a, b in zip(temporal_window_topk_ref(q, c, vf, vt, t0s, t1s, 9),
                    repro_window_ref(q, c, vf, vt, t0s, t1s, 9)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(temporal_topk_ref(q, c, vf, vt, T0 + 300, 9),
                    repro_point_ref(q, c, vf, vt, T0 + 300, 9)):
        np.testing.assert_array_equal(a, b)


def test_window_scores_are_batch_invariant_bitwise():
    q, c = _rand((7, 384), 15), _rand((600, 384), 16)
    vf, vt = _history(600, 17)
    t0s = T0 + np.arange(7, dtype=np.int64) * 100
    t1s = t0s + 200
    full_s, full_i = port_window(q, c, vf, vt, t0s, t1s, 10)
    for lo, hi in [(0, 1), (1, 3), (3, 7)]:
        s, i = port_window(np.ascontiguousarray(q[lo:hi]), c, vf, vt,
                           t0s[lo:hi], t1s[lo:hi], 10)
        assert torch.equal(s, full_s[lo:hi]) and torch.equal(i, full_i[lo:hi])


def test_cpu_path_counts_no_launch_and_checks_inputs():
    q, c = _rand((2, 8), 18), _rand((40, 8), 19)
    vf, vt = _history(40, 20)
    before = tops.launches
    port_window(q, c, vf, vt, T0, T0 + 1, 5)
    assert tops.launches == before
    with pytest.raises(TypeError):           # int32 timestamps refused
        tops.temporal_window_topk(
            torch.from_numpy(q), torch.from_numpy(c),
            torch.from_numpy(vf.astype(np.int32)), torch.from_numpy(vt),
            T0, T0 + 1, 5)
    with pytest.raises(ValueError):
        tops.temporal_window_topk(
            torch.from_numpy(q), torch.from_numpy(c),
            torch.from_numpy(vf[:30]), torch.from_numpy(vt), T0, T0 + 1, 5)
