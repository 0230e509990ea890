"""The port's CUDA kernels against their plain PyTorch versions, on the
card (built from src/repro_torch/csrc with nvcc at first use). Every
test here needs a CUDA device and skips without one; this file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: scores within 1e-4 absolute (the kernel sums each dot
product in one fixed fmaf order, the plain version through cuBLAS), ids
equal wherever the reference scores are more than 1e-5 apart, the empty
(-inf, -1) slots identical."""
import numpy as np
import pytest
import torch

from repro_torch.core.types import VALID_TO_OPEN
from repro_torch.kernels.temporal_mask_score import ops as tops
from repro_torch.kernels.temporal_mask_score.plain import (
    temporal_window_topk_plain)
from repro_torch.kernels.topk_search import ops as kops
from repro_torch.kernels.topk_search.plain import topk_search_plain
from repro_torch.testing import topk_agree

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
    ok, err, why = topk_agree(got[0], got[1], want[0], want[1])
    assert ok, why
    return err


@pytest.mark.parametrize("nq,n,d,k", [
    (1, 256, 128, 5), (4, 1000, 384, 10), (8, 512, 64, 3),
    (2, 130, 384, 7), (3, 64, 256, 64), (33, 5000, 384, 10),
    (256, 8191, 384, 64), (2, 8192, 384, 5), (5, 300, 100, 17),
])
def test_topk_kernel_matches_plain(dev, nq, n, d, k):
    q = torch.tensor(_rand((nq, d), 1), device=dev)
    c = torch.tensor(_rand((n, d), 2), device=dev)
    mask = torch.tensor(np.random.default_rng(3).random(n) > 0.3,
                        device=dev)
    before = kops.launches
    got = kops.topk_search(q, c, mask, k)
    assert kops.launches == before + 1
    _agree(got, topk_search_plain(q, c, mask, min(k, n)))


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
    c = torch.tensor(_rand((100, 16), 9), device=dev)
    m = torch.ones(100, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        kops.topk_search(q, c, m, kops.KMAX + 1)
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
    (256, 20000, 384, 10),
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
                                      torch.tensor(t1, device=dev), k)
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
