"""Port parity for the attention kernels: repro_torch's flash_attention and
flash_decode on CPU tensors (their plain PyTorch versions) against
repro's Pallas kernels in interpret mode and its jnp oracles, on the same
numpy inputs: the shapes of tests/test_kernels_attention.py, plus head
dim 32 without the causal mask (the embedder's encoder), a fully masked
row, ragged decode caches, split invariance, and the split that
flash_decode chooses for the card when given no bs.

Tolerances: rtol = atol = 2e-5 in fp32 (the packages sum in different
orders); 5e-2 in bf16, as repro's own bf16 test (bf16 keeps ~3 decimal
digits and the packages round at different places)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as repro_fa
from repro.kernels.flash_attention.ref import attention_ref as repro_aref
from repro.kernels.flash_decode.ops import flash_decode as repro_fd
from repro.kernels.flash_decode.ref import decode_attention_ref as repro_dref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.plain import flash_attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.plain import (
    flash_decode_partials_plain, flash_decode_plain, merge_partials)
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.testing import partials_agree, rounding_agree

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal", [
    (1, 4, 4, 128, 128, 64, True),      # MHA causal
    (2, 8, 2, 128, 256, 64, True),      # GQA group=4, prefill vs longer kv
    (1, 4, 1, 256, 256, 32, False),     # MQA bidirectional
    (1, 2, 2, 128, 384, 128, True),     # d=128
    (3, 12, 12, 16, 16, 32, False),     # the embedder's encoder (MiniLM)
    (1, 8, 2, 48, 48, 128, True),       # a short prefill, GQA 4
])
def test_flash_attention_matches_repro(b, h, kv, sq, skv, d, causal):
    q, k, v = (_rand((b, h, sq, d), 1), _rand((b, kv, skv, d), 2),
               _rand((b, kv, skv, d), 3))
    got = fa_ops.flash_attention(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    want = repro_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, mode="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want = repro_aref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(attention_ref(*_t(q, k, v), causal=causal),
                               np.asarray(want), **F32)


def test_flash_attention_bf16():
    q = _rand((1, 4, 128, 64), 1)
    k, v = _rand((1, 2, 128, 64), 2), _rand((1, 2, 128, 64), 3)
    got = fa_ops.flash_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                                 causal=True)
    assert got.dtype == torch.bfloat16
    want = repro_fa(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    causal=True, mode="interpret")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_fully_masked_rows_are_zero():
    """More queries than keys under the causal mask: the first Sq - Skv
    rows see no key. The kernel's function gives 0 there (the oracle
    NaN); the rest agree with the oracle."""
    q, k, v = (_rand((1, 2, 64, 32), 4), _rand((1, 2, 40, 32), 5),
               _rand((1, 2, 40, 32), 6))
    got = fa_ops.flash_attention(*_t(q, k, v), causal=True).numpy()
    assert np.all(got[:, :, :24] == 0.0)
    want = np.asarray(repro_fa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, bq=64, bk=40,
                               mode="interpret"))
    np.testing.assert_allclose(got, want, **F32)
    ref = attention_ref(*_t(q, k, v), causal=True).numpy()
    assert np.all(np.isnan(ref[:, :, :24]))
    np.testing.assert_allclose(got[:, :, 24:], ref[:, :, 24:], **F32)


def test_flash_attention_cpu_path_is_plain_and_counts_no_launch():
    q, k, v = _t(_rand((2, 4, 32, 32), 7), _rand((2, 2, 32, 32), 8),
                 _rand((2, 2, 32, 32), 9))
    before = fa_ops.launches
    a = fa_ops.flash_attention(q, k, v, causal=True)
    assert fa_ops.launches == before
    assert torch.equal(a, flash_attention_plain(q, k, v, True))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k[:, :, :, :16], v, causal=True)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1),
                               v[:, :1].repeat(1, 3, 1, 1))   # 4 % 3
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), v)


@pytest.mark.parametrize("b,h,kv,s,d,bs,cache_len", [
    (1, 4, 4, 512, 64, 256, None),       # full cache
    (2, 8, 2, 1024, 64, 256, 700),       # partial cache, GQA
    (1, 4, 1, 512, 128, 512, 512),       # MQA single split
    (1, 2, 2, 2048, 32, 256, 1),         # single valid token
    (1, 32, 8, 320, 128, 512, 257),      # the engine's cache, one split
])
def test_flash_decode_matches_repro(b, h, kv, s, d, bs, cache_len):
    q, kc, vc = (_rand((b, h, d), 1), _rand((b, kv, s, d), 2),
                 _rand((b, kv, s, d), 3))
    cl = s if cache_len is None else cache_len
    got = fd_ops.flash_decode(*_t(q, kc, vc), cache_len=cache_len, bs=bs)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    want = np.asarray(repro_fd(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), cache_len=cl, bs=bs,
                               mode="interpret"))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    want = np.asarray(repro_dref(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc),
                                 cache_len=jnp.full((b,), cl, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        decode_attention_ref(*_t(q, kc, vc), cache_len=torch.full((b,), cl)),
        want, **F32)


@pytest.mark.parametrize("s,bs,cache_len", [
    (1088, 512, 1088), (1088, 512, 1000), (700, 256, 513), (300, 128, 1),
])
def test_flash_decode_ragged_cache(s, bs, cache_len):
    """S not a multiple of bs (repro's Pallas wrapper asserts S % bs ==
    0; the port's last split is ragged), held against repro's oracle."""
    q, kc, vc = (_rand((2, 8, 64), 10), _rand((2, 2, s, 64), 11),
                 _rand((2, 2, s, 64), 12))
    got = fd_ops.flash_decode(*_t(q, kc, vc), cache_len=cache_len, bs=bs)
    want = np.asarray(repro_dref(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc),
                                 cache_len=jnp.full((2,), cache_len,
                                                    jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    m, l, acc = flash_decode_partials_plain(*_t(q, kc, vc), cache_len, bs)
    ns = -(-s // bs)
    assert m.shape == (2, 8, ns) and acc.shape == (2, 8, ns, 64)
    dead = np.arange(ns) * bs >= cache_len          # splits past the prefix
    assert np.all(np.isneginf(m.numpy()[:, :, dead]))
    assert np.all(l.numpy()[:, :, dead] == 0) and np.all(
        acc.numpy()[:, :, dead] == 0)


def test_flash_decode_split_invariance():
    """Split count must not change the result (merge correctness)."""
    q, kc, vc = _t(_rand((1, 4, 64), 1), _rand((1, 4, 1024, 64), 2),
                   _rand((1, 4, 1024, 64), 3))
    outs = [fd_ops.flash_decode(q, kc, vc, cache_len=900, bs=bs).numpy()
            for bs in (128, 256, 1024, 300)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-5)


def test_flash_decode_bf16():
    q, kc, vc = _rand((1, 8, 128), 1), _rand((1, 2, 512, 128), 2), \
        _rand((1, 2, 512, 128), 3)
    got = fd_ops.flash_decode(*[x.to(torch.bfloat16) for x in _t(q, kc, vc)],
                              cache_len=400, bs=256)
    assert got.dtype == torch.bfloat16
    want = repro_fd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc)),
                    cache_len=400, bs=256, mode="interpret")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_decode_matches_flash_attention_last_token():
    """Consistency across kernels: decode(q_last) == attention last row."""
    b, h, s, d = 1, 2, 256, 64
    k, v = _t(_rand((b, h, s, d), 5), _rand((b, h, s, d), 6))
    q_full = torch.from_numpy(_rand((b, h, s, d), 7))
    full = fa_ops.flash_attention(q_full, k, v, causal=True)
    dec = fd_ops.flash_decode(q_full[:, :, -1].contiguous(), k, v,
                              cache_len=s, bs=128)
    np.testing.assert_allclose(dec.numpy(), full[:, :, -1].numpy(), **F32)


def test_flash_decode_cpu_path_is_plain_and_checks_inputs():
    q, kc, vc = _t(_rand((1, 4, 32), 13), _rand((1, 2, 100, 32), 14),
                   _rand((1, 2, 100, 32), 15))
    before = fd_ops.launches
    a = fd_ops.flash_decode(q, kc, vc, cache_len=77, bs=32)
    assert fd_ops.launches == before
    assert torch.equal(a, flash_decode_plain(q, kc, vc, 77, 32))
    with pytest.raises(ValueError):
        fd_ops.flash_decode(q, kc, vc, cache_len=101)
    with pytest.raises(ValueError):
        fd_ops.flash_decode(q[:, :3], kc, vc)
    with pytest.raises(TypeError):
        fd_ops.flash_decode(q, kc.to(torch.bfloat16), vc)


def test_flash_decode_partials_cpu_path_is_plain():
    q, kc, vc = _t(_rand((2, 8, 64), 16), _rand((2, 2, 700, 64), 17),
                   _rand((2, 2, 700, 64), 18))
    before = fd_ops.launches
    got = fd_ops.flash_decode_partials(q, kc, vc, 600, 256)
    assert fd_ops.launches == before
    for a, b in zip(got, flash_decode_partials_plain(q, kc, vc, 600, 256)):
        assert torch.equal(a, b)
    assert torch.equal(merge_partials(*got).to(q.dtype),
                       fd_ops.flash_decode(q, kc, vc, 600, 256))


@pytest.mark.parametrize("kv", [1, 2, 8, 32])
@pytest.mark.parametrize("cache_len", [0, 1, 15, 16, 17, 271, 4096, 32768])
@pytest.mark.parametrize("sms", [1, 132])
def test_choose_split_fills_the_card(kv, cache_len, sms):
    """The card's default split (``bs=None``): whole ring tiles, no split
    wholly past cache_len, >= 2 blocks an SM for one sequence wherever
    the valid prefix has that many tiles, and no dependence on B (the
    function is not given it)."""
    tile = fd_ops.SPLIT_TILE
    bs = fd_ops.choose_split(kv, cache_len, sms)
    assert bs >= tile and bs % tile == 0
    ns = max(1, -(-cache_len // bs))
    assert cache_len == 0 or (ns - 1) * bs < cache_len   # each split valid
    tiles = -(-cache_len // tile)
    assert kv * ns >= min(2 * sms, kv * tiles)
    if cache_len >= tile * -(-2 * sms // kv):
        assert kv * ns >= 2 * sms


@pytest.mark.parametrize("b,h,kv,s,d,cache_len", [
    (2, 32, 8, 320, 128, 271), (3, 8, 2, 1088, 64, 1000),
    (1, 4, 4, 700, 32, 1), (2, 4, 1, 2048, 64, 2048),
])
def test_flash_decode_default_split_matches_repro(b, h, kv, s, d,
                                                  cache_len):
    """``bs=None`` on the CPU takes repro's 512 and matches repro's
    oracle."""
    q, kc, vc = (_rand((b, h, d), 25), _rand((b, kv, s, d), 26),
                 _rand((b, kv, s, d), 27))
    got = fd_ops.flash_decode(*_t(q, kc, vc), cache_len=cache_len)
    assert torch.equal(got, flash_decode_plain(*_t(q, kc, vc), cache_len,
                                               min(512, s)))
    want = np.asarray(repro_dref(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc),
                                 cache_len=jnp.full((b,), cache_len,
                                                    jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _decode_bf16(cache_len, s=16384):
    q, kc, vc = (torch.from_numpy(x).to(torch.bfloat16) for x in (
        _rand((2, 8, 128), 19), _rand((2, 2, s, 128), 20),
        _rand((2, 2, s, 128), 21)))
    return q, kc, vc, flash_decode_plain(q, kc, vc, cache_len, 512)


@pytest.mark.parametrize("fault", ["one rounding step", "ignores cache_len",
                                   "drops a split"])
def test_rounding_agree_scales_to_the_values(fault):
    """The card's bf16 check: one rounding step of each output passes;
    a decode that reads past cache_len or loses one of 32 splits fails,
    although its error stays under a fixed 2e-2 (the outputs of N(0, 1)
    inputs are ~0.01)."""
    q, kc, vc, want = _decode_bf16(16200)
    if fault == "one rounding step":
        up = want.float().abs() * (1 + 2 ** -8)       # next bf16 up or same
        got = (torch.sign(want.float()) * up).to(torch.bfloat16)
        assert not torch.equal(got, want)
    elif fault == "ignores cache_len":
        got = flash_decode_plain(q, kc, vc, 16384, 512)
    else:
        m, l, acc = flash_decode_partials_plain(q, kc, vc, 16200, 512)
        l, acc = l.clone(), acc.clone()
        l[..., 3], acc[..., 3, :] = 0, 0
        got = merge_partials(m, l, acc).to(torch.bfloat16)
    assert float((got.float() - want.float()).abs().max()) < 2e-2
    ok, ratio = rounding_agree(got, want, 2 ** -7)
    assert ok == (fault == "one rounding step"), ratio


def test_partials_agree_holds_each_split():
    q, kc, vc = _t(_rand((1, 4, 64), 22), _rand((1, 2, 1000, 64), 23),
                   _rand((1, 2, 1000, 64), 24))
    want = flash_decode_partials_plain(q, kc, vc, 700, 128)
    assert partials_agree(want, want)[0]
    near = (want[0], want[1] * (1 + 1e-6), want[2] * (1 + 1e-6))
    assert partials_agree(near, want)[0]
    ok, _, why = partials_agree(
        flash_decode_partials_plain(q, kc, vc, 1000, 128), want)
    assert not ok and "empty splits" in why            # past cache_len
    ok, _, why = partials_agree(
        flash_decode_partials_plain(q, kc, vc, 650, 128), want)
    assert not ok                                      # a ragged split short
    acc = want[2].clone()
    acc[0, 1, 2, 5] *= 1.01
    assert not partials_agree((want[0], want[1], acc), want)[0]


# ---------------------------------------------------------------------------
# backward: the plain backward (the CPU path of flash_attention_bwd and of
# flash_attention's autograd) against jax.grad of repro's references
# ---------------------------------------------------------------------------
BWD_SHAPES = [
    (1, 4, 4, 64, 64, 32, True),        # MHA causal
    (2, 8, 2, 48, 96, 64, True),        # GQA 4, queries the last 48 keys
    (1, 4, 1, 64, 64, 32, False),       # MQA bidirectional
    (1, 2, 2, 32, 128, 128, True),      # D 128
]


def _jax_grads(fn, q, k, v, g):
    import jax
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal", BWD_SHAPES)
def test_plain_backward_matches_jax_grad(b, h, kv, sq, skv, d, causal):
    """dq, dk, dv of the plain backward (from the plain forward's o and
    lse) against jax.vjp of repro's attention_ref and chunked_attention,
    within 2e-5 (fp32); the same through torch.autograd of
    ``flash_attention``."""
    from repro.models.layers import chunked_attention as repro_chunked
    q, k, v = (_rand((b, h, sq, d), 11), _rand((b, kv, skv, d), 12),
               _rand((b, kv, skv, d), 13))
    g = _rand((b, h, sq, d), 14)
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = fa_ops.flash_attention_with_lse(tq, tk, tv, causal)
    got = fa_ops.flash_attention_bwd(tq, tk, tv, o, tg, lse, causal)
    for ref in (lambda a, b_, c: repro_aref(a, b_, c, causal=causal),
                lambda a, b_, c: repro_chunked(a, b_, c, causal=causal,
                                               chunk=32)):
        want = _jax_grads(ref, q, k, v, g)
        for x, w in zip(got, want):
            np.testing.assert_allclose(x.numpy(), w, **F32)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = fa_ops.flash_attention(*leaves, causal=causal)
    assert torch.equal(out.detach(), o)        # the lse changes no bit
    out.backward(tg)
    for leaf, x in zip(leaves, got):
        assert torch.equal(leaf.grad, x)


def test_lse_is_the_rows_logsumexp():
    q, k, v = _rand((1, 4, 40, 32), 21), _rand((1, 2, 64, 32), 22), \
        _rand((1, 2, 64, 32), 23)
    tq, tk, tv = _t(q, k, v)
    o, lse = fa_ops.flash_attention_with_lse(tq, tk, tv, True)
    assert torch.equal(o, fa_ops.flash_attention(tq, tk, tv, True))
    s = torch.einsum("bhqd,bhkd->bhqk", tq * 32 ** -0.5,
                     torch.repeat_interleave(tk, 2, dim=1))
    rows = torch.arange(40)[:, None] + 24
    s = s.masked_fill(~(rows >= torch.arange(64)[None]), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               **F32)


def test_empty_rows_have_zero_gradient():
    """Causal with Sq > Skv: the first Sq - Skv rows see no key. Their
    lse is -inf, and their gradients, and their share of dk and dv, are
    0, never NaN; the other rows' gradients are those of jax.vjp of
    repro's chunked attention (which also gives 0 there)."""
    from repro.models.layers import chunked_attention as repro_chunked
    b, h, kv, sq, skv, d = 1, 4, 2, 80, 48, 64
    q, k, v = (_rand((b, h, sq, d), 31), _rand((b, kv, skv, d), 32),
               _rand((b, kv, skv, d), 33))
    g = _rand((b, h, sq, d), 34)
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = fa_ops.flash_attention_with_lse(tq, tk, tv, True)
    assert bool(torch.isneginf(lse[:, :, :sq - skv]).all())
    assert bool(torch.isfinite(lse[:, :, sq - skv:]).all())
    dq, dk, dv = fa_ops.flash_attention_bwd(tq, tk, tv, o, tg, lse, True)
    for x in (dq, dk, dv):
        assert bool(torch.isfinite(x).all())
    assert float(dq[:, :, :sq - skv].abs().max()) == 0.0
    want = _jax_grads(lambda a, b_, c: repro_chunked(a, b_, c, chunk=48),
                      q, k, v, g)
    for x, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(x.numpy(), w, **F32)


def test_bf16_backward_is_the_fp32_one_rounded():
    """bf16 inputs: the plain backward computes in fp32 and rounds once,
    so it equals the fp32 backward on the same (bf16-exact) values,
    rounded."""
    b, h, kv, sq, skv, d = 1, 4, 2, 32, 32, 64
    x = [torch.from_numpy(_rand(s, 40 + i)).to(torch.bfloat16)
         for i, s in enumerate([(b, h, sq, d), (b, kv, skv, d),
                                (b, kv, skv, d), (b, h, sq, d)])]
    o, lse = fa_ops.flash_attention_with_lse(*x[:3], True)
    got = fa_ops.flash_attention_bwd(*x[:3], o, x[3], lse, True)
    want = fa_ops.flash_attention_bwd(*(t.float() for t in x[:3]),
                                      o.float(), x[3].float(), lse, True)
    for gt, w in zip(got, want):
        assert gt.dtype == torch.bfloat16
        assert torch.equal(gt, w.to(torch.bfloat16))


@pytest.mark.parametrize("causal", [True, False])
def test_o_rounding_bound_covers_a_step_of_o(causal):
    """The plain backward on o moved by one bf16 step in each element (up
    or down at random) stays within ``o_rounding_bound`` of the backward
    on o (fp32 sums of bf16 values; plus 1e-6 of each tensor's largest
    for the sums' own rounding), and dv does not move beyond that."""
    from repro_torch.kernels.flash_attention.plain import (
        flash_attention_bwd_plain, flash_attention_plain, o_rounding_bound)
    b, h, kv, sq, skv, d = 1, 4, 2, 64, 64, 32
    x = [torch.from_numpy(_rand(s, 50 + i)).to(torch.bfloat16).float()
         for i, s in enumerate([(b, h, sq, d), (b, kv, skv, d),
                                (b, kv, skv, d), (b, h, sq, d)])]
    q, k, v, do = x
    o, lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    o16 = o.to(torch.bfloat16)
    step = torch.from_numpy(np.random.default_rng(5).choice(
        [-1, 1], o.shape).astype(np.int16))
    moved = (o16.view(torch.int16) + step).view(torch.bfloat16)
    base = flash_attention_bwd_plain(q, k, v, o16.float(), do, lse, causal)
    alt = flash_attention_bwd_plain(q, k, v, moved.float(), do, lse, causal)
    bound = o_rounding_bound(q, k, v, o16.float(), do, lse, causal)
    for x0, x1, e in zip(base, alt, bound):
        assert e.shape == x0.shape and e.dtype == torch.float32
        lim = e + 1e-6 * float(x0.abs().max())
        assert bool(((x1 - x0).abs() <= lim).all())
    assert float((alt[0] - base[0]).abs().max()) > 0


# ---------------------------------------------------------------------------
# the rounding design of the bf16 backward on the tensor cores
# ---------------------------------------------------------------------------
def _tensor_core_backward(q, k, v, o, do, lse, causal, split):
    """The bf16 tensor-core backward's rounding points, emulated in fp32:
    S = q k^T and dP = dO V^T summed in fp32 from the bf16 inputs; P =
    2^(S scale log2(e) - lse log2(e)) and dS = P (dP - Delta) in fp32;
    P and dS then enter the products in bf16, as hi + lo (``split``: two
    bf16 terms whose sum is the fp32 value to ~2^-17) or rounded once;
    dV = P^T dO, dK = scale dS^T Q and dQ = scale dS K summed in fp32 and
    rounded once to bf16."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    scale, log2e = d ** -0.5, 1.4426950408889634
    qf = q.float().reshape(b, kv, g, sq, d)
    dof = do.float().reshape(b, kv, g, sq, d)
    lse5 = lse.reshape(b, kv, g, sq, 1)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k.float())
    p = torch.exp2(s * (scale * log2e) - lse5 * log2e)
    seen = ~torch.isneginf(lse5).expand_as(p)
    if causal:
        rows = torch.arange(sq)[:, None] + (skv - sq)
        seen = seen & (rows >= torch.arange(skv)[None])
    p = torch.where(seen, p, 0.0)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", dof, v.float())
    delta = (dof * o.float().reshape(b, kv, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (dp - delta)

    def to_bf16(x):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if split else hi

    p, ds = to_bf16(p), to_bf16(ds)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dof)
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qf) * scale
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, k.float()) * scale
    return tuple(x.to(torch.bfloat16)
                 for x in (dq.reshape(b, h, sq, d), dk, dv))


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal", [
    (1, 4, 2, 256, 256, 64, True),      # GQA 2, causal
    (1, 4, 2, 256, 256, 128, False),    # D 128, bidirectional
    (1, 6, 1, 200, 136, 128, True),     # GQA 6, Sq > Skv, ragged tiles
    (1, 10, 2, 100, 300, 64, True),     # GQA 5, queries the last 100 keys
    (2, 4, 4, 130, 70, 64, True),       # 60 rows a head that see no key
])
def test_bf16_backward_needs_p_and_ds_split(b, h, kv, sq, skv, d, causal):
    """The bf16 backward on the tensor cores holds ``grads_agree``'s bf16
    rule against the plain backward only with P and dS each split into
    bf16 hi + lo: rounded once to bf16, the same products miss the rule
    (by ~15-30x at these shapes)."""
    from repro_torch.kernels.flash_attention.plain import (
        flash_attention_bwd_plain)
    from repro_torch.testing import grads_agree
    x = [torch.from_numpy(_rand(s, 60 + i)).to(torch.bfloat16)
         for i, s in enumerate([(b, h, sq, d), (b, kv, skv, d),
                                (b, kv, skv, d), (b, h, sq, d)])]
    q, k, v, do = x
    o, lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
    split = _tensor_core_backward(q, k, v, o, do, lse, causal, True)
    once = _tensor_core_backward(q, k, v, o, do, lse, causal, False)
    for name, got_split, got_once, w in zip(("dq", "dk", "dv"), split, once,
                                            want):
        ok, ratio = grads_agree(got_split, w, True)
        assert ok, f"{name} with P, dS split: {ratio:.3g} x its limit"
        ok, ratio = grads_agree(got_once, w, True)
        assert not ok and ratio > 4, \
            f"{name} with P, dS rounded once: {ratio:.3g} x its limit"
    if causal and sq > skv:
        assert float(split[0][:, :, :sq - skv].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the rounding design of the fp32 bodies on the tensor cores (3xTF32)
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _tf32(x):
    """x rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` does: add half a unit of the 13 bits
    dropped to the bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tc_product(eq, a, b, three):
    """A product on the tensor cores in tf32, emulated in fp32: each
    operand split as hi = tf32(x), lo = tf32(x - hi), and a b summed as
    a_lo b_hi + a_hi b_lo + a_hi b_hi (``three``, the kernels' 3xTF32),
    or one product of the operands rounded to tf32."""
    if not three:
        return torch.einsum(eq, _tf32(a), _tf32(b))
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _visible(sq, skv, causal):
    if not causal:
        return torch.ones(sq, skv, dtype=torch.bool)
    return torch.arange(sq)[:, None] + (skv - sq) >= torch.arange(skv)[None]


def _tf32_forward(q, k, v, causal, three):
    """The fp32 forward on the tensor cores (``fa_tf32_kernel``): S = q k^T
    and O = P V as tensor-core products, the softmax in fp32 in base 2 on
    S times scale * log2(e); returns (o, lse)."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    qf = q.reshape(b, kv, h // kv, sq, d)
    s = _tc_product("bkgqd,bkcd->bkgqc", qf, k, three) * (d ** -0.5 * LOG2E)
    s = s.masked_fill(~_visible(sq, skv, causal), float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = _tc_product("bkgqc,bkcd->bkgqd", p, v, three) / torch.where(
        l == 0, 1.0, l)
    lse = torch.where(l == 0, float("-inf"), (m + torch.log2(l)) / LOG2E)
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _tf32_backward(q, k, v, o, do, lse, causal, three):
    """The fp32 backward on the tensor cores (``bwd_tf32``): S = q k^T and
    dP = dO V^T as tensor-core products, P = 2^(S scale log2(e) - lse
    log2(e)) and dS = P (dP - Delta) in fp32, then dV = P^T dO, dK = scale
    dS^T q and dQ = scale dS K as tensor-core products."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g, scale = h // kv, d ** -0.5
    qf = q.reshape(b, kv, g, sq, d)
    dof = do.reshape(b, kv, g, sq, d)
    lse5 = lse.reshape(b, kv, g, sq, 1)
    s = _tc_product("bkgqd,bkcd->bkgqc", qf, k, three)
    dp = _tc_product("bkgqd,bkcd->bkgqc", dof, v, three)
    lse2 = torch.where(torch.isneginf(lse5), float("inf"), lse5 * LOG2E)
    p = torch.exp2(s * (scale * LOG2E) - lse2)
    p = torch.where(_visible(sq, skv, causal), p, 0.0)
    delta = (dof * o.reshape(b, kv, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dv = _tc_product("bkgqc,bkgqd->bkcd", p, dof, three)
    dk = _tc_product("bkgqc,bkgqd->bkcd", ds, qf, three) * scale
    dq = _tc_product("bkgqc,bkcd->bkgqd", ds, k, three) * scale
    return dq.reshape(b, h, sq, d), dk, dv


def test_tf32_rounding_is_the_cards():
    """The emulation rounds as ``cvt.rna.tf32.f32``: to 10 mantissa bits,
    ties away from zero, and hi + lo holds x to 2^-22 of |x|."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.14159265])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, 3.140625])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(_rand((4096,), 3))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert bool(((y - hi - lo).abs() <= 2.0 ** -22 * y.abs()).all())


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal", [
    (2, 2, 2, 200, 200, 32, False),     # BERT4Rec serve_p99 / train, cut
    (2, 12, 12, 128, 128, 32, False),   # MiniLM encode, cut
    (1, 8, 2, 100, 300, 32, True),      # GQA 4, causal, ragged tiles
    (1, 4, 2, 100, 40, 64, True),       # D 64, 60 rows that see no key
])
def test_fp32_forward_needs_three_tf32_products(b, h, kv, sq, skv, d,
                                                causal):
    """The fp32 forward on the tensor cores holds the card's fp32 rule
    against ``flash_attention_plain`` (max abs error <= 1e-4 and each
    output within 1e-4 of its value plus 1e-4 of its row's largest, lse
    by ``lse_agree``) with every product as three tf32 products (3xTF32);
    one tf32 product misses it (by ~6-12x at these shapes). The 3xTF32
    output also agrees with repro's reference."""
    from repro_torch.testing import lse_agree
    q, k, v = _rand((b, h, sq, d), 70), _rand((b, kv, skv, d), 71), \
        _rand((b, kv, skv, d), 72)
    tq, tk, tv = _t(q, k, v)
    want, lse_p = flash_attention_plain(tq, tk, tv, causal, return_lse=True)
    three, lse3 = _tf32_forward(tq, tk, tv, causal, True)
    one, lse1 = _tf32_forward(tq, tk, tv, causal, False)
    assert float((three - want).abs().max()) <= 1e-4
    ok, ratio = rounding_agree(three, want, 1e-4)
    assert ok, f"3xTF32: {ratio:.3g} x its limit"
    ok, ratio = lse_agree(lse3, lse_p)
    assert ok, f"3xTF32 lse: {ratio:.3g} x its limit"
    ok, ratio = rounding_agree(one, want, 1e-4)
    assert not ok and ratio > 4, f"one tf32 product: {ratio:.3g} x its limit"
    assert not lse_agree(lse1, lse_p)[0]
    if causal and sq > skv:
        assert float(three[:, :, :sq - skv].abs().max()) == 0.0
        assert bool(torch.isneginf(lse3[:, :, :sq - skv]).all())
    else:
        ref = np.asarray(repro_aref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
        np.testing.assert_allclose(three.numpy(), ref, **F32)


@pytest.mark.parametrize("b,h,kv,sq,skv,causal", [
    (2, 2, 2, 200, 200, False),         # BERT4Rec train, cut
    (2, 12, 12, 128, 128, False),       # MiniLM, cut
    (1, 8, 2, 100, 300, True),          # GQA 4, causal, ragged tiles
    (1, 4, 2, 100, 40, True),           # 60 rows that see no key
])
def test_fp32_backward_needs_three_tf32_products(b, h, kv, sq, skv, causal):
    """The fp32 backward on the tensor cores holds ``grads_agree``'s fp32
    rule (1e-4 of each gradient's largest) against the plain backward
    only with every product as three tf32 products: one tf32 product
    misses it (by ~5-9x at these shapes)."""
    from repro_torch.kernels.flash_attention.plain import (
        flash_attention_bwd_plain)
    from repro_torch.testing import grads_agree
    d = 32
    x = _t(*(_rand(s, 80 + i) for i, s in enumerate(
        [(b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d), (b, h, sq, d)])))
    q, k, v, do = x
    o, lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
    three = _tf32_backward(q, k, v, o, do, lse, causal, True)
    one = _tf32_backward(q, k, v, o, do, lse, causal, False)
    for name, got3, got1, w in zip(("dq", "dk", "dv"), three, one, want):
        ok, ratio = grads_agree(got3, w, False)
        assert ok, f"{name} in 3xTF32: {ratio:.3g} x its limit"
        ok, ratio = grads_agree(got1, w, False)
        assert not ok and ratio > 2, \
            f"{name} with one tf32 product: {ratio:.3g} x its limit"
    if causal and sq > skv:
        assert float(three[0][:, :, :sq - skv].abs().max()) == 0.0
