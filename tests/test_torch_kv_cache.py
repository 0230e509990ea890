"""Port parity for ``serve/kv_cache.py``: repro_torch's ``quantize_kv``,
``dequantize_kv`` and ``KVCacheArena`` on the CPU against repro's, on
the same numpy inputs.

Tolerances: int8 values equal (both round x / scale half to even in
fp32), scales within 1e-7 relative; the arena's slot order, lengths,
contents and byte counts equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv_cache as rk
from repro_torch.serve import kv_cache as pk

SHAPE = (3, 2, 9, 16)                       # (L, KV, S, Dh)


def kv(seed, shape=SHAPE, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_quantize_kv_matches_repro(dtype):
    x = kv(1, scale=3.0)
    x[0, 0, 0] = 0.0                         # an all-zero row: scale floor
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    rq, rs = rk.quantize_kv(jnp.asarray(x).astype(dtype))
    pq, ps = pk.quantize_kv(torch.from_numpy(x).to(tdt))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert ps.shape == SHAPE[:-1] + (1,)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-7,
                               atol=0)
    for out in (jnp.bfloat16, jnp.float32):
        tout = torch.bfloat16 if out == jnp.bfloat16 else torch.float32
        np.testing.assert_array_equal(
            pk.dequantize_kv(pq, ps, tout).float().numpy(),
            _np(rk.dequantize_kv(rq, rs, out)))
    # the round trip is within half a quantization step of each value
    err = (pk.dequantize_kv(pq, ps, torch.float32)
           - torch.from_numpy(x).to(tdt).float()).abs()
    assert bool((err <= ps / 2 * (1 + 1e-6)).all())


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_arena_matches_repro(quantize):
    kw = dict(n_layers=3, n_kv=2, d_head=16, max_seq=12, max_batch=3,
              quantize_int8=quantize)
    ra = rk.KVCacheArena(rk.CacheConfig(**kw))
    pa = pk.KVCacheArena(pk.CacheConfig(**kw), device="cpu")
    assert pa.memory_bytes() == ra.memory_bytes()
    assert pa.k.dtype == (torch.int8 if quantize else torch.bfloat16)
    slots = [(ra.claim(), pa.claim()) for _ in range(3)]
    assert [r for r, _ in slots] == [p for _, p in slots] == [0, 1, 2]
    assert ra.claim() is None and pa.claim() is None
    k1, v1 = kv(2), kv(3)
    k2, v2 = kv(4, (3, 2, 5, 16)), kv(5, (3, 2, 5, 16))
    for arena, conv in ((ra, jnp.asarray), (pa, torch.from_numpy)):
        arena.write_prefill(1, conv(k1), conv(v1))
        arena.write_prefill(2, conv(k2), conv(v2))
        arena.release(0)
        arena.release(2)
    assert list(pa.lengths) == list(ra.lengths) == [0, 9, 0]
    assert pa.active_slots == ra.active_slots == [1]
    assert [pa.claim(), pa.claim()] == [ra.claim(), ra.claim()] == [2, 0]
    for slots in ([1], [2, 1], [0, 1, 2]):
        for got, want in zip(pa.dequantized(slots), ra.dequantized(slots)):
            assert got.shape == tuple(want.shape)
            np.testing.assert_array_equal(got.float().numpy(), _np(want))
    np.testing.assert_array_equal(pa.k.float().numpy(), _np(ra.k))
    if quantize:
        np.testing.assert_allclose(pa.v_scale.numpy(), _np(ra.v_scale),
                                   rtol=1e-7, atol=0)
    assert pa.memory_bytes() == ra.memory_bytes()
