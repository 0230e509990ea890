"""Port parity for the MoE layer: repro_torch's ``models/moe.py`` on the
CPU against repro's, with repro's params carried across as numpy arrays,
on the same numpy inputs.

Tolerances: rtol = atol = 1e-4 in fp32 (XLA and torch sum the expert
GEMMs in different orders). The dropped (token, expert) assignments are
compared exactly: routing runs in fp32 on the same inputs and both
packages sort the assignments stably. In bf16 both packages round the
expert GEMMs, the gated activation and every partial sum of the combine
to bf16, at points that differ (XLA keeps fused elementwise chains in
fp32): a one-rounding rule (``rounding_agree`` at 2**-7 and 1e-4 of the
row's largest) measured 15-60x over its limit here, so bf16 outputs are
held to one rounding step of each value plus 2**-5 of the row's
largest (``BF16``), and the tight check is the fp32 one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rm
from repro_torch.models import moe as pm
from repro_torch.testing import rounding_agree

TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rel=2 ** -7, slack=2 ** -5)


def configs(**kw):
    """The same MoE config in both packages: (repro's, the port's)."""
    args = {**dict(n_experts=8, top_k=2, d_ff=32), **kw}
    return rm.MoEConfig(**args), pm.MoEConfig(**args)


def params(rcfg, d, seed=0, dtype=jnp.float32):
    """repro's seeded params and the port's copy of them (router fp32,
    experts in ``dtype``)."""
    rp = rm.moe_params(jax.random.PRNGKey(seed), d, rcfg, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else tdt) for k, v in rp.items()}
    return rp, pp


def inputs(shape, seed, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(tdt)


def repro_drops(rp, x, cfg, dropless=False) -> np.ndarray:
    """The (token, expert) pairs repro's ``moe_block`` drops, by its own
    routing and dispatch arithmetic (repro/models/moe.py:97-123)."""
    t, k, e = x.shape[0] * x.shape[1], cfg.top_k, cfg.n_experts
    xf = x.reshape(t, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32),
                                      rp["router"]), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    e_pad = rp["w_in"].shape[0]
    if dropless:
        cap = t * k
    else:
        cap = int(max(1, -(-t * k // e) * cfg.capacity_factor))
        cap = int(-(-cap // 8) * 8)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = jnp.take(flat_e, order)
    counts = jnp.bincount(flat_e, length=e_pad)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(t * k) - jnp.take(starts, sorted_e)
    drop = np.asarray(pos >= cap)
    pairs = np.stack([np.asarray(order // k), np.asarray(sorted_e)], 1)[drop]
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity",
                                                         "dropless"])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
def test_moe_block_matches_repro(act, n_shared, dropless):
    rcfg, pcfg = configs(act=act, n_shared=n_shared)
    rp, pp = params(rcfg, 64, seed=1)
    xr, xp = inputs((2, 24, 64), 2)
    want, waux = rm.moe_block(rp, xr, rcfg, dropless=dropless)
    got, gaux = pm.moe_block(pp, xp, pcfg, dropless=dropless)
    assert got.shape == (2, 24, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(
        pm.dropped_pairs(pp, xp, pcfg, dropless).numpy(),
        repro_drops(rp, xr, rcfg, dropless))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_capacity_drops_match_repro(dtype):
    """A router column scaled up sends most tokens to expert 3, past its
    capacity: the same assignments drop in both packages."""
    rcfg, pcfg = configs(n_shared=1, capacity_factor=1.0)
    rp, pp = params(rcfg, 64, seed=3, dtype=dtype)
    rp["router"] = rp["router"].at[:, 3].multiply(6.0)
    pp["router"][:, 3] *= 6.0
    xr, xp = inputs((4, 32, 64), 4, dtype)
    drops = pm.dropped_pairs(pp, xp, pcfg).numpy()
    assert len(drops) > 0 and (drops[:, 1] == 3).any()
    np.testing.assert_array_equal(drops, repro_drops(rp, xr, rcfg))
    want, _ = rm.moe_block(rp, xr, rcfg)
    got, _ = pm.moe_block(pp, xp, pcfg)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == jnp.float32:
        np.testing.assert_allclose(_np(got), want.numpy(), **TOL)
    else:
        ok, ratio = rounding_agree(got, want, **BF16)
        assert ok, ratio
    # a dropped assignment contributes nothing: the dropless output differs
    # exactly at the tokens that lost one
    full, _ = pm.moe_block(pp, xp, pcfg, dropless=True)
    changed = (full != got).reshape(-1, 64).any(-1).nonzero()[:, 0]
    np.testing.assert_array_equal(changed.numpy(), np.unique(drops[:, 0]))


def test_router_tie_ranks_the_lower_expert_first():
    """Experts 2 and 5 get the same router column, so every token's
    probabilities tie between them; made the largest, the tie sits at the
    top-1 boundary. lax.top_k keeps expert 2, and so must the port."""
    rcfg, pcfg = configs(top_k=1, n_shared=0)
    rp, pp = params(rcfg, 64, seed=5)
    col = np.abs(np.asarray(rp["router"][:, 2])) * 4.0
    router = np.asarray(rp["router"]).copy()
    router[:, 2] = router[:, 5] = col
    rp["router"] = jnp.asarray(router)
    pp["router"] = torch.from_numpy(router)
    xr, xp = inputs((1, 16, 64), 6)
    xr, xp = jnp.abs(xr), xp.abs()            # x . col > 0: 2 and 5 lead
    probs = torch.softmax(xp @ pp["router"], -1)[0]
    assert torch.equal(probs[:, 2], probs[:, 5])
    _, top_e = pm._top_k(probs, 1)
    assert (top_e == 2).all()
    _, r_top = jax.lax.top_k(jax.nn.softmax(xr[0] @ rp["router"]), 1)
    assert (np.asarray(r_top) == 2).all()
    want, _ = rm.moe_block(rp, xr, rcfg, dropless=True)
    got, _ = pm.moe_block(pp, xp, pcfg, dropless=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # and a tie inside the top-k keeps the descending-prob, lower-id order
    w, ids = pm._top_k(torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1]]), 4)
    assert ids.tolist() == [[1, 2, 3, 0]]
    assert w[0].tolist() == pytest.approx([0.3, 0.3, 0.2, 0.1])


@pytest.mark.parametrize("act,n_shared", [("swiglu", 1), ("gelu", 0),
                                          ("sq_relu", 1)])
def test_dense_ref_matches_repro(act, n_shared):
    rcfg, pcfg = configs(act=act, n_shared=n_shared)
    rp, pp = params(rcfg, 64, seed=7)
    xr, xp = inputs((2, 10, 64), 8)
    want = rm.moe_block_dense_ref(rp, xr, rcfg)
    got = pm.moe_block_dense_ref(pp, xp, pcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # and dispatch without drops equals the dense oracle
    out, _ = pm.moe_block(pp, xp, pcfg, dropless=True)
    np.testing.assert_allclose(_np(out), _np(got), **TOL)


def test_padded_experts_are_never_routed():
    """6 experts pad to 16; the 10 dead experts get NaN weights, which
    would poison any token routed to them."""
    rcfg, pcfg = configs(n_experts=6, top_k=3, n_shared=1)
    rp, pp = params(rcfg, 64, seed=9)
    assert pp["w_in"].shape[0] == pm.padded_experts(6) == 16
    assert pp["router"].shape == (64, 6)
    xr, xp = inputs((3, 40, 64), 10)
    for dropless in (False, True):
        clean, _ = pm.moe_block(pp, xp, pcfg, dropless=dropless)
        poisoned = dict(pp, w_in=pp["w_in"].clone(),
                        w_out=pp["w_out"].clone())
        poisoned["w_in"][6:] = float("nan")
        poisoned["w_out"][6:] = float("nan")
        got, _ = pm.moe_block(poisoned, xp, pcfg, dropless=dropless)
        assert torch.equal(got, clean)
        want, _ = rm.moe_block(rp, xr, rcfg, dropless=dropless)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_moe_block_is_batch_invariant_bitwise(dtype):
    """Two runs give the same bits, and so does a token alone or inside a
    batch of 300 (3 row blocks): the GEMMs run in fixed-shape blocks and
    the combine sums in a fixed order, without atomics."""
    cfg = pm.MoEConfig(n_experts=60, top_k=4, d_ff=64, n_shared=4)
    gen = torch.Generator().manual_seed(11)
    p = pm.moe_params(gen, 128, cfg, dtype, "cpu")
    x = torch.randn((1, 300, 128), generator=gen).to(dtype)
    out, _ = pm.moe_block(p, x, cfg, dropless=True)
    again, _ = pm.moe_block(p, x, cfg, dropless=True)
    assert torch.equal(out, again)
    for i in (0, 1, 127, 128, 200, 299):
        alone, _ = pm.moe_block(p, x[:, i:i + 1], cfg, dropless=True)
        assert torch.equal(alone[0, 0], out[0, i]), i
    part, _ = pm.moe_block(p, x[:, 40:170], cfg, dropless=True)
    assert torch.equal(part, out[:, 40:170])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_blocked_gemm_gives_each_row_the_same_bits(dtype):
    """``_by_rows`` (one batched GEMM over zero-padded 128-row blocks)
    gives a row the same bits whatever the count of rows around it, and
    agrees with one unblocked product within the dtype's rounding."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((5 * pm.ROWS, 96), generator=gen).to(dtype)
    w = torch.randn((96, 40), generator=gen).to(dtype)
    full = pm._by_rows(x, w)
    assert full.shape == (5 * pm.ROWS, 40)
    for n in (1, 7, pm.ROWS, pm.ROWS + 1, 3 * pm.ROWS - 2, 5 * pm.ROWS):
        assert torch.equal(pm._by_rows(x[:n], w), full[:n]), n
    ok, ratio = rounding_agree(full, (x.float() @ w.float()).to(dtype),
                               1e-5 if dtype == torch.float32 else 2 ** -7)
    assert ok, ratio


def test_moe_params_are_seeded_and_shaped():
    cfg = pm.MoEConfig(n_experts=60, top_k=4, d_ff=48, n_shared=2)
    a = pm.moe_params(torch.Generator().manual_seed(1), 32, cfg,
                      torch.bfloat16, "cpu")
    b = pm.moe_params(torch.Generator().manual_seed(1), 32, cfg,
                      torch.bfloat16, "cpu")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in a.items()}
    assert shapes == {
        "router": ((32, 60), torch.float32),
        "w_in": ((64, 32, 96), torch.bfloat16),
        "w_out": ((64, 48, 32), torch.bfloat16),
        "shared_w_in": ((32, 192), torch.bfloat16),
        "shared_w_out": ((96, 32), torch.bfloat16)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w_in"][0], a["w_in"][1])
    # the experts' scale: d_model ** -0.5 in, d_ff ** -0.5 out
    assert abs(float(a["w_in"].float().std()) * 32 ** 0.5 - 1) < 0.05
    assert abs(float(a["w_out"].float().std()) * 48 ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("t,dropless", [(1, False), (48, False),
                                        (1000, False), (7, True)])
def test_capacity_is_repros(t, dropless):
    """The capacity and the buffer it implies: repro's buffer rows,
    E_pad * cap, fit the port's blocks of ROWS."""
    _, pcfg = configs(capacity_factor=1.25)
    cap = pm.capacity(t, pcfg, dropless)
    want = t * 2 if dropless else \
        int(-(-int(max(1, -(-t * 2 // 8) * 1.25)) // 8) * 8)
    assert cap == want
    assert dropless or cap % 8 == 0
    assert -(-cap // pm.ROWS) * pm.ROWS >= cap


def test_moe_config_is_repros():
    assert [f.name for f in dataclasses.fields(pm.MoEConfig)] == \
        [f.name for f in dataclasses.fields(rm.MoEConfig)]
    assert pm.MoEConfig(4, 2, 8) == pm.MoEConfig(**dataclasses.asdict(
        rm.MoEConfig(4, 2, 8)))
    assert pm.EXPERT_PAD == rm.EXPERT_PAD
    assert [pm.padded_experts(e) for e in (1, 16, 60, 384)] == \
        [rm.padded_experts(e) for e in (1, 16, 60, 384)]
