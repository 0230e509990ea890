"""Port parity for the model stack: repro_torch's layers, transformer
(forward, pooled embedding, prefill, decode) and TransformerEmbedder on
the CPU (the attention kernels' plain versions) against repro's, with
repro's params carried across by models/bridge.py, on the same numpy
inputs. Small configs: 2 layers, narrow widths, fp32.

Tolerances: rtol = atol = 1e-4 for model functions (two layers of fp32
products summed in different orders by XLA and torch, over activations
of order 1); 1e-5 per component for the unit-norm embeddings; 1e-5 for
the single layers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rl
from repro.models import transformer as rt
from repro.models.embedder import MINILM_CONFIG as REPRO_MINILM
from repro.models.embedder import TransformerEmbedder as ReproEmbedder
from repro.models.moe import MoEConfig
from repro_torch.configs import minilm_embedder, mistral_nemo_12b
from repro_torch.models import layers as pl
from repro_torch.models import transformer as pt
from repro_torch.models.bridge import params_from_repro, params_to_repro
from repro_torch.models.embedder import MINILM_CONFIG, TransformerEmbedder

TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = dict(name="small", vocab=512, d_model=128, n_layers=2, n_heads=4,
             n_kv=2, d_head=32, d_ff=256)


def configs(**kw):
    """The same config in both packages: (repro's, the port's)."""
    args = {**SMALL, **kw}
    return (rt.TransformerConfig(**args, remat=False),
            pt.TransformerConfig(**args))


def repro_params(cfg, seed=0):
    p = rt.init_params(jax.random.PRNGKey(seed), cfg)
    return p, jax.tree.map(np.asarray, p)


def tokens(b, s, vocab, seed, pad_from=None):
    t = np.random.default_rng(seed).integers(4, vocab, (b, s)).astype(
        np.int32)
    if pad_from is not None:
        for i, n in enumerate(pad_from):
            t[i, n:] = 0
    return t


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_and_layernorm_match_repro():
    x, g, b = _rand((3, 5, 64), 1), _rand((64,), 2), _rand((64,), 3)
    np.testing.assert_allclose(
        pl.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(rl.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        pl.layernorm(*(torch.from_numpy(a) for a in (x, g, b))).numpy(),
        np.asarray(rl.layernorm(*(jnp.asarray(a) for a in (x, g, b)))),
        rtol=1e-5, atol=1e-5)


def test_rmsnorm_casts_back_before_gamma_in_bf16():
    x = torch.from_numpy(_rand((2, 3, 32), 4)).to(torch.bfloat16)
    g = torch.from_numpy(_rand((32,), 5)).to(torch.bfloat16)
    got = pl.rmsnorm(x, g)
    assert got.dtype == torch.bfloat16
    want = rl.rmsnorm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                      jnp.asarray(g.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_repro(theta):
    x = _rand((2, 7, 4, 32), 6)                 # (B, S, H, Dh)
    pos = np.arange(7, dtype=np.int32)[None, :] + 3000
    got = pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu", "sq_relu", "ssp"])
def test_activations_match_repro(act):
    x = _rand((1000,), 7) * 4
    np.testing.assert_allclose(
        pl.activation(act)(torch.from_numpy(x)).numpy(),
        np.asarray(rl.activation(act)(jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    assert torch.allclose(pl.activation("gelu")(x),
                          torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.allclose(pl.activation("gelu")(x),
                              torch.nn.functional.gelu(x), atol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_and_attention_blocks_match_repro(act):
    rcfg, pcfg = configs(act=act)
    rp, npp = repro_params(rcfg, 1)
    lp = params_from_repro(npp, pcfg, "cpu")["layers"][0]
    rlp = jax.tree.map(lambda a: a[0], rp["layers"])
    x = _rand((2, 9, 128), 8)
    np.testing.assert_allclose(
        pl.mlp_block(lp["mlp"], torch.from_numpy(x), act).numpy(),
        np.asarray(rl.mlp_block(rlp["mlp"], jnp.asarray(x), act)), **TOL)
    np.testing.assert_allclose(
        pl.attention_block(lp["attn"], torch.from_numpy(x), pcfg.attn).numpy(),
        np.asarray(rl.attention_block(rlp["attn"], jnp.asarray(x),
                                      rcfg.attn, impl="ref")), **TOL)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(act="gelu", causal=False), dict(qkv_bias=True),
    dict(rope_theta=1_000_000.0, n_kv=1),
], ids=["causal-swiglu", "encoder-gelu", "qkv-bias", "mqa-theta1e6"])
def test_forward_matches_repro(kw):
    rcfg, pcfg = configs(**kw)
    rp, npp = repro_params(rcfg, 2)
    params = params_from_repro(npp, pcfg, "cpu")
    t = tokens(3, 24, 512, 3)
    got, aux = pt.forward(params, torch.from_numpy(t), pcfg)
    want, _ = rt.forward(rp, jnp.asarray(t), rcfg)
    assert got.shape == (3, 24, 128) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        pt.logits_fn(params, got).numpy(),
        np.asarray(rt.logits_fn(rp, jnp.asarray(got.numpy()))), **TOL)


def test_forward_pooled_matches_repro():
    rcfg, pcfg = configs(act="gelu", causal=False)
    rp, npp = repro_params(rcfg, 3)
    params = params_from_repro(npp, pcfg, "cpu")
    t = tokens(4, 20, 512, 4, pad_from=[20, 5, 1, 12])
    got = pt.forward_pooled(params, torch.from_numpy(t), pcfg)
    want = rt.forward_pooled(rp, jnp.asarray(t), rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_prefill_and_decode_match_repro():
    rcfg, pcfg = configs()
    rp, npp = repro_params(rcfg, 5)
    params = params_from_repro(npp, pcfg, "cpu")
    t = tokens(2, 16, 512, 6)
    size = 24
    got_l, cache, n = pt.prefill(params, torch.from_numpy(t), pcfg, size)
    want_l, rcache, rn = rt.prefill(rp, jnp.asarray(t), rcfg, size)
    assert n == int(rn) == 16
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    for name in ("k", "v"):
        assert cache[name].shape == (2, 2, 2, size, 32)
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(rcache[name]), **TOL)
    rk, rv = rcache["k"], rcache["v"]
    for step in range(4):
        nxt = tokens(2, 1, 512, 10 + step)
        got_l, cache, n = pt.decode_step(params, torch.from_numpy(nxt),
                                         cache, n, pcfg)
        want_l, rc, rn = rt.decode_step(rp, jnp.asarray(nxt),
                                        {"k": rk, "v": rv}, rn, rcfg)
        rk, rv = rc["k"], rc["v"]
        assert n == int(rn) == 17 + step
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(rk), **TOL)
    with pytest.raises(ValueError):
        pt.decode_step(params, torch.from_numpy(nxt), cache, size, pcfg)


def test_decode_continues_prefill():
    """Prefill of S tokens then decode of the next T gives the logits of
    one prefill over S + T tokens: the two attention kernels' plain
    versions held against each other."""
    _, pcfg = configs()
    params = pt.init_params(pcfg, seed=7, device="cpu")
    t = torch.from_numpy(tokens(1, 30, 512, 8))
    _, cache, n = pt.prefill(params, t[:, :20], pcfg, 32)
    for i in range(20, 30):
        logits, cache, n = pt.decode_step(params, t[:, i:i + 1], cache, n,
                                          pcfg)
    want, _, _ = pt.prefill(params, t, pcfg, 32)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dropless_prefill", [False, True],
                         ids=["capacity", "no-drops"])
def test_moe_model_matches_repro(dropless_prefill):
    """A MoE TransformerConfig runs forward, prefill and decode_step and
    matches repro: the capacity path in forward and prefill (drops
    included at capacity_factor 1.0), the dropless path in decode."""
    cf = 8.0 if dropless_prefill else 1.0
    moe = MoEConfig(n_experts=6, top_k=2, d_ff=32, n_shared=1,
                    capacity_factor=cf)
    rcfg, pcfg = configs(moe=moe)
    pcfg = dataclasses.replace(pcfg, moe=pt.MoEConfig(
        **dataclasses.asdict(moe)))
    rp, npp = repro_params(rcfg, 12)
    params = params_from_repro(npp, pcfg, "cpu")
    assert params["layers"][0]["moe"]["w_in"].shape[0] == 16
    t = tokens(2, 24, 512, 13)
    h, aux = pt.forward(params, torch.from_numpy(t), pcfg)
    rh, raux = rt.forward(rp, jnp.asarray(t), rcfg)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5,
                               atol=1e-7)
    assert float(aux) > 0
    logits, cache, n = pt.prefill(params, torch.from_numpy(t[:, :20]), pcfg,
                                  24)
    rl_, rc, rn = rt.prefill(rp, jnp.asarray(t[:, :20]), rcfg, 24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl_), **TOL)
    for i in range(20, 24):
        logits, cache, n = pt.decode_step(
            params, torch.from_numpy(t[:, i:i + 1]), cache, n, pcfg)
        rl_, rc, rn = rt.decode_step(rp, jnp.asarray(t[:, i:i + 1]), rc, rn,
                                     rcfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl_), **TOL)
    assert n == int(rn) == 24
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(rc[key]),
                                   **TOL)


def test_bridge_round_trips():
    rcfg, pcfg = configs(qkv_bias=True)
    _, npp = repro_params(rcfg, 9)
    params = params_from_repro(npp, pcfg, "cpu")
    back = params_to_repro(params)
    flat_a, tree_a = jax.tree.flatten(npp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    again = params_from_repro(back, pcfg, "cpu")
    for (na, a), (nb, b) in zip(params.named_parameters(),
                                again.named_parameters()):
        assert na == nb and torch.equal(a, b)
    with pytest.raises(ValueError):
        params_from_repro(npp, dataclasses.replace(pcfg, n_layers=3), "cpu")


def test_port_init_is_seeded_and_shaped():
    _, pcfg = configs(dtype=torch.bfloat16)
    a = pt.init_params(pcfg, seed=3, device="cpu")
    b = pt.init_params(pcfg, seed=3, device="cpu")
    c = pt.init_params(pcfg, seed=4, device="cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert sum(p.numel() for p in a.parameters()) == pcfg.n_params()
    assert not any(p.requires_grad for p in a.parameters())


def test_configs_are_repro_configs():
    from repro.configs import mistral_nemo_12b as r_mn
    from repro.configs import minilm_embedder as r_ml
    for port, repro in ((mistral_nemo_12b, r_mn), (minilm_embedder, r_ml)):
        for f in dataclasses.fields(port.CONFIG):
            if f.name != "dtype":
                assert getattr(port.CONFIG, f.name) == getattr(
                    repro.CONFIG, f.name), f.name
        assert port.SOURCE == repro.ARCH.source
        assert port.CONFIG.n_params() == repro.CONFIG.n_params()
    assert mistral_nemo_12b.CONFIG.dtype == torch.bfloat16
    assert minilm_embedder.SHAPES == r_ml._SHAPES
    assert MINILM_CONFIG == minilm_embedder.CONFIG


# ---------------------------------------------------------------------------
# embedder
# ---------------------------------------------------------------------------
TEXTS = ["Security policy requires annual review.",
         "metric alpha equals 42 units",
         "the network capacity plan for 2025",
         "",
         "billing archive audit records are kept for seven years"]


def test_transformer_embedder_matches_repro():
    rcfg = dataclasses.replace(REPRO_MINILM, n_layers=2)
    pcfg = dataclasses.replace(MINILM_CONFIG, n_layers=2)
    rp, npp = repro_params(rcfg, 11)
    want = ReproEmbedder(rcfg, max_len=32, params=rp).embed(TEXTS)
    emb = TransformerEmbedder(pcfg, max_len=32,
                              params=params_from_repro(npp, pcfg, "cpu"),
                              device="cpu")
    got = emb.embed(TEXTS)
    assert got.shape == (5, 384) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert emb.embed([]).shape == (0, 384)


def test_transformer_embedder_is_batch_invariant_bitwise():
    pcfg = dataclasses.replace(MINILM_CONFIG, n_layers=1, vocab=512)
    emb = TransformerEmbedder(pcfg, max_len=16, device="cpu")
    full = emb.embed(TEXTS * 8, batch_size=8)             # 5 chunks
    for i, t in enumerate(TEXTS):
        assert np.array_equal(emb.embed([t], batch_size=8)[0], full[i])
        assert np.array_equal(full[i], full[i + 5 * 7])
