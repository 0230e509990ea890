"""The LM family's MoE path on the card, against the same code on the
CPU, at reduced widths. Every test here needs a CUDA device and skips
without one; this file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py

Tolerances: the dropped (token, expert) assignments equal (routing in
fp32, the same stable sorts); fp32 outputs within rtol = atol = 1e-4
(cuBLAS and the CPU's BLAS sum in other orders; TF32 off); bf16 outputs
within one rounding step of each value plus 2**-5 of the row's largest,
the rule of tests/test_torch_moe.py (the expert GEMMs, the activation
and each partial sum of the combine round to bf16). Two runs, and a
token alone or inside a batch, give the same bits."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import moe as pm
from repro_torch.models import transformer as pt
from repro_torch.testing import rounding_agree

pytestmark = pytest.mark.cuda

BF16 = dict(rel=2 ** -7, slack=2 ** -5)
RULE = {torch.float32: dict(rel=1e-4, slack=1e-4), torch.bfloat16: BF16}
# Qwen2-MoE's routing (60 experts padded to 64, top 4, 4 shared), narrow
CFG = pm.MoEConfig(n_experts=60, top_k=4, d_ff=128, n_shared=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def block_inputs(dtype, t=384, d=256, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = pm.moe_params(gen, d, CFG, dtype, "cpu")
    x = torch.randn((2, t // 2, d), generator=gen).to(dtype)
    return p, x


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_moe_block_card_matches_cpu(dev, dtype, dropless):
    p, x = block_inputs(dtype)
    pc = {k: v.to(dev) for k, v in p.items()}
    want, waux = pm.moe_block(p, x, CFG, dropless=dropless)
    got, gaux = pm.moe_block(pc, x.to(dev), CFG, dropless=dropless)
    assert torch.equal(pm.dropped_pairs(pc, x.to(dev), CFG, dropless).cpu(),
                       pm.dropped_pairs(p, x, CFG, dropless))
    ok, ratio = rounding_agree(got.cpu(), want, **RULE[dtype])
    assert ok, ratio
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))


def test_capacity_drops_card_matches_cpu(dev):
    p, x = block_inputs(torch.bfloat16, seed=1)
    p["router"][:, 7] *= 6.0                  # overfill expert 7
    pc = {k: v.to(dev) for k, v in p.items()}
    drops = pm.dropped_pairs(p, x, CFG)
    assert len(drops) > 0
    assert torch.equal(pm.dropped_pairs(pc, x.to(dev), CFG).cpu(), drops)
    got, _ = pm.moe_block(pc, x.to(dev), CFG)
    want, _ = pm.moe_block(p, x, CFG)
    ok, ratio = rounding_agree(got.cpu(), want, **BF16)
    assert ok, ratio


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_moe_combine_is_bitwise_stable_on_card(dev, dtype):
    """Two runs equal bit for bit, and a token's row alone equals its row
    inside the batch (no atomics in the combine; fixed-shape GEMMs)."""
    p, x = block_inputs(dtype, seed=2)
    p = {k: v.to(dev) for k, v in p.items()}
    x = x.reshape(1, -1, x.shape[-1]).to(dev)
    out, _ = pm.moe_block(p, x, CFG, dropless=True)
    again, _ = pm.moe_block(p, x, CFG, dropless=True)
    assert torch.equal(out, again)
    for i in (0, 5, 127, 128, 383):
        alone, _ = pm.moe_block(p, x[:, i:i + 1], CFG, dropless=True)
        assert torch.equal(alone[0, 0], out[0, i]), i
    part, _ = pm.moe_block(p, x[:, 100:300], CFG, dropless=True)
    assert torch.equal(part, out[:, 100:300])


@pytest.mark.parametrize("d,f,dtype", [(2048, 60, torch.float32),
                                       (2048, 11264, torch.bfloat16),
                                       (5632, 2048, torch.bfloat16)],
                         ids=["router", "shared_in", "shared_out"])
def test_blocked_gemm_is_batch_invariant_on_card(dev, d, f, dtype):
    """At Qwen2-MoE's widths (its router, fp32, and its shared experts'
    two GEMMs, bf16), ``_by_rows`` gives a row the same bits for every
    count of 128-row blocks from 1 to 48, and for ragged counts."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((48 * pm.ROWS, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d, f), generator=gen, device=dev) * d ** -0.5).to(dtype)
    full = pm._by_rows(x, w)
    for n in [j * pm.ROWS for j in range(1, 49)] + [1, 3, 200, 1001]:
        assert torch.equal(pm._by_rows(x[:n], w), full[:n]), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_qwen2_moe_decode_step_card_matches_cpu(dev, dtype):
    """One decode step of a reduced qwen2-moe-a2.7b (2 layers, d 256, 4
    heads of 64: a head dim of the attention kernels), card against CPU,
    on a batch of 3 over a cache of seeded noise 40 entries long."""
    full = get_arch("qwen2-moe-a2.7b").model_config(False)
    cfg = dataclasses.replace(full, vocab=1024, d_model=256, n_layers=2,
                              n_heads=4, n_kv=4, d_head=64, dtype=dtype,
                              moe=dataclasses.replace(full.moe, d_ff=128))
    params = pt.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    shape = (cfg.n_layers, 3, cfg.n_kv, 64, cfg.d_head)
    toks = torch.randint(4, cfg.vocab, (3, 1), generator=gen)
    cache = {"k": torch.randn(shape, generator=gen).to(dtype),
             "v": torch.randn(shape, generator=gen).to(dtype)}
    card = {k: v.to(dev) for k, v in cache.items()}
    want, _, n = pt.decode_step(params, toks, cache, 40, cfg)
    got, _, m = pt.decode_step(params.to(dev), toks.to(dev), card, 40, cfg)
    assert n == m == 41
    assert bool(torch.isfinite(got).all())
    ok, ratio = rounding_agree(got.cpu(), want, **RULE[dtype])
    assert ok, ratio
    for key in ("k", "v"):                        # the new entries
        ok, ratio = rounding_agree(card[key][:, :, :, 40].cpu(),
                                   cache[key][:, :, :, 40], **RULE[dtype])
        assert ok, ratio
