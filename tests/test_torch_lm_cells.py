"""Port parity for the LM family's serving cells: repro_torch's
``launch/steps.build_cell`` and ``make_smoke_args`` for the prefill,
decode and long_500k cells of the five LM archs and the embedder's two
encode cells, on the CPU at reduced size (``reduce_config``), against
repro's cells on the same arrays (``make_smoke_args`` gives both
packages the same batch bit for bit; repro's params are carried across
by ``models/bridge``).

Each cell runs twice. As registered (bf16 for the LM archs): the two
packages round every op's output to bf16 at points that differ (XLA
keeps fused elementwise chains in fp32), so two layers' logits differ
by a few rounding steps of their scale; a one-rounding rule
(``rounding_agree`` at 2**-7 and 1e-4 of the row's largest) measured
28-98x over its limit, so they are held to one rounding step of each
value plus 2**-5 of the row's largest (``BF16``). Then in fp32, the
same cell functions on the same params and caches widened to fp32
(exact): logits and caches within rtol = atol = 1e-4, as
tests/test_torch_models.py holds the transformer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as repro_all_cells
from repro.configs import get_arch as repro_get_arch
from repro.configs import list_archs as repro_list_archs
from repro.launch import steps as repro_steps
from repro_torch.configs import all_cells, get_arch, list_archs
from repro_torch.launch import steps
from repro_torch.models import transformer as pt
from repro_torch.models.bridge import params_from_repro, params_to_repro
from repro_torch.testing import rounding_agree

TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rel=2 ** -7, slack=2 ** -5)
LM_ARCHS = ["kimi-k2-1t-a32b", "mistral-nemo-12b", "nemotron-4-15b",
            "qwen1.5-32b", "qwen2-moe-a2.7b"]
CELLS = [c for c in all_cells()
         if get_arch(c.arch).family in ("lm", "lm-encoder")
         and c.kind != "train"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(t):
    return torch.from_numpy(np.array(jnp.asarray(t).astype(jnp.float32)))


def test_registry_is_repros_without_schnet():
    """The registry is repro's, SchNet included (its name is kept from
    when the port registered every arch but SchNet)."""
    assert list_archs() == repro_list_archs()
    for arch in list_archs():
        ours, theirs = get_arch(arch), repro_get_arch(arch)
        assert (ours.family, ours.source) == (theirs.family, theirs.source)
        assert ([(c.shape, c.kind) for c in ours.cells()]
                == [(c.shape, c.kind) for c in theirs.cells()])
        for cell in ours.cells():
            for reduced in (False, True):
                a = ours.input_specs(cell.shape, reduced)
                b = theirs.input_specs(cell.shape, reduced)
                assert list(a) == list(b)
                for name in a:
                    assert a[name].shape == tuple(b[name].shape)
                    assert str(a[name].dtype).removeprefix("torch.") == \
                        np.dtype(b[name].dtype).name
    assert [c.key for c in all_cells()] == [c.key for c in
                                             repro_all_cells()]
    assert len(CELLS) == 17


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.key)
def test_lm_cell_matches_repro(cell):
    rb = repro_steps.build_cell(cell.arch, cell.shape, reduced=True)
    r_args = repro_steps.make_smoke_args(rb, seed=5)
    pb = steps.build_cell(cell.arch, cell.shape, reduced=True, device="cpu")
    assert (pb.arch, pb.shape, pb.kind) == (rb.arch, rb.shape, rb.kind)
    params = params_from_repro(_np_tree(r_args[0]), pb.model_cfg, "cpu")
    p_args = steps.make_smoke_args(pb, seed=5, params=params)
    assert p_args[0] is params
    r_batch, p_batch = r_args[1], p_args[1]
    assert list(p_batch) == list(r_batch)
    for name in r_batch:                               # the same batch
        assert p_batch[name].dtype == pb.arg_specs[1][name].dtype
        np.testing.assert_array_equal(_f32(r_batch[name]).numpy(),
                                      p_batch[name].float().numpy())
    if cell.kind == "decode":
        assert p_batch["cache_len"].device.type == "cpu"

    def outputs(fn, *args):
        out = fn(*args)
        return out if isinstance(out, tuple) else (out,)

    # as registered: bf16 (the LM archs) or fp32 (the embedder)
    want = outputs(rb.fn, *r_args)
    got = outputs(pb.fn, *p_args)
    rule = BF16 if pb.model_cfg.dtype == torch.bfloat16 else \
        dict(rel=1e-4, slack=1e-4)
    for g, w in zip(got, want):
        if isinstance(g, dict):                        # prefill's cache
            g, w = g["k"], w["k"]
        if isinstance(g, int):
            assert g == int(w)
            continue
        assert g.shape == tuple(w.shape)
        assert bool(torch.isfinite(g.float()).all())
        ok, ratio = rounding_agree(g, _f32(w), **rule)
        assert ok, ratio

    # fp32: the same functions on the params and caches widened to fp32
    if pb.model_cfg.dtype != torch.bfloat16:
        return
    r32 = jax.tree.map(lambda a: a.astype(jnp.float32), r_args[0])
    p32 = params_from_repro(_np_tree(r32), dataclasses.replace(
        pb.model_cfg, dtype=torch.float32), "cpu")
    rb32 = {k: (v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in r_batch.items()}
    pb32 = {k: (v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in steps.make_smoke_args(pb, seed=5,
                                              params=p32)[1].items()}
    want = outputs(rb.fn, r32, rb32)
    got = outputs(pb.fn, p32, pb32)
    for g, w in zip(got, want):
        if isinstance(g, dict):
            for key in ("k", "v"):
                np.testing.assert_allclose(g[key].numpy(),
                                           np.asarray(w[key]), **TOL)
        elif isinstance(g, int):
            assert g == int(w)
        else:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS + ["schnet"])
def test_train_cells_raise_naming_item_12(arch):
    """The LM archs' and SchNet's train cells are ported
    (tests/test_torch_train_cells.py holds them to repro): each builds an
    AdamW train cell, none raises (the name is kept from when SchNet
    raised naming ROADMAP Queue 1 item 12)."""
    shape = "full_graph_sm" if arch == "schnet" else "train_4k"
    bundle = steps.build_cell(arch, shape, reduced=True, device="cpu")
    assert (bundle.kind, bundle.optimizer, bundle.accum) == (
        "train", "adamw", 1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_match_repro(arch):
    """n_params and n_active_params of the full configs; a reduced seeded
    init allocates them, plus what repro's count leaves out: the padded
    experts' weights and the qkv biases."""
    ours = get_arch(arch).model_config(False)
    theirs = repro_get_arch(arch).model_config(False)
    assert ours.n_params() == theirs.n_params()
    assert ours.n_active_params() == theirs.n_active_params()
    small = get_arch(arch).model_config(True)
    params = pt.init_params(small, seed=1, device="cpu")
    n = sum(p.numel() for p in params.parameters())
    pad = small.n_layers * (small.n_heads + 2 * small.n_kv) * small.d_head \
        if small.qkv_bias else 0
    if small.moe:
        from repro_torch.models.moe import padded_experts
        m = small.moe
        dead = padded_experts(m.n_experts) - m.n_experts
        gated = 2 if small.act in ("swiglu", "geglu") else 1
        pad += small.n_layers * dead * (small.d_model * m.d_ff * (gated + 1))
    assert n == small.n_params() + pad
    assert all(p.dtype == (torch.float32 if name.endswith("router")
                           else small.dtype)
               for name, p in params.named_parameters())


def test_bridge_round_trips_a_moe_tree():
    """repro's bf16 MoE params -> the port -> repro: every leaf equal, the
    router fp32 and the experts on their padded axis."""
    cfg = get_arch("qwen2-moe-a2.7b").model_config(True)
    rcfg = repro_get_arch("qwen2-moe-a2.7b").model_config(True)
    from repro.models import transformer as rt
    npp = _np_tree(rt.init_params(jax.random.PRNGKey(2), rcfg))
    params = params_from_repro(npp, cfg, "cpu")
    moe = params["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_in"].dtype == torch.bfloat16
    assert moe["w_in"].shape[0] == 16 and cfg.moe.n_experts == 8
    back = params_to_repro(params)
    flat_a, tree_a = jax.tree.flatten(npp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_decode_cells_continue_their_prefill():
    """The reduced qwen2-moe cells chained: prefill_32k's cache, padded to
    the decode cell's length, feeds decode_32k; the decode's logits equal a
    prefill over one more token (fp32; capacity no smaller than T*k, so
    neither side drops)."""
    pre = steps.build_cell("qwen2-moe-a2.7b", "prefill_32k", reduced=True,
                           device="cpu")
    dec = steps.build_cell("qwen2-moe-a2.7b", "decode_32k", reduced=True,
                           device="cpu")
    cfg = dataclasses.replace(
        pre.model_cfg, dtype=torch.float32,
        moe=dataclasses.replace(pre.model_cfg.moe,
                                capacity_factor=pre.model_cfg.moe.n_experts))
    params = pt.init_params(cfg, seed=4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        4, cfg.vocab, (2, 41)).astype(np.int32))
    _, cache, n = pt.prefill(params, toks[:, :40], cfg, 64)
    logits, k, v, n = dec.fn(params, {"tokens": toks[:, 40:],
                                      "cache_k": cache["k"],
                                      "cache_v": cache["v"],
                                      "cache_len": torch.tensor(n)})
    want, _, _ = pt.prefill(params, toks, cfg, 64)
    assert n == 41 and k is cache["k"]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)
