"""The port's sharded paths on the card over a real NCCL process group of
one rank (``make_host_mesh(1, 1)``): every collective runs, over groups
of one, and each result equals the no-mesh path's bit for bit (a sum or
gather over one rank is a copy; the rank's body is the one-card code).
Every test needs a CUDA device and skips without one; this file imports
no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_distributed_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.mistral_nemo_12b import CONFIG as NEMO
from repro_torch.launch import collectives as col
from repro_torch.launch.steps import build_cell, make_smoke_args, shard_args
from repro_torch.models import moe as pm
from repro_torch.models.bridge import train_tree
from repro_torch.models.recsys import DLRMConfig, dlrm_forward, dlrm_init
from repro_torch.models.transformer import init_params
from repro_torch.train.tree import leaves

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_moe_block_on_one_rank_is_bit_for_bit(mesh, dtype, dropless):
    cfg = pm.MoEConfig(n_experts=60, top_k=4, d_ff=128, n_shared=4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = pm.moe_params(gen, 256, cfg, dtype, "cuda")
    x = torch.randn((2, 192, 256), generator=gen, device="cuda").to(dtype)
    col.take_records()
    got, gaux = pm.moe_block_sharded(p, x, cfg, mesh, dropless=dropless)
    stats = col.collective_stats(col.take_records())
    want, waux = pm.moe_block(p, x, cfg, dropless=dropless)
    assert torch.equal(got, want) and torch.equal(gaux, waux)
    assert stats["all-gather"]["count"] == 2
    assert stats["all-reduce"]["count"] == 2
    assert stats["total_wire_bytes"] == 0.0       # groups of one rank


def test_dlrm_forward_on_one_rank_is_bit_for_bit(mesh):
    """The kernel bag through ``RowShardedBag`` on a 1 x 1 mesh, NaN bags
    (an id at the padded size) and padding included."""
    cfg = DLRMConfig(table_sizes=(5000, 40, 9000, 4096) + (300,) * 22)
    params = dlrm_init(cfg, seed=0, device="cuda")
    bundle = build_cell("dlrm-mlperf", "serve_p99", device="cuda",
                        model_cfg=cfg, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.stack([torch.randint(0, v, (512, 1), generator=gen,
                                     device="cuda")
                       for v in cfg.table_sizes], 1).to(torch.int32)
    ids[3, 0, 0] = 5120
    ids[5, 1, 0] = 256
    ids[9, 3, 0] = -1
    dense = torch.rand((512, 13), generator=gen, device="cuda")
    with torch.no_grad():
        want = dlrm_forward(params, cfg, dense, ids)
        got = bundle.fn(params, {"dense": dense, "sparse_ids": ids})
    assert torch.isnan(want).sum() == 2
    assert torch.equal(torch.nan_to_num(got, nan=7.0),
                       torch.nan_to_num(want, nan=7.0))


def test_qwen2_moe_train_step_on_one_rank_is_bit_for_bit(mesh):
    cfg = get_arch("qwen2-moe-a2.7b").model_config(True)
    # d_head 32: the card's attention kernels take 32, 64 and 128
    cfg = dataclasses.replace(cfg, dtype=torch.float32, d_head=32)
    one = build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                     device="cuda", model_cfg=cfg)
    rank = build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                      device="cuda", model_cfg=cfg, mesh=mesh)
    assert rank.model_cfg.moe_mesh is mesh
    p1, o1, l1 = one.fn(*make_smoke_args(one, seed=0))
    p2, o2, l2 = rank.fn(*make_smoke_args(rank, seed=0))
    assert torch.equal(l1, l2)
    for (n, a), (_, b) in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b), n
    # AdamW's first step moves a param by about lr_t whatever its
    # gradient; its first moment, (1 - b1) g, holds the gradients
    for (n, a), (_, b) in zip(leaves(o1["m"]), leaves(o2["m"])):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("shape,b,s,start", [("prefill_32k", 1, 512, 0),
                                             ("decode_32k", 2, 1024, 1020),
                                             ("long_500k", 1, 4096, 2046)])
def test_mistral_nemo_serving_on_one_rank_is_bit_for_bit(mesh, shape, b, s,
                                                         start):
    """Mistral-NeMo-12B at full width, 2 layers, through ``build_cell(...,
    mesh=)`` on a 1 x 1 mesh (the tensor-parallel bodies, every
    collective over one rank, long_500k's sequence over "data" of one):
    prefill's logits and cache, and 3 decode steps' logits and cache,
    equal the no-mesh cell's bit for bit (at shorter sequences than the
    cells')."""
    cfg = dataclasses.replace(NEMO, n_layers=2)
    one = build_cell("mistral-nemo-12b", shape, device="cuda", model_cfg=cfg)
    rank = build_cell("mistral-nemo-12b", shape, device="cuda",
                      model_cfg=cfg, mesh=mesh)
    assert rank.model_cfg.tp_mesh is mesh
    params = init_params(cfg, seed=0, device="cuda")
    local, _ = shard_args(rank, (train_tree(params), {}))
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        if shape == "prefill_32k":
            toks = torch.randint(4, cfg.vocab, (b, s), generator=gen,
                                 device="cuda", dtype=torch.int32)
            l1, c1, _ = one.fn(params, {"tokens": toks})
            l2, c2, _ = rank.fn(local, {"tokens": toks})
            assert torch.equal(l1, l2)
            assert torch.equal(c1["k"], c2["k"])
            assert torch.equal(c1["v"], c2["v"])
            return
        cache = (cfg.n_layers, b, cfg.n_kv, s, cfg.d_head)
        caches = [torch.randn(cache, generator=gen, device="cuda").to(
            cfg.dtype) for _ in range(2)]
        runs = []
        for cell, p in ((one, params), (rank, local)):
            ck, cv = (c.clone() for c in caches)
            n, outs = torch.tensor(start, dtype=torch.int32), []
            for i in range(3):
                toks = torch.full((b, 1), 7 + i, dtype=torch.int32,
                                  device="cuda")
                logits, ck, cv, n = cell.fn(p, {
                    "tokens": toks, "cache_k": ck, "cache_v": cv,
                    "cache_len": torch.tensor(int(n), dtype=torch.int32)})
                outs.append(logits)
            runs.append((outs, ck, cv))
    (o1, k1, v1), (o2, k2, v2) = runs
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def _step_bits(one, rank, params, batch):
    """(loss, params, AdamW m) of ``one`` (no mesh) and ``rank`` (its
    ``shard_args`` blocks of the same whole args), bit for bit."""
    step0 = torch.tensor(0, dtype=torch.int32, device="cuda")
    local = shard_args(rank, (params, None, batch, step0))
    p2, o2, l2 = rank.fn(*local)
    p1, o1, l1 = one.fn(params, one.opt.init(params), batch, step0)
    assert torch.equal(l1, l2)
    for (n, a), (_, b) in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b), n
    for (n, a), (_, b) in zip(leaves(o1["m"]), leaves(o2["m"])):
        assert torch.equal(a, b), n


def test_mistral_nemo_train_step_on_one_rank_is_bit_for_bit(mesh):
    """Mistral-NeMo-12B train_4k at full width, 2 layers, bf16, 1 x 4096,
    through ``build_cell(..., mesh=)`` on a 1 x 1 mesh (the
    tensor-parallel bodies and their backward, ZeRO-1's layout): loss,
    params and AdamW m equal the no-mesh step's."""
    cfg = dataclasses.replace(NEMO, n_layers=2)
    one = build_cell("mistral-nemo-12b", "train_4k", device="cuda",
                     model_cfg=cfg, accum=1)
    rank = build_cell("mistral-nemo-12b", "train_4k", device="cuda",
                      model_cfg=cfg, accum=1, mesh=mesh)
    assert rank.model_cfg.tp_mesh is mesh
    params = train_tree(init_params(cfg, seed=3, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (1, 4096), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    _step_bits(one, rank, params, batch)


@pytest.mark.parametrize("arch", ["fm", "wide-deep", "dlrm-mlperf",
                                  "bert4rec"])
def test_recsys_train_step_on_one_rank_is_bit_for_bit(mesh, arch):
    """The reduced recsys train cells on the card through
    ``build_cell(..., mesh=)`` on a 1 x 1 mesh (row-sharded lookups,
    column-parallel MLPs, BERT4Rec's tensor parallelism, ZeRO-1's
    layout) equal the no-mesh step bit for bit, with PyTorch's default
    (nondeterministic) algorithms: FM's and Wide&Deep's ``lookup`` adds
    its rows' gradients with ``gather_segment_sum``
    (``kernels/segment_sum.take``), BERT4Rec's embedding is an index
    whose backward sorts (``index_put_`` accumulate: no atomics)."""
    from repro_torch.launch.steps import smoke_batch

    assert not torch.are_deterministic_algorithms_enabled()
    one = build_cell(arch, "train_batch", reduced=True, device="cuda")
    rank = build_cell(arch, "train_batch", reduced=True, device="cuda",
                      mesh=mesh)
    params = make_smoke_args(one, seed=1)[0]
    _step_bits(one, rank, params, smoke_batch(one, 1))


@pytest.mark.parametrize("arch", ["fm", "wide-deep"])
def test_lookup_train_steps_repeat_bit_for_bit(arch):
    """Two FM and two Wide&Deep steps (the full cells' widths, a batch
    of 8,192) from the same state on the card, deterministic algorithms
    off: the same loss, params and AdamW m, bit for bit, and no aten op
    that adds at indices in the step (``lookup``'s gradient is
    ``gather_segment_sum``, which launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.segment_sum import ops as ss
    from repro_torch.testing import accumulating_ops
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import tree_map

    assert not torch.are_deterministic_algorithms_enabled()
    cell = build_cell(arch, "train_batch", device="cuda")
    params, _, batch, step0 = make_smoke_args(cell, seed=2)
    batch = {k: v[:8192] for k, v in batch.items()}
    runs = []
    for _ in range(2):
        p = tree_map(lambda t: t.detach().clone(), params)
        before = ss.launches
        runs.append(cell.fn(p, cell.opt.init(p), batch, step0))
        assert ss.launches > before
    (p1, o1, l1), (p2, o2, l2) = runs
    assert torch.equal(l1, l2)
    for a, b in ((p1, p2), (o1["m"], o2["m"])):
        for (n, x), (_, y) in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y), n
    assert accumulating_ops(lambda: grad_accum_value_and_grad(cell.loss)(
        params, batch)) == []
