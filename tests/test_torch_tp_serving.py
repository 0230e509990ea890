"""The LM family's serving cells on a mesh under repro's layouts: Megatron
tensor parallelism of prefill and decode (``models/tp``), the KV cache
split by kv heads or by sequence with the ``flash_decode`` partials
merged across ranks (``kernels/flash_decode/ops.flash_decode_sharded``),
on 8 gloo ranks (a 2 x 4 ("data", "model") mesh of CPU processes),
against repro's unsharded ``prefill`` / ``decode_step`` and the port's.

Each spawned test runs one model config's three serving cells through
``build_cell(..., mesh=)`` and ``shard_args`` on every rank (this file
run as a script, one process a rank, meeting through a ``FileStore`` in
``tmp_path``; each spawn killed after ``TIMEOUT`` s; the ranks import no
JAX): prefill_32k at its reduced size, then 3 decode_32k steps from
cache_len 46 (the steps cross the edge of a 16-row block of the
sequence over "model") and 3 long_500k steps from cache_len 62 over the
sequence split over "data" (blocks of 64: data rank 1's block starts
empty, and the third step writes into it). The caches hold seeded noise
at every row, so a row read past cache_len would show. The configs:

  - reduced Mistral-NeMo (kv 1): its decode caches split the sequence
    over "model", ``wk`` / ``wv`` at 4 columns a rank (a quarter head);
  - reduced Qwen1.5-32B (kv 4): kv heads over "model", biases split;
  - six heads of 16 over 3 kv heads: ``wq`` splits mid-head (1.5 heads a
    rank) and a rank's heads span two kv groups;
  - reduced Qwen2-MoE (drop-free capacity): expert-parallel prefill and
    decode_32k with the shared experts over "model", and long_500k at
    batch 1, where the data axis does not divide the batch
    (``moe_block_tp``).

Tolerances (fp32: the reduced configs widened to fp32):
  - against the port's unsharded cells: logits within 1e-5 of each row's
    largest, and the caches (each layer's keys and values of the hidden
    states) within 1e-5 of each row's largest; the sharded sums add
    per-rank partials where one GEMM sums in its own order: rounding
    only;
  - against repro's unsharded cells (ref mode): logits within 1e-4 of
    their max abs.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 8
MESH = (2, 4)
TIMEOUT = 240          # seconds a spawn may take before its ranks are killed
STEPS = 3
STARTS = {"decode_32k": 46, "long_500k": 62}
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
SEED = 11
ARCHS = {"nemo": "mistral-nemo-12b", "qwen15": "qwen1.5-32b",
         "six_heads": "mistral-nemo-12b", "qwen2moe": "qwen2-moe-a2.7b"}


def config(case: str):
    """The port's fp32 config of ``case``."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(ARCHS[case]).model_config(True),
                              dtype=torch.float32)
    if case == "six_heads":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv=3)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def inputs(case: str, shape: str) -> dict:
    """Seeded numpy inputs of a cell: prefill tokens; or a decode cache
    of noise and STEPS steps of tokens."""
    from repro_torch.configs import get_arch

    specs = get_arch(ARCHS[case]).input_specs(shape, True)
    cfg = config(case)
    rng = np.random.default_rng(SEED + SHAPES.index(shape))
    tok = specs["tokens"].shape
    if shape == "prefill_32k":
        return {"tokens": rng.integers(4, cfg.vocab, tok).astype(np.int32)}
    cache = list(specs["cache_k"].shape)
    cache[2] = cfg.n_kv
    return {"tokens": rng.integers(4, cfg.vocab, (STEPS,) + tok).astype(
                np.int32),
            "cache_k": rng.standard_normal(cache).astype(np.float32),
            "cache_v": rng.standard_normal(cache).astype(np.float32)}


def params(case: str):
    """The port's seeded params of ``case`` as a train tree (CPU, so the
    test and every rank make the same)."""
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    return train_tree(init_params(config(case), seed=SEED, device="cpu"))


def run_cell(bundle, p, x: dict, shape: str, cut=None) -> dict:
    """The cell on params ``p`` and inputs ``x``: prefill's logits and
    cache; a decode cell's logits each step and its final cache.
    ``cut(name, tensor)`` gives the rank's block of a batch array."""
    cut = cut or (lambda name, t: t)
    out = {}
    with torch.no_grad():
        if shape == "prefill_32k":
            logits, cache, _ = bundle.fn(p, {"tokens": cut(
                "tokens", torch.from_numpy(x["tokens"]))})
            return {"logits": logits, "k": cache["k"], "v": cache["v"]}
        ck = cut("cache_k", torch.from_numpy(x["cache_k"])).clone()
        cv = cut("cache_v", torch.from_numpy(x["cache_v"])).clone()
        n = torch.tensor(STARTS[shape], dtype=torch.int32)
        for i in range(STEPS):
            batch = {"tokens": cut("tokens", torch.from_numpy(
                x["tokens"][i])), "cache_k": ck, "cache_v": cv,
                "cache_len": n}
            logits, ck, cv, n = bundle.fn(p, batch)
            out[f"logits{i}"] = logits
            n = torch.tensor(int(n), dtype=torch.int32)
        out.update(k=ck, v=cv)
    return out


# ---------------------------------------------------------------------------
# the spawn and the ranks (no JAX)
# ---------------------------------------------------------------------------
def spawn(case: str, root) -> list:
    """Run ``case`` on 8 ranks; returns each rank's saved arrays."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(WORLD):
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(WORLD), str(root)], env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{case}: a rank hung past {TIMEOUT} s")
    finally:
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        with open(os.path.join(root, f"rank{failed[0]}.log")) as f:
            pytest.fail(f"{case}: ranks {failed} failed:\n{f.read()[-4000:]}")
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(WORLD)]


def _rank_main(case: str, rank: str, world: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import coordinate, make_host_mesh
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models import tp

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"),
                                     int(world)),
        rank=int(rank), world_size=int(world))
    try:
        mesh = make_host_mesh(*MESH, device_type="cpu")
        coord = coordinate(mesh)
        out = {"data": np.int64(coord["data"]),
               "model": np.int64(coord["model"])}
        full = params(case)
        for shape in SHAPES:
            b = build_cell(ARCHS[case], shape, reduced=True, device="cpu",
                           model_cfg=config(case), mesh=mesh)
            p, _ = shard_args(b, (full, {}))
            bspec = b.executed_specs()[1]

            def cut(name, t):
                return shd.distribute_tree(t, bspec[name], mesh, coord,
                                           copy=True)

            res = run_cell(b, p, inputs(case, shape), shape, cut)
            out.update({f"{shape}_{k}": v.numpy() for k, v in res.items()})
            if shape == "prefill_32k":
                plan = tp.head_plan(b.model_cfg, tp_layer(p), coord["model"],
                                    MESH[1])
                out["prefill_kv_heads"] = np.array(plan.kv_heads)
            out[f"{shape}_seq_axes"] = np.array(
                ",".join(b.model_cfg.tp_seq_axes))
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def tp_layer(p) -> dict:
    """Layer 0's attention blocks of a rank's train tree."""
    return {k: v[0] for k, v in p["layers"]["attn"].items()}


# ---------------------------------------------------------------------------
# the references (this process)
# ---------------------------------------------------------------------------
def repro_cell(case: str, shape: str, full) -> dict:
    """repro's unsharded cell (ref mode on the CPU) on the same params
    and inputs: logits of prefill and of each decode step."""
    import jax.numpy as jnp

    from repro.configs import get_arch as repro_arch
    from repro.models import transformer as rt
    from repro_torch.models.bridge import tree_to_numpy

    cfg = config(case)
    rcfg = dataclasses.replace(repro_arch(ARCHS[case]).model_config(True),
                               dtype=jnp.float32, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv)
    if rcfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=16.0))
    rp = {k: v for k, v in _jnp_tree(tree_to_numpy(full)).items()}
    x = inputs(case, shape)
    if shape == "prefill_32k":
        toks = jnp.asarray(x["tokens"])
        logits, _, _ = rt.prefill(rp, toks, rcfg, cache_size=toks.shape[1])
        return {"logits": np.asarray(logits)}
    cache = {"k": jnp.asarray(x["cache_k"]), "v": jnp.asarray(x["cache_v"])}
    n = jnp.asarray(STARTS[shape], jnp.int32)
    out = {}
    for i in range(STEPS):
        logits, cache, n = rt.decode_step(rp, jnp.asarray(x["tokens"][i]),
                                          cache, n, rcfg)
        out[f"logits{i}"] = np.asarray(logits)
    return out


def _jnp_tree(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def row_ratio(got, want) -> float:
    """The largest |got - want| over 1e-5 of its row's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(-1, keepdims=True)
    err = np.abs(got - want)
    return float(np.max(np.where(err == 0, 0.0, err / (1e-5 * scale)),
                        initial=0.0))


@pytest.mark.parametrize("case", list(ARCHS))
def test_serving_cells_on_2x4_match_unsharded_and_repro(tmp_path, case):
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.steps import build_cell

    results = spawn(case, tmp_path)
    full = params(case)
    mesh = MeshShape(MESH, ("data", "model"))
    for shape in SHAPES:
        one = build_cell(ARCHS[case], shape, reduced=True, device="cpu",
                         model_cfg=config(case))
        want = run_cell(one, full, inputs(case, shape), shape)
        theirs = repro_cell(case, shape, full)
        bm = build_cell(ARCHS[case], shape, reduced=True, device="meta",
                        model_cfg=config(case))
        bm.mesh = mesh
        bspec = bm.executed_specs()[1]
        # the cache's sequence: over "model" where the kv heads do not
        # divide it (decode_32k), over "data" at long_500k
        split = {"prefill_32k": "", "long_500k": "data",
                 "decode_32k": "" if config(case).n_kv % MESH[1] == 0
                 else "model"}[shape]
        assert {str(r[f"{shape}_seq_axes"]) for r in results} == {split}
        for r in results:
            coord = {"data": int(r["data"]), "model": int(r["model"])}
            tok_spec = bspec["tokens"]
            for key in [k for k in want if k.startswith("logits")]:
                rows = distribute_tree(want[key], type(tok_spec)(
                    tok_spec[0], None), mesh, coord)
                got = r[f"{shape}_{key}"]
                assert got.shape == tuple(rows.shape), (shape, key)
                ratio = row_ratio(got, rows.numpy())
                assert ratio <= 1.0, (shape, key, coord, ratio)
                ref = distribute_tree(torch.tensor(theirs[key]),
                                      type(tok_spec)(tok_spec[0], None),
                                      mesh, coord).numpy()
                lim = 1e-4 * np.abs(theirs[key]).max()
                assert np.abs(got - ref).max() <= lim, (shape, key, coord)
            for name in ("k", "v"):
                if shape == "prefill_32k":
                    lo, hi = r["prefill_kv_heads"]
                    b_loc = r[f"{shape}_{name}"].shape[1]
                    d = coord["data"]
                    block = want[name][:, d * b_loc:(d + 1) * b_loc, lo:hi]
                else:
                    block = distribute_tree(want[name],
                                            bspec[f"cache_{name}"], mesh,
                                            coord)
                got = r[f"{shape}_{name}"]
                assert got.shape == tuple(block.shape), (shape, name)
                assert row_ratio(got, block.numpy()) <= 1.0, (shape, name)


# ---------------------------------------------------------------------------
# the pieces, in this process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "nemotron-4-15b",
                                  "qwen1.5-32b", "qwen2-moe-a2.7b",
                                  "kimi-k2-1t-a32b"])
def test_head_plans_on_the_production_mesh(arch):
    """Every rank of 16 x 16 computes whole heads that cover its wo rows,
    reads kv heads its cache holds, and gathers columns exactly where
    repro's split cuts a head: Mistral-NeMo's, Nemotron-4's and Kimi-K2's
    wk / wv (64 columns, half a kv head), Qwen1.5-32B's wq (2.5 heads);
    Qwen2-MoE's splits fall on heads."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import _axes, local_shape
    from repro_torch.launch.steps import build_cell, param_shapes
    from repro_torch.models import tp

    mesh = MeshShape((16, 16), ("data", "model"))
    for shape in SHAPES:
        b = build_cell(arch, shape, device="meta")
        cfg = b.model_cfg
        pspec, bspec = b.sharding_fn(mesh)
        shapes = param_shapes(arch, cfg)["layers"]["attn"]
        attn = {k: torch.empty(local_shape(tuple(shapes[k].shape),
                                           pspec["layers"]["attn"][k],
                                           mesh)[1:], device="meta")
                for k in ("wq", "wk", "wo")}
        cache = bspec.get("cache_k")
        kv_loc = None if cache is None else local_shape(
            tuple(b.arg_specs[1]["cache_k"].shape), cache, mesh)[2]
        over_model = cache is not None and "model" in _axes(cache[3])
        rows = []
        for m in range(16):
            plan = tp.head_plan(cfg, attn, m, 16, kv_loc, over_model)
            dh, g = cfg.d_head, cfg.n_heads // cfg.n_kv
            assert plan.heads[0] * dh <= plan.wo_rows[0] and \
                plan.wo_rows[1] <= plan.heads[1] * dh
            hn, kn = (plan.heads[1] - plan.heads[0],
                      plan.read_kv[1] - plan.read_kv[0])
            # the kernels map local head j to local kv head j // (hn / kn)
            assert kn == 1 or hn == kn * g
            assert plan.heads[0] // g == plan.read_kv[0]
            assert plan.kv_heads[0] <= plan.read_kv[0] and \
                plan.read_kv[1] <= plan.kv_heads[1]
            if kv_loc is not None:
                assert plan.kv_heads[1] - plan.kv_heads[0] == kv_loc
            if over_model:
                assert plan.heads == (0, cfg.n_heads)
            assert plan.gather_kv == (arch != "qwen2-moe-a2.7b")
            if arch == "qwen2-moe-a2.7b":
                assert not plan.gather_q
            if arch == "qwen1.5-32b":
                assert plan.gather_q and plan.q_cols[1] - plan.q_cols[0] == \
                    320
            rows.append(plan.wo_rows)
        assert rows[0][0] == 0 and rows[-1][1] == cfg.n_heads * cfg.d_head
        assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))


def test_gated_blocks_meet_their_down_rows():
    """A gated win cut as [gate_r | up_r] (``gated_block``) gives partials
    that sum to the whole MLP; the plain contiguous cut does not (rank 0
    of 4 would hold only gate columns). A rank's bytes are the same."""
    from repro_torch.models import tp
    from repro_torch.models.layers import mlp_block

    gen = torch.Generator().manual_seed(3)
    d, f, n = 32, 24, 4
    p = {"win": torch.randn(d, 2 * f, generator=gen),
         "wout": torch.randn(f, d, generator=gen)}
    x = torch.randn(5, 7, d, generator=gen)
    want = mlp_block(p, x, "swiglu")
    w = f // n
    parts = [tp.mlp_local({"win": tp.gated_block(p["win"], r, n),
                           "wout": p["wout"][r * w:(r + 1) * w]}, x, "swiglu")
             for r in range(n)]
    assert torch.allclose(sum(parts), want, rtol=1e-5, atol=1e-5)
    contiguous = [mlp_block({"win": p["win"][:, r * 2 * w:(r + 1) * 2 * w],
                             "wout": p["wout"][r * w:(r + 1) * w]}, x,
                            "swiglu") for r in range(n)]
    assert not torch.allclose(sum(contiguous), want, rtol=1e-3, atol=1e-3)
    assert tp.gated_block(p["win"], 1, n).shape == (d, 2 * w)
    assert torch.equal(tp.gated_block(p["win"], 0, 1), p["win"])


def test_serving_blocks_cut_the_gated_leaves():
    """``serving_blocks`` on a reduced Mistral-NeMo over 2 x 4: each rank's
    win is [gate_r | up_r], every other leaf its ``distribute_tree``
    block."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import tp
    from repro_torch.train.tree import leaves

    case = "nemo"
    mesh = MeshShape(MESH, ("data", "model"))
    b = build_cell(ARCHS[case], "prefill_32k", reduced=True, device="meta",
                   model_cfg=config(case))
    b.mesh = mesh
    pspec = b.executed_specs()[0]
    full = params(case)
    f = config(case).d_ff
    for m in range(4):
        coord = {"data": 1, "model": m}
        got = dict(leaves(tp.serving_blocks(full, pspec, mesh, "swiglu",
                                            coord)))
        plain = dict(leaves(distribute_tree(full, pspec, mesh, coord)))
        for path, t in got.items():
            assert t.shape == plain[path].shape, path
            if path.endswith("['mlp']['win']"):
                w = f // 4
                win = full["layers"]["mlp"]["win"]
                want = torch.cat([win[..., m * w:(m + 1) * w],
                                  win[..., f + m * w:f + (m + 1) * w]], -1)
                assert torch.equal(t, want)
            else:
                assert torch.equal(t, plain[path]), path


def test_embed_local_sums_to_the_table_with_jnp_takes_nan_rule():
    """The four ranks' rows sum to the whole table's bit for bit; an id >=
    V is NaN on the last rank only (repro's jnp.take fill), a negative id
    in [-V, -1] reads row id + V."""
    from repro_torch.models import tp
    from repro_torch.models.recsys import lookup

    gen = torch.Generator().manual_seed(5)
    v, d, n = 64, 8, 4
    table = torch.randn(v, d, generator=gen)
    ids = torch.tensor([[0, 15, 16, 63, -1, 64, -65, 31]])
    parts = [tp.embed_local(table[r * 16:(r + 1) * 16], ids, r, n, v)
             for r in range(n)]
    for r, part in enumerate(parts):
        nan = torch.isnan(part).any(-1)[0]
        assert nan.tolist() == ([False] * 5 + [True, True, False]
                                if r == n - 1 else [False] * 8)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    want = lookup(table, ids)
    assert torch.equal(torch.isnan(total), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(total[ok], want[ok])
    whole = tp.embed_local(table, ids, 0, 1, v)
    assert torch.equal(whole[ok], want[ok])


@pytest.mark.parametrize("b,h,kv,d,s", [(2, 8, 2, 16, 96), (1, 6, 3, 32, 40)])
def test_flash_decode_partials_at_cache_len_0_are_empty(b, h, kv, d, s):
    from repro_torch.kernels.flash_decode import ops as fd

    gen = torch.Generator().manual_seed(7)
    q = torch.randn(b, h, d, generator=gen)
    kc = torch.randn(b, kv, s, d, generator=gen)
    vc = torch.randn(b, kv, s, d, generator=gen)
    for ns in (1, None):
        m, l, acc = fd.flash_decode_partials(q, kc, vc, 0, 16, ns=ns)
        assert m.shape[-1] == (1 if ns else -(-s // 16))
        assert bool(torch.isneginf(m).all()) and not bool(l.any()) and \
            not bool(acc.any())
    with pytest.raises(ValueError, match="splits"):
        fd.flash_decode_partials(q, kc, vc, 40, 16, ns=2)


@pytest.mark.parametrize("n_blocks,s_loc", [(2, 64), (4, 16), (3, 40)])
def test_flash_decode_sharded_matches_flash_decode(n_blocks, s_loc):
    """The blocks' partials, concatenated in block order (the all-gather
    done by hand) and merged, against ``flash_decode`` over the whole
    cache: at cache_len 1, at each block edge and one past it, and full;
    blocks past cache_len (empty) change nothing, and noise in the rows
    past cache_len is never read."""
    from repro_torch.kernels.flash_decode import ops as fd

    gen = torch.Generator().manual_seed(9)
    b, h, kv, d = 2, 8, 2, 32
    s = n_blocks * s_loc
    q = torch.randn(b, h, d, generator=gen)
    kc = torch.randn(b, kv, s, d, generator=gen)
    vc = torch.randn(b, kv, s, d, generator=gen)
    lens = sorted({1, s} | {e + o for e in range(s_loc, s, s_loc)
                            for o in (0, 1)})
    for cache_len in lens:
        blocks = [(kc[:, :, i * s_loc:(i + 1) * s_loc],
                   vc[:, :, i * s_loc:(i + 1) * s_loc])
                  for i in range(n_blocks)]
        parts = [fd.flash_decode_block(q, k, v, cache_len, i, n_blocks)
                 for i, (k, v) in enumerate(blocks)]
        assert len({p[0].shape for p in parts}) == 1

        for i, (k, v) in enumerate(blocks):
            calls = []

            def gather(t):          # (m, l, acc) in turn, all blocks' own
                j = len(calls)
                calls.append(j)
                assert torch.equal(t, parts[i][j])
                return torch.cat([p[j] for p in parts], 2)

            got = fd.flash_decode_sharded(q, k, v, cache_len, i, n_blocks,
                                          gather)
            assert len(calls) == 3
            want = fd.flash_decode(q, kc, vc, cache_len=cache_len)
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), \
                (cache_len, i)
            assert not bool(torch.isnan(got).any())
        empty = [i for i in range(n_blocks) if i * s_loc >= cache_len]
        for i in empty:
            m, l, acc = parts[i]
            assert bool(torch.isneginf(m).all()) and not bool(l.any())
    one = fd.flash_decode_sharded(q, kc, vc, 5, 0, 1, None)
    assert torch.equal(one, fd.flash_decode(q, kc, vc, cache_len=5))


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
