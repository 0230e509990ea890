"""The port's sharded paths on 8 gloo ranks, a 2 x 4 ("data", "model")
mesh of CPU processes, against repro and the port's own unsharded paths.

Each test spawns one process group of 8 ranks (this file run as a
script, ``OMP_NUM_THREADS=1`` a rank), which meet through a ``FileStore``
in the test's ``tmp_path`` (no port, no network) and write their results
there; the test holds them to the reference. Each spawn has its own hard
timeout (``TIMEOUT``, 240 s): a hung rank fails its test and is killed.
The ranks import no JAX; repro runs in the test process or, for its
8-device shard_map, in a subprocess with 8 forced host devices (as
``tests/test_distributed.py`` runs it).

Tolerances:
  - ``moe_block_sharded`` vs repro's ``moe_block_sharded``: each output
    within 1e-5 of its row's largest value (fp32; torch and XLA sum the
    expert GEMMs in other orders), aux 1e-5 relative, the dropped (token,
    expert) pairs equal (routing in fp32, stable sorts, the same local
    capacity rule);
  - vs the port's unsharded ``moe_block``, drop-free: 1e-5 of each row's
    largest; gradients each leaf within 1e-5 of its largest (the sharded
    sum adds per-rank partials, the unsharded block k slot terms in
    order: rounding, not bits);
  - a reduced Qwen2-MoE train step (fp32, drop-free, no aux loss: the
    sharded aux is the mean of per-shard aux losses, another objective by
    design, held in the MoE gradient test instead) vs the unsharded step:
    loss 1e-5 relative, params after one step within 1e-5 + 2 lr_t
    (AdamW's first step is about lr_t sign(g));
  - DLRM with row-sharded tables vs one table: the forward bit for bit at
    L = 1, NaN bags included (each bag is one rank's row plus zeros); the
    gradient each leaf within 1e-6 of its largest;
  - retrieval on the mesh: repro's ``test_retrieval_shard_map_matches_
    local`` rule (scores 1e-5 of ``topk_search_ref``, the query's own row
    first), ids equal;
  - ``device_fanout_topk(mesh=)`` vs no mesh: bit for bit (the same
    kernel on the same slices);
  - ``collective_stats`` of recorded calls: exact, by hand.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 8
TIMEOUT = 240          # seconds a spawn may take before its ranks are killed


# ---------------------------------------------------------------------------
# the spawn
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


def run_repro(code: str, timeout: int = TIMEOUT) -> str:
    """repro on 8 forced host devices, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr[-4000:]}"
    return out.stdout


def row_close(got, want, rel):
    """|got - want| <= rel * the largest |want| of each row (last dim)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(-1, keepdims=True)
    return bool((np.abs(got - want) <= rel * scale).all())


def leaf_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max(initial=0.0)) <= \
        rel * float(np.abs(want).max(initial=0.0))


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------
D, E, TOPK, FF = 32, 8, 2, 16
X_SHAPE = (4, 16, D)


def moe_configs():
    from repro_torch.models.moe import MoEConfig

    return {"free": MoEConfig(n_experts=E, top_k=TOPK, d_ff=FF, n_shared=1,
                              capacity_factor=16.0),
            "drop": MoEConfig(n_experts=E, top_k=TOPK, d_ff=FF, n_shared=1,
                              capacity_factor=1.0)}


def moe_inputs(root) -> str:
    """Seeded numpy MoE params and tokens, saved for the ranks; the
    "drop" router sends most tokens to expert 3, past its capacity."""
    rng = np.random.default_rng(7)
    e_pad = 16
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.2,
         "w_in": rng.standard_normal((e_pad, D, 2 * FF)).astype(
             np.float32) * D ** -0.5,
         "w_out": rng.standard_normal((e_pad, FF, D)).astype(
             np.float32) * FF ** -0.5,
         "shared_w_in": rng.standard_normal((D, 2 * FF)).astype(
             np.float32) * D ** -0.5,
         "shared_w_out": rng.standard_normal((FF, D)).astype(
             np.float32) * FF ** -0.5,
         "x": rng.standard_normal(X_SHAPE).astype(np.float32)}
    p["router_drop"] = p["router"].copy()
    p["router_drop"][:, 3] *= 30.0
    path = os.path.join(root, "moe.npz")
    np.savez(path, **p)
    return path


def moe_specs():
    from repro_torch.launch.sharding import P

    return {"router": P(None, None), "w_in": P("model", "data", None),
            "w_out": P("model", "data", None),
            "shared_w_in": P(None, None), "shared_w_out": P(None, None)}


# ---------------------------------------------------------------------------
# rank-side cases (run in the spawned ranks: no JAX)
# ---------------------------------------------------------------------------
def _coord(mesh) -> dict:
    from repro_torch.launch.mesh import coordinate

    return coordinate(mesh)


def _moe_params(root, router_key="router"):
    z = np.load(os.path.join(root, "moe.npz"))
    full = {k: torch.from_numpy(z[k]) for k in
            ("w_in", "w_out", "shared_w_in", "shared_w_out")}
    full["router"] = torch.from_numpy(z[router_key])
    return full, torch.from_numpy(z["x"])


def case_moe_repro(mesh, root) -> dict:
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.models import moe as pm

    c = _coord(mesh)
    out = {"data": np.int64(c["data"]), "model": np.int64(c["model"])}
    for name, cfg in moe_configs().items():
        full, x = _moe_params(root, "router" if name == "free"
                              else "router_drop")
        p = distribute_tree(full, moe_specs(), mesh, copy=True)
        bl = X_SHAPE[0] // 2
        x_loc = x[c["data"] * bl:(c["data"] + 1) * bl]
        y, aux = pm.moe_block_sharded(p, x_loc, cfg, mesh)
        e_loc = p["w_in"].shape[0]
        drops = pm.local_dropped_pairs(x_loc, p["router"], c["model"], e_loc,
                                       16, cfg).numpy()
        drops[:, 0] += c["data"] * bl * X_SHAPE[1]      # global token ids
        out.update({f"{name}_out": y.numpy(), f"{name}_aux": aux.numpy(),
                    f"{name}_drops": drops})
    return out


def case_moe_grads(mesh, root) -> dict:
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.models import moe as pm
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    c = _coord(mesh)
    cfg = moe_configs()["free"]
    full, x = _moe_params(root)
    p = distribute_tree(full, moe_specs(), mesh, copy=True)
    bl = X_SHAPE[0] // 2
    x_loc = x[c["data"] * bl:(c["data"] + 1) * bl]

    def loss(params, batch):
        y, aux = pm.moe_block_sharded(params, batch["x"], cfg, mesh)
        return torch.mean(y ** 2) + aux

    total, grads = grad_accum_value_and_grad(loss, 1, mesh, moe_specs())(
        p, {"x": x_loc})
    with torch.no_grad():
        y, _ = pm.moe_block_sharded(p, x_loc, cfg, mesh)
    out = {"data": np.int64(c["data"]), "model": np.int64(c["model"]),
           "loss": total.numpy(), "out": y.numpy()}
    out.update({f"grad_{k}": v.numpy() for k, v in grads.items()})
    return out


def qwen_config():
    from repro_torch.configs import get_arch

    cfg = get_arch("qwen2-moe-a2.7b").model_config(True)
    return dataclasses.replace(
        cfg, dtype=torch.float32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0, router_aux_weight=0.0))


def _save_tree(prefix: str, tree) -> dict:
    from repro_torch.train.tree import leaves

    return {f"{prefix}{path}": t.detach().numpy()
            for path, t in leaves(tree)}


def case_train(mesh, root) -> dict:
    from repro_torch.launch import collectives as col
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    b = build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                   device="cpu", model_cfg=qwen_config(), mesh=mesh)
    assert b.model_cfg.moe_mesh is mesh
    args = make_smoke_args(b, seed=0)
    _, grads = grad_accum_value_and_grad(b.loss, b.accum, mesh,
                                         b.executed_specs()[0])(args[0],
                                                                args[2])
    col.take_records()
    params, _, loss = b.fn(*args)
    stats = col.collective_stats(col.take_records())
    c = _coord(mesh)
    out = {"data": np.int64(c["data"]), "model": np.int64(c["model"]),
           "loss": loss.numpy(), "accum": np.int64(b.accum),
           "gathers": np.int64(stats["all-gather"]["count"]),
           "reduces": np.int64(stats["all-reduce"]["count"])}
    out.update(_save_tree("p", params))
    out.update(_save_tree("g", grads))
    return out


def dlrm_config():
    from repro_torch.models.recsys import DLRMConfig

    return DLRMConfig(n_sparse=5, embed_dim=8, bot_mlp=(13, 16, 8),
                      top_mlp=(16, 8, 1),
                      table_sizes=(5000, 40, 9000, 4096, 300))


def dlrm_batch(train: bool) -> dict:
    """16 samples, one id a field. Forward: an id at the padded size of
    a row-sharded (5120) and of a replicated table (256) -> NaN bags; an
    id in [V, V_pad) -> a padded row; -1 -> padding; 5119, the last row
    of the last shard."""
    cfg = dlrm_config()
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, v, 16) for v in cfg.table_sizes],
                   1)[:, :, None]
    if not train:
        ids[3, 0, 0] = 5120
        ids[5, 1, 0] = 256
        ids[7, 2, 0] = 9000
        ids[9, 3, 0] = -1
        ids[11, 0, 0] = 5119
    batch = {"dense": torch.from_numpy(rng.random((16, 13)).astype(
        np.float32)), "sparse_ids": torch.from_numpy(ids.astype(np.int32))}
    if train:
        batch["labels"] = torch.from_numpy(
            rng.integers(0, 2, 16).astype(np.float32))
    return batch


def case_dlrm(mesh, root) -> dict:
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.recsys import dlrm_init
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    cfg = dlrm_config()
    full = train_tree(dlrm_init(cfg, seed=0, device="cpu"))
    serve = build_cell("dlrm-mlperf", "serve_p99", reduced=True,
                       device="cpu", model_cfg=cfg, mesh=mesh)
    p, batch = shard_args(serve, (full, dlrm_batch(False)))
    logits = serve.fn(p, batch)
    train = build_cell("dlrm-mlperf", "train_batch", reduced=True,
                       device="cpu", model_cfg=cfg, mesh=mesh)
    p, _, batch, _ = shard_args(train, (full, None, dlrm_batch(True), None))
    loss, grads = grad_accum_value_and_grad(
        train.loss, 1, mesh, train.executed_specs()[0])(p, batch)
    c = _coord(mesh)
    out = {"data": np.int64(c["data"]), "model": np.int64(c["model"]),
           "logits": logits.detach().numpy(), "loss": loss.numpy()}
    out.update(_save_tree("g", grads))
    return out


def retrieval_batch():
    rng = np.random.default_rng(0)
    n, d = 512, 10
    cands = rng.standard_normal((n, d)).astype(np.float32)
    cands /= np.linalg.norm(cands, axis=1, keepdims=True)
    mask = np.ones(n, bool)
    mask[-5:] = False
    return {"query": cands[7:8], "candidates": cands,
            "candidate_mask": mask}


def case_retrieval(mesh, root) -> dict:
    from repro_torch.launch.steps import build_cell, shard_args

    b = build_cell("fm", "retrieval_cand", reduced=True, device="cpu",
                   mesh=mesh)
    assert b.arg_specs[0]["candidates"].shape == (512, 10)
    batch = {k: torch.from_numpy(v) for k, v in retrieval_batch().items()}
    (local,) = shard_args(b, (batch,))
    assert local["candidates"].shape == (64, 10)
    s, i = b.fn(local)
    return {"s": s.numpy(), "i": i.numpy()}


def case_fanout(mesh, root) -> dict:
    from repro_torch.shard.planner import device_fanout_topk

    rng = np.random.default_rng(5)
    out = {}
    for n_shards in (8, 3):
        emb = rng.standard_normal((n_shards, 256, 16)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        mask = rng.random((n_shards, 256)) > 0.1
        q = rng.standard_normal((4, 16)).astype(np.float32)
        for k in (5, 40):
            got = device_fanout_topk(q, emb, mask, k, mesh=mesh)
            want = device_fanout_topk(q, emb, mask, k, devices=["cpu"])
            tgot = device_fanout_topk(q, torch.from_numpy(emb),
                                      torch.from_numpy(mask), k, mesh=mesh)
            for tag, res in (("mesh", got), ("one", want), ("torch", tgot)):
                out[f"{n_shards}_{k}_{tag}_s"] = res[0]
                out[f"{n_shards}_{k}_{tag}_i"] = res[1]
    return out


def case_collectives(mesh, root) -> dict:
    from repro_torch.launch import collectives as col

    col.take_records()
    a = col.all_reduce_sum(torch.ones(3, 5), mesh, "model")
    x = torch.ones(2, 3, requires_grad=True)
    b = col.all_gather(x, mesh, "data", dim=0)
    c = col.all_reduce_mean(torch.ones(4), mesh, ("data", "model"))
    b.sum().backward()
    stats = col.collective_stats(col.take_records())
    return {"a": a.numpy(), "b": b.detach().numpy(), "c": c.numpy(),
            "dx": x.grad.numpy(),
            "ar": np.array([stats["all-reduce"]["count"],
                            stats["all-reduce"]["bytes"],
                            stats["all-reduce"]["wire_bytes"]]),
            "ag": np.array([stats["all-gather"]["count"],
                            stats["all-gather"]["bytes"],
                            stats["all-gather"]["wire_bytes"]]),
            "total": np.array([stats["total_bytes"],
                               stats["total_wire_bytes"]])}


CASES = {"moe_repro": case_moe_repro, "moe_grads": case_moe_grads,
         "train": case_train, "dlrm": case_dlrm,
         "retrieval": case_retrieval, "fanout": case_fanout,
         "collectives": case_collectives}


def _rank_main(case: str, rank: str, world: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"),
                                     int(world)),
        rank=int(rank), world_size=int(world))
    try:
        mesh = make_host_mesh(2, 4, device_type="cpu")
        out = CASES[case](mesh, root)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests (this process: repro and the unsharded port)
# ---------------------------------------------------------------------------
def by_data(results, key):
    """The data ranks' blocks of ``key`` (model rank 0's), in data order,
    after checking that the model ranks of a data row agree bit for bit."""
    blocks = {}
    for r in results:
        d = int(r["data"])
        if d in blocks:
            np.testing.assert_array_equal(r[key], blocks[d])
        else:
            blocks[d] = r[key]
    return np.concatenate([blocks[d] for d in sorted(blocks)])


REPRO_MOE = """
    import numpy as np, jax, jax.numpy as jnp, dataclasses
    from repro.models.moe import MoEConfig, moe_block_sharded
    from repro.launch.compat import make_mesh
    mesh = make_mesh((2, 4), ("data", "model"))
    z = np.load({path!r})
    cfgs = {{"free": MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1,
                               capacity_factor=16.0),
             "drop": MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1,
                               capacity_factor=1.0)}}
    x = jnp.asarray(z["x"])
    out = {{}}
    for name, cfg in cfgs.items():
        router = jnp.asarray(z["router" if name == "free" else "router_drop"])
        p = {{"router": router, "w_in": jnp.asarray(z["w_in"]),
             "w_out": jnp.asarray(z["w_out"]),
             "shared_w_in": jnp.asarray(z["shared_w_in"]),
             "shared_w_out": jnp.asarray(z["shared_w_out"])}}
        with mesh:
            y, aux = jax.jit(lambda p, x: moe_block_sharded(
                p, x, cfg, mesh))(p, x)
        # probe: the same routing and capacity; expert e writes w * sum
        # relu(x)^2 (> 0) into column e, so a kept pair shows as nonzero
        d, e_pad = x.shape[-1], 16
        probe_cfg = dataclasses.replace(cfg, act="sq_relu", n_shared=0,
                                        d_ff=d)
        w_in = jnp.broadcast_to(jnp.eye(d), (e_pad, d, d))
        w_out = jnp.zeros((e_pad, d, d)).at[jnp.arange(e_pad), :,
                                             jnp.arange(e_pad)].set(1.0)
        with mesh:
            yp, _ = jax.jit(lambda p, x: moe_block_sharded(
                p, x, probe_cfg, mesh))({{"router": router, "w_in": w_in,
                                         "w_out": w_out}}, x)
        kept = np.asarray(yp).reshape(-1, d)[:, :e_pad] != 0
        xf = x.reshape(-1, d)
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
        _, top_e = jax.lax.top_k(probs, cfg.top_k)
        pairs = [(t, int(e)) for t, row in enumerate(np.asarray(top_e))
                 for e in row if not kept[t, int(e)]]
        out[name + "_out"] = np.asarray(y)
        out[name + "_aux"] = np.asarray(aux)
        out[name + "_drops"] = np.array(sorted(pairs), np.int64).reshape(-1, 2)
    np.savez({out_path!r}, **out)
    print("REPRO_OK")
"""


def test_moe_block_sharded_matches_repros(tmp_path):
    path = moe_inputs(tmp_path)
    out_path = os.path.join(tmp_path, "repro.npz")
    assert "REPRO_OK" in run_repro(REPRO_MOE.format(path=path,
                                                    out_path=out_path))
    want = np.load(out_path)
    results = spawn("moe_repro", tmp_path)
    for name in ("free", "drop"):
        got = by_data(results, f"{name}_out")
        assert row_close(got, want[f"{name}_out"], 1e-5), name
        for r in results:
            np.testing.assert_allclose(r[f"{name}_aux"],
                                       want[f"{name}_aux"], rtol=1e-5)
        drops = np.concatenate([r[f"{name}_drops"] for r in results
                                if int(r["data"]) >= 0])
        drops = np.unique(drops, axis=0) if len(drops) else drops
        np.testing.assert_array_equal(drops.reshape(-1, 2),
                                      want[f"{name}_drops"])
    assert len(want["drop_drops"]) > 0 and len(want["free_drops"]) == 0


def test_moe_block_sharded_matches_unsharded_with_grads(tmp_path):
    from repro_torch.models import moe as pm

    moe_inputs(tmp_path)
    results = spawn("moe_grads", tmp_path)
    cfg = moe_configs()["free"]
    z = np.load(os.path.join(tmp_path, "moe.npz"))
    p = {k: torch.from_numpy(z[k]).requires_grad_(True)
         for k in ("router", "w_in", "w_out", "shared_w_in",
                   "shared_w_out")}
    x = torch.from_numpy(z["x"])
    y, _ = pm.moe_block(p, x, cfg)
    assert row_close(by_data(results, "out"), y.detach().numpy(), 1e-5)
    # the sharded objective: mean(y^2) + the mean over data shards of each
    # shard's aux loss (repro's pmean)
    bl = X_SHAPE[0] // 2
    aux = sum(pm.moe_block(p, x[d * bl:(d + 1) * bl], cfg)[1]
              for d in range(2)) / 2
    loss = torch.mean(y ** 2) + aux
    loss.backward()
    for r in results:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-5)
    for k, v in p.items():
        g = v.grad.numpy()
        for r in results:
            if k in ("w_in", "w_out"):
                m, d, n = int(r["model"]), int(r["data"]), g.shape[1] // 2
                want = g[m * 4:(m + 1) * 4, d * n:(d + 1) * n]
            else:
                want = g
            assert leaf_close(r[f"grad_{k}"], want, 1e-5), k


def test_qwen2_moe_train_step_on_2x4_matches_unsharded(tmp_path):
    from repro.launch.steps import effective_accum as repro_accum
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.models.tp import serving_blocks
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves

    results = spawn("train", tmp_path)
    b = build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                   device="cpu", model_cfg=qwen_config())
    args = make_smoke_args(b, seed=0)
    _, grads = grad_accum_value_and_grad(b.loss, b.accum)(args[0], args[2])
    params, _, loss = b.fn(*args)

    class StandIn:
        shape, axis_names = {"data": 2, "model": 4}, ("data", "model")

    assert all(int(r["accum"]) == repro_accum(1, 2, StandIn())
               for r in results)
    lr_t = 1e-4 / 100                       # AdamW's warmup at step 0
    mesh = MeshShape((2, 4), ("data", "model"))
    bm = build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                    device="meta", model_cfg=qwen_config())
    bm.mesh = mesh
    specs = bm.executed_specs()[0]
    for r in results:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-5)
        assert int(r["gathers"]) > 0 and int(r["reduces"]) > 0
        coord = {"data": int(r["data"]), "model": int(r["model"])}
        # the rank's blocks: a gated leaf's as [gate_r | up_r]
        mine = serving_blocks(params, specs, mesh, "swiglu", coord)
        for path, want in leaves(mine):
            got = r[f"p{path}"]
            assert got.shape == tuple(want.shape), path
            np.testing.assert_allclose(got, want.detach().numpy(), rtol=0,
                                       atol=1e-5 + 2 * lr_t, err_msg=path)
        # AdamW's first step hides a gradient's scale: the gradients too,
        # each leaf within 1e-5 of its largest
        for path, want in leaves(serving_blocks(grads, specs, mesh,
                                                "swiglu", coord)):
            assert leaf_close(r[f"g{path}"], want.numpy(), 1e-5), path


def test_dlrm_row_sharded_tables_match_one_table(tmp_path):
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.recsys import dlrm_forward, dlrm_init, dlrm_loss
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves

    results = spawn("dlrm", tmp_path)
    cfg = dlrm_config()
    full = train_tree(dlrm_init(cfg, seed=0, device="cpu"))
    batch = dlrm_batch(False)
    with torch.no_grad():
        want = dlrm_forward(full, cfg, batch["dense"],
                            batch["sparse_ids"]).numpy()
    nan = np.isnan(want)
    assert nan[3] and nan[5] and nan.sum() == 2
    got = by_data(results, "logits")
    assert np.array_equal(got, want, equal_nan=True)      # bit for bit
    loss, grads = grad_accum_value_and_grad(
        lambda p, b: dlrm_loss(p, cfg, b), 1)(full, dlrm_batch(True))
    tables = {f"['tables']['table_{i}']": (v, v >= 4096)
              for i, v in enumerate(cfg.padded_table_sizes)}
    for r in results:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-6)
        m = int(r["model"])
        for path, g in leaves(grads):
            g = g.numpy()
            if path in tables and tables[path][1]:
                rows = tables[path][0] // 4
                want_g = g[m * rows:(m + 1) * rows]
            else:
                want_g = g
            assert leaf_close(r[f"g{path}"], want_g, 1e-6), path


def test_retrieval_on_the_mesh_matches_repros_rule(tmp_path):
    import jax.numpy as jnp

    from repro.kernels.topk_search.ref import topk_search_ref

    results = spawn("retrieval", tmp_path)
    batch = retrieval_batch()
    k = results[0]["s"].shape[1]
    assert k == 100
    s_ref, i_ref = topk_search_ref(jnp.asarray(batch["query"]),
                                   jnp.asarray(batch["candidates"]),
                                   jnp.asarray(batch["candidate_mask"]), k)
    for r in results:
        np.testing.assert_allclose(r["s"][0], np.asarray(s_ref)[0],
                                   rtol=1e-5, atol=1e-5)
        assert int(r["i"][0, 0]) == 7
        np.testing.assert_array_equal(r["i"], np.asarray(i_ref))


def test_device_fanout_on_the_mesh_is_bit_for_bit(tmp_path):
    results = spawn("fanout", tmp_path)
    for r in results:
        for n_shards in (8, 3):
            for k in (5, 40):
                one = [r[f"{n_shards}_{k}_one_{x}"] for x in "si"]
                for tag in ("mesh", "torch"):
                    for x, want in zip("si", one):
                        got = r[f"{n_shards}_{k}_{tag}_{x}"]
                        assert got.dtype == want.dtype
                        np.testing.assert_array_equal(got, want)


def test_collective_stats_of_recorded_calls(tmp_path):
    from repro.launch.hlo_analysis import _wire_bytes as repro_wire
    from repro_torch.launch.collectives import _wire_bytes

    results = spawn("collectives", tmp_path)
    # by hand: sum (3, 5) f32 over model (4 ranks); gather (2, 3) over data
    # (2) into (4, 3); mean of (4,) over data then model; the gather's
    # backward: an all-reduce of (4, 3) over data
    reduces = [(60, 4), (16, 2), (16, 4), (48, 2)]
    wire = sum(2.0 * b * (g - 1) / g for b, g in reduces)
    for b, g in reduces + [(48, 2)]:
        for op in ("all-reduce", "all-gather"):
            assert _wire_bytes(op, b, g) == repro_wire(op, b, g)
    for r in results:
        np.testing.assert_array_equal(r["a"], np.full((3, 5), 4.0))
        np.testing.assert_array_equal(r["b"], np.ones((4, 3)))
        np.testing.assert_array_equal(r["c"], np.ones(4))
        np.testing.assert_array_equal(r["dx"], np.full((2, 3), 2.0))
        np.testing.assert_array_equal(r["ar"], [4, 140, wire])
        np.testing.assert_array_equal(r["ag"], [1, 48, 24.0])
        np.testing.assert_array_equal(r["total"], [188, wire + 24.0])


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
