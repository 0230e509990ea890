"""The LM and recsys train cells on a mesh under repro's layouts: Megatron
tensor parallelism with its backward, the vocab-parallel loss, ZeRO-1
optimizer state (``train/zero``), the recsys rule's column-parallel MLPs
and row-sharded lookups, on 8 gloo ranks (a 2 x 4 ("data", "model") mesh
of CPU processes) and on one (a 1 x 1 mesh), against the port's
unsharded step and repro's.

One spawn of 8 ranks (this file run as a script, one process a rank,
meeting through a ``FileStore``; killed after ``TIMEOUT`` s; the ranks
import no JAX) runs every case through ``build_cell(..., mesh=)`` and
``shard_args`` and saves each rank's ZeRO blocks (``train/zero``) of its
params after one step, of its reduced gradients and of AdamW's m; the
test lays the blocks of all ranks back into whole tensors by their global
positions (``LeafLayout.runs``: a gated leaf's ``[gate_r | up_r]`` maps
back) and holds them to the references. The cases (fp32, the reduced
configs widened, per-layer remat on):

  - reduced Mistral-NeMo (kv 1: ``wk`` / ``wv`` a quarter head a rank,
    gathered), Nemotron-4 (ungated relu^2), Qwen1.5-32B (QKV biases),
    Qwen2-MoE (shared experts a "model" block, the experts
    expert-parallel; drop-free, no aux loss: the sharded aux is the mean
    of the data shards', another objective by design), Kimi-K2 (the
    same), and six heads of 16 over 3 kv heads (``wq`` cut mid-head);
  - DLRM (tables of >= 4096 rows row-sharded, the 256-wide MLP layers
    column-parallel), FM and Wide&Deep (row-sharded ``w`` / ``v`` and
    ``wide_w`` / ``embed``, Wide&Deep's deep MLP column-parallel) and
    BERT4Rec (the transformer's tensor parallelism, its ``wq`` cut
    mid-head), each also served on a batch with out-of-range ids.

The same spawn runs, on reduced Mistral-NeMo (and Kimi-K2 for
Adafactor), the optimizers alone on the same gradients (each rank's
blocks of the unsharded step's), and three mutations that a test must
catch: a replicated leaf's gradient not summed over "model", the
softmax's max not reduced over "model", a ZeRO block gathered out of
order. A second spawn of 1 rank holds every case on a 1 x 1 mesh to the
unsharded step bit for bit.

Tolerances:
  - against the unsharded port: loss within 1e-5 relative; every
    gradient leaf and AdamW's m within 1e-5 of the leaf's largest (a
    leaf of one element, a bias of the one output, is a sum over the
    batch whose terms cancel: it is held to 1e-5 of the tree's largest
    gradient, the size of one such term); the
    params within 1e-5 + 2 lr_t (AdamW's first step is about lr_t
    sign(g)); the sharded sums add per-rank partials where one GEMM sums
    in its own order;
  - against repro's unsharded step (ref mode, fp32): the fp32 train-cell
    rule of ``tests/test_torch_train_cells.py``: loss and every gradient
    leaf within 1e-4 of the leaf's largest;
  - DLRM: the served logits bit for bit at L = 1 (each bag one rank's
    row plus zeros), NaN bags included; gradients within 1e-6 of each
    leaf's largest; FM, Wide&Deep and BERT4Rec served within 1e-5 of
    each row's largest, NaN at the same places;
  - the AdamW ZeRO update on the same gradients: the replicated update
    bit for bit (params and m); Adafactor's within 1e-5 of the largest
    change of each leaf and of its accumulators;
  - world 1: bit for bit (loss, params, m).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESH = (2, 4)
TIMEOUT = 240          # seconds a spawn may take before its ranks are killed
SEED = 5
LR_T = 1e-4 / 100      # AdamW's warmup at step 0
LM = {"nemo": "mistral-nemo-12b", "nemotron": "nemotron-4-15b",
      "qwen15": "qwen1.5-32b", "qwen2moe": "qwen2-moe-a2.7b",
      "kimi": "kimi-k2-1t-a32b", "six_heads": "mistral-nemo-12b"}
RECSYS = {"dlrm": "dlrm-mlperf", "fm": "fm", "widedeep": "wide-deep",
          "bert4rec": "bert4rec"}
SHAPES = {**{c: "train_4k" for c in LM}, **{c: "train_batch"
                                            for c in RECSYS}}
ARCHS = {**LM, **RECSYS}
MUTATIONS = ("model_sum", "max", "zero_order")
# Adafactor's step 0 at lr 0.1 (no warmup): each change ~0.1 of an O(1)
# param, so one fp32 rounding of the param is far below 1e-5 of it
ADAFACTOR = dict(lr=0.1, warmup_steps=1)


def config(case: str):
    """The port's fp32 config of ``case``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as rm

    if case == "dlrm":
        return rm.DLRMConfig(n_sparse=5, embed_dim=16,
                             bot_mlp=(13, 256, 256, 16),
                             top_mlp=(256, 256, 1),
                             table_sizes=(5000, 40, 9000, 4096, 300))
    if case == "fm":
        return rm.FMConfig(n_sparse=6, embed_dim=10, vocab_per_field=1024)
    if case == "widedeep":
        return rm.WideDeepConfig(n_sparse=6, embed_dim=48, mlp=(256, 256),
                                 vocab_per_field=1024)
    cfg = get_arch(ARCHS[case]).model_config(True)
    if case == "bert4rec":
        return cfg
    cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=True)
    if case == "six_heads":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv=3)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0, router_aux_weight=0.0))
    return cfg


def params(case: str):
    """The seeded whole params of ``case`` as a train tree (CPU)."""
    from repro_torch.launch.steps import _INIT
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params

    init = _INIT.get(ARCHS[case], init_params)
    return train_tree(init(config(case), seed=SEED, device="cpu"))


def batch(case: str, serve: bool = False) -> dict:
    """The seeded whole batch of ``case``'s train cell (``serve``: the
    served batch, with ids out of range for the recsys archs)."""
    from repro_torch.launch.steps import build_cell, smoke_batch

    b = build_cell(ARCHS[case], SHAPES[case], reduced=True, device="cpu",
                   model_cfg=config(case))
    out = smoke_batch(b, SEED)
    if case == "dlrm":
        rng = np.random.default_rng(SEED)
        cfg = config(case)
        ids = np.stack([rng.integers(0, v, 32) for v in cfg.table_sizes],
                       1)[:, :, None].astype(np.int32)
        out["sparse_ids"] = torch.from_numpy(ids)
    if serve and case in ("dlrm", "fm", "widedeep"):
        key = "sparse_ids" if case == "dlrm" else "ids"
        ids = out[key].clone()
        flat = ids.reshape(ids.shape[0], -1)
        if case == "dlrm":
            flat[3, 0] = 5120                 # the padded size: NaN
            flat[5, 2] = 9216
            flat[7, 1] = -1                   # padding
        else:
            v = config(case).total_vocab
            flat[3, 0] = v                    # out of range: NaN
            flat[5, 2] = -1                   # wraps to V - 1
            flat[6, 1] = -v - 1               # out of range: NaN
        out[key] = ids
    return out


def serve(case: str, p, b, mesh=None):
    """The served logits of ``case`` (its forward)."""
    from repro_torch.models import recsys as rm
    from repro_torch.models.transformer import TPConfig

    cfg = config(case)
    bag = {} if mesh is None else {"mesh": mesh}
    with torch.no_grad():
        if case == "dlrm":
            if mesh is not None:
                bag["bag"] = rm.RowShardedBag(cfg, mesh)
            return rm.dlrm_forward(p, cfg, b["dense"], b["sparse_ids"],
                                   **bag)
        if case == "bert4rec":
            if mesh is not None:
                cfg = TPConfig.of(cfg, mesh)
            return rm.bert4rec_forward(p, cfg, b["tokens"])
        fwd = {"fm": rm.fm_forward, "widedeep": rm.widedeep_forward}[case]
        return fwd(p, cfg, b["ids"], **bag)


def step(case: str, mesh=None, p=None, b=None):
    """One train step of ``case`` (params ``p``, batch ``b``: whole, or
    a rank's blocks on ``mesh``): (loss, grads, params, opt_state)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    cell = build_cell(ARCHS[case], SHAPES[case], reduced=True, device="cpu",
                      model_cfg=config(case), mesh=mesh)
    specs = None if mesh is None else cell.executed_specs()[0]
    _, grads = grad_accum_value_and_grad(cell.loss, cell.accum, mesh,
                                         specs)(p, b)
    st = cell.opt.init(p)
    p, st, loss = cell.fn(p, st, b, torch.tensor(0, dtype=torch.int32))
    return loss, grads, p, st


# ---------------------------------------------------------------------------
# the spawns and the ranks (no JAX)
# ---------------------------------------------------------------------------
def start(mode: str, world: int, root) -> tuple:
    """Start ``mode`` on ``world`` ranks (returns what ``finish`` takes)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(r),
             str(world), str(root)], env=env, stdout=log,
            stderr=subprocess.STDOUT))
    return mode, root, procs, logs, time.monotonic() + TIMEOUT


def finish(run: tuple) -> list:
    """Wait for a ``start``ed run; returns each rank's arrays."""
    mode, root, procs, logs, deadline = run
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{mode}: a rank hung past {TIMEOUT} s")
    finally:
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        with open(os.path.join(root, f"rank{failed[0]}.log")) as f:
            pytest.fail(f"{mode}: ranks {failed} failed:\n{f.read()[-4000:]}")
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(len(procs))]


def spawn(mode: str, world: int, root) -> list:
    """Run ``mode`` on ``world`` ranks; returns each rank's arrays."""
    return finish(start(mode, world, root))


def _blocks(out: dict, prefix: str, tree, layout, zero: bool = True):
    """Save the ZeRO block (``zero``) or the whole of each leaf."""
    from repro_torch.train.tree import leaves

    for path, t in leaves(tree):
        t = t.detach()
        if zero:
            t = layout.leaf(path).zero_block(t)
        out[f"{prefix}{path}"] = t.contiguous().numpy()


def _save_step(out: dict, case: str, res, cell) -> None:
    from repro_torch.launch.steps import zero_layout

    loss, grads, p, st = res
    layout = zero_layout(cell)
    out[f"{case}|loss"] = loss.detach().numpy()
    _blocks(out, f"{case}|g", grads, layout)
    _blocks(out, f"{case}|p", p, layout)
    _blocks(out, f"{case}|m", st["m"], layout, zero=False)


def _mesh_case(case: str, mesh, out: dict) -> None:
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.steps import build_cell, shard_args

    cell = build_cell(ARCHS[case], SHAPES[case], reduced=True, device="cpu",
                      model_cfg=config(case), mesh=mesh)
    p, _, b, _ = shard_args(cell, (params(case), None, batch(case), None))
    _save_step(out, case, step(case, mesh, p, b), cell)
    if case in RECSYS:
        sb = distribute_tree(batch(case, serve=True),
                             cell.executed_specs()[1], mesh, copy=True)
        sp = shard_args(cell, (params(case), None, batch(case), None))[0]
        out[f"{case}|serve"] = serve(case, sp, sb, mesh).numpy()


def _optimizers(case: str, mesh, out: dict) -> None:
    """The ZeRO optimizers on this rank's blocks of the unsharded step's
    gradients: AdamW against the replicated update of the same blocks,
    bit for bit (flags); Adafactor's result saved."""
    from repro_torch.launch.mesh import coordinate
    from repro_torch.launch.steps import build_cell, zero_layout
    from repro_torch.models import tp
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.train_loop import grad_accum_value_and_grad
    from repro_torch.train.tree import leaves

    one = build_cell(ARCHS[case], SHAPES[case], reduced=True, device="cpu",
                     model_cfg=config(case))
    cell = build_cell(ARCHS[case], SHAPES[case], reduced=True, device="cpu",
                      model_cfg=config(case), mesh=mesh)
    full = params(case)
    _, grads = grad_accum_value_and_grad(one.loss, one.accum)(full,
                                                              batch(case))
    pspec = cell.executed_specs()[0]

    def blocks(tree):
        return tp.serving_blocks(tree, pspec, mesh, config(case).act)

    step0 = torch.tensor(0, dtype=torch.int32)
    if case == "nemo":
        layout = zero_layout(cell, "adamw")
        g = blocks(grads)
        pz, pr = blocks(full), blocks(full)
        zero, rep = adamw(layout=layout), adamw()
        sz = zero.init(pz)
        sr = rep.init(pr)
        zero.update(g, sz, pz, step0)
        rep.update(g, sr, pr, step0)
        same = [torch.equal(a, b) for (_, a), (_, b) in
                zip(leaves(pz), leaves(pr))]
        same += [torch.equal(a, layout.leaf(path).zero_block(b))
                 for (path, a), (_, b) in zip(leaves(sz["m"]),
                                              leaves(sr["m"]))]
        out["adamw_bits"] = np.array(same)
    layout = zero_layout(cell, "adafactor")
    pz = blocks(full)
    opt = adafactor(layout=layout, **ADAFACTOR)
    st = opt.init(pz)
    opt.update(blocks(grads), st, pz, step0)
    _blocks(out, f"{case}|ada_p", pz, layout)
    for path, t in leaves(st):
        out[f"{case}|ada_s{path}"] = t.numpy()
    if not any(coordinate(mesh).values()):        # rank 0: the gradients
        _blocks(out, f"{case}|ada_g", grads, None, zero=False)


def _mutations(mesh, out: dict) -> None:
    """Reduced Mistral-NeMo's step under each of ``MUTATIONS``."""
    from repro_torch.launch import collectives as col
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.train import zero

    case = "nemo"
    real = (shd.replicated_axes, col.all_reduce_max,
            zero.ZeroLayout.gather_back)

    def model_unsummed(spec, m):
        axes = real[0](spec, m)
        if not any(shd._axes(e) for e in spec):        # replicated leaf
            axes = tuple(a for a in axes if a != "model")
        return axes

    def local_max(t, m, axes):
        return t.detach().clone()

    def out_of_order(self, p, lf):
        if lf.dim is None:
            return
        whole = col.all_gather(lf.zero_block(p).contiguous(), self.mesh,
                               lf.axes, dim=lf.dim)
        p.copy_(torch.cat(whole.split(lf.width, lf.dim)[::-1], lf.dim))

    patches = {"model_sum": (shd, "replicated_axes", model_unsummed),
               "max": (col, "all_reduce_max", local_max),
               "zero_order": (zero.ZeroLayout, "gather_back",
                              out_of_order)}
    for name in MUTATIONS:
        owner, attr, fn = patches[name]
        old = getattr(owner, attr)
        setattr(owner, attr, fn)
        try:
            cell = build_cell(ARCHS[case], SHAPES[case], reduced=True,
                              device="cpu", model_cfg=config(case),
                              mesh=mesh)
            p, _, b, _ = shard_args(cell, (params(case), None, batch(case),
                                           None))
            _save_step(out, f"mut_{name}", step(case, mesh, p, b), cell)
        finally:
            setattr(owner, attr, old)


def _world1(mesh, out: dict) -> None:
    """Every case on the 1 x 1 mesh against no mesh, bit for bit."""
    from repro_torch.launch.steps import build_cell, shard_args
    from repro_torch.train.tree import leaves

    for case in ARCHS:
        cell = build_cell(ARCHS[case], SHAPES[case], reduced=True,
                          device="cpu", model_cfg=config(case), mesh=mesh)
        p, _, b, _ = shard_args(cell, (params(case), None, batch(case),
                                       None))
        got = step(case, mesh, p, b)
        want = step(case, None, params(case), batch(case))
        same = [torch.equal(got[0], want[0])]
        for i in (1, 2):
            same += [torch.equal(x, y) for (_, x), (_, y) in
                     zip(leaves(got[i]), leaves(want[i]))]
        same += [torch.equal(x, y) for (_, x), (_, y) in
                 zip(leaves(got[3]["m"]), leaves(want[3]["m"]))]
        out[f"{case}|bits"] = np.array(same)


def _rank_main(mode: str, rank: str, world: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import coordinate, make_host_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"),
                                     int(world)),
        rank=int(rank), world_size=int(world))
    try:
        if mode == "world1":
            mesh = make_host_mesh(1, 1, device_type="cpu")
            out = {}
            _world1(mesh, out)
        else:
            mesh = make_host_mesh(*MESH, device_type="cpu")
            c = coordinate(mesh)
            out = {"data": np.int64(c["data"]),
                   "model": np.int64(c["model"])}
            for case in ARCHS:
                _mesh_case(case, mesh, out)
            for case in ("nemo", "kimi"):
                _optimizers(case, mesh, out)
            _mutations(mesh, out)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references (this process)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns, run at once; the references are computed while the
    ranks run."""
    runs = [start("mesh", MESH[0] * MESH[1], tmp_path_factory.mktemp("m")),
            start("world1", 1, tmp_path_factory.mktemp("w"))]
    for case in ARCHS:
        unsharded(case)
        repro_grads(case)
    return [finish(run) for run in runs]


@pytest.fixture(scope="module")
def mesh_results(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def world1_results(spawned):
    return spawned[1][0]


@functools.lru_cache(maxsize=None)
def unsharded(case: str):
    """The port's one-card step of ``case``: (loss, grads, params, m) as
    numpy, by path."""
    from repro_torch.train.tree import leaves

    loss, grads, p, st = step(case, None, params(case), batch(case))
    return (float(loss), {k: v.numpy() for k, v in leaves(grads)},
            {k: v.detach().numpy() for k, v in leaves(p)},
            {k: v.numpy() for k, v in leaves(st["m"])})


@functools.lru_cache(maxsize=None)
def layout(case: str, data: int, model: int, opt: str = "adamw"):
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_cell, zero_layout

    cell = build_cell(ARCHS[case], SHAPES[case], reduced=True,
                      device="meta", model_cfg=config(case))
    return zero_layout(cell, opt, MeshShape(MESH, ("data", "model")),
                       {"data": data, "model": model})


def assemble(results, case: str, kind: str, opt: str = "adamw",
             replicas: list = None) -> dict:
    """The whole tensors of ``kind`` ("p", "g", "m", "ada_p") from every
    rank's ZeRO blocks, each laid at its global positions; ranks that
    hold the same block must hold the same bits (else the leaf's path is
    put in ``replicas``, or the call fails)."""
    out = {}
    for r in results:
        lay = layout(case, int(r["data"]), int(r["model"]), opt)
        for path, lf in lay._leaves.items():
            blk = r[f"{case}|{kind}{path}"]
            whole = out.setdefault(path, np.full(lf.shape, np.nan,
                                                 blk.dtype))
            idx = np.ix_(*[np.concatenate([np.arange(lo, hi)
                                           for lo, hi in runs])
                           for runs in lf.runs])
            held = whole[idx]
            seen = ~np.isnan(held)
            if not np.array_equal(held[seen], blk[seen]):
                assert replicas is not None, (case, kind, path)
                replicas.append(path)
            whole[idx] = blk
    for path, whole in out.items():
        assert not np.isnan(whole).any(), (case, kind, path)
    return out


def leaf_ratio(got, want, rel, scale=None) -> float:
    """The largest |got - want| over ``rel`` of the leaf's largest (or of
    ``scale``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = float(np.abs(want).max(initial=0.0))
    scale = rel * scale
    err = float(np.abs(got - want).max(initial=0.0))
    return 0.0 if err == 0 else err / max(scale, 1e-30)


def held_to_unsharded(results, case: str, grad_rel: float = 1e-5) -> dict:
    """The mesh's step of ``case`` against the unsharded port's by the
    module's rules; returns the worst ratio to its limit of each kind."""
    loss, grads, p, m = unsharded(case)
    worst = {}
    for r in results:
        rel = abs(float(r[f"{case}|loss"]) - loss) / abs(loss)
        worst["loss"] = max(worst.get("loss", 0.0), rel / 1e-5)
    top = max(float(np.abs(g).max()) for g in grads.values())
    got = assemble(results, case, "g")
    worst["grad"] = max(leaf_ratio(got[k], grads[k], grad_rel,
                                   top if grads[k].size == 1 else None)
                        for k in grads)
    got = assemble(results, case, "m")
    worst["m"] = max(leaf_ratio(got[k], m[k], 1e-5,
                                0.1 * top if m[k].size == 1 else None)
                     for k in m)
    got = assemble(results, case, "p")
    worst["param"] = max(float(np.abs(got[k].astype(np.float64) - p[k])
                               .max(initial=0.0)) / (1e-5 + 2 * LR_T)
                         for k in p)
    return worst


@functools.lru_cache(maxsize=None)
def repro_grads(case: str):
    """repro's unsharded loss and gradients of ``case`` (fp32, ref mode),
    by path."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as repro_arch
    from repro.models import recsys as rr
    from repro.models import transformer as rt
    from repro_torch.models.bridge import tree_to_numpy

    cfg = config(case)
    if case in ("dlrm", "fm", "widedeep"):
        cls = {"dlrm": rr.DLRMConfig, "fm": rr.FMConfig,
               "widedeep": rr.WideDeepConfig}[case]
        rcfg = cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg) if f.name != "dtype"})
        loss = {"dlrm": rr.dlrm_loss, "fm": rr.fm_loss,
                "widedeep": rr.widedeep_loss}[case]

        def fn(p, b):
            return loss(p, rcfg, b)
    elif case == "bert4rec":
        rcfg = repro_arch(ARCHS[case]).model_config(True)

        def fn(p, b):
            return rr.bert4rec_loss(p, rcfg, b)
    else:
        rcfg = dataclasses.replace(repro_arch(ARCHS[case]).model_config(True),
                                   dtype=jnp.float32, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_kv)
        if rcfg.moe is not None:
            rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
                rcfg.moe, capacity_factor=16.0, router_aux_weight=0.0))

        def fn(p, b):
            return rt.loss_fn(p, b, rcfg)
    rp = jax.tree.map(jnp.asarray, tree_to_numpy(params(case)))
    rb = {k: jnp.asarray(v.numpy()) for k, v in batch(case).items()}
    loss, grads = jax.jit(jax.value_and_grad(fn))(rp, rb)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    return float(loss), {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in flat}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(LM))
def test_lm_train_step_on_2x4_matches_unsharded(mesh_results, case):
    worst = held_to_unsharded(mesh_results, case)
    assert all(v <= 1.0 for v in worst.values()), worst


@pytest.mark.parametrize("case", list(RECSYS))
def test_recsys_train_step_on_2x4_matches_unsharded(mesh_results, case):
    worst = held_to_unsharded(mesh_results, case,
                              1e-6 if case == "dlrm" else 1e-5)
    assert all(v <= 1.0 for v in worst.values()), worst


@pytest.mark.parametrize("case", list(ARCHS))
def test_train_step_on_2x4_matches_repro(mesh_results, case):
    """The fp32 train-cell rule: loss and each gradient leaf within 1e-4
    of the leaf's largest."""
    loss, grads = repro_grads(case)
    for r in mesh_results:
        assert abs(float(r[f"{case}|loss"]) - loss) <= 1e-4 * abs(loss)
    got = assemble(mesh_results, case, "g")
    assert sorted(got) == sorted(grads)
    for path, want in grads.items():
        assert leaf_ratio(got[path], want, 1e-4) <= 1.0, path


@pytest.mark.parametrize("case", list(RECSYS))
def test_recsys_served_on_2x4(mesh_results, case):
    """The forward on a batch with ids out of range: DLRM bit for bit
    (NaN bags included); the others within 1e-5 of each row's largest,
    NaN at the same places."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.steps import build_cell

    want = serve(case, params(case), batch(case, serve=True)).numpy()
    cell = build_cell(ARCHS[case], SHAPES[case], reduced=True,
                      device="meta", model_cfg=config(case))
    cell.mesh = MeshShape(MESH, ("data", "model"))
    spec = cell.executed_specs()[1]
    lead = next(iter(spec.values()))
    if case != "bert4rec":
        assert np.isnan(want).sum() == 2, np.isnan(want).sum()
    for r in mesh_results:
        coord = {"data": int(r["data"]), "model": int(r["model"])}
        rows = distribute_tree(torch.from_numpy(want), type(lead)(
            lead[0], *([None] * (want.ndim - 1))), cell.mesh, coord).numpy()
        got = r[f"{case}|serve"]
        assert got.shape == rows.shape
        if case == "dlrm":
            assert np.array_equal(got, rows, equal_nan=True)
            continue
        nan = np.isnan(rows)
        assert np.array_equal(np.isnan(got), nan)
        g, w = (np.where(nan, 0.0, x).astype(np.float64).reshape(
            rows.shape[0], -1) for x in (got, rows))
        scale = np.abs(w).max(-1, keepdims=True)
        assert (np.abs(g - w) <= 1e-5 * scale).all()


@pytest.mark.parametrize("case", list(ARCHS))
def test_world1_mesh_step_is_bit_for_bit(world1_results, case):
    """On a 1 x 1 mesh (every collective a copy, the loss the one-card
    loss, no ZeRO split) the step is the unsharded one: loss, gradients,
    params and m bit for bit."""
    bits = world1_results[f"{case}|bits"]
    assert bits.all(), np.where(~bits)[0]


def test_adamw_zero_update_is_the_replicated_one(mesh_results):
    """Given the same gradients (each rank's blocks of the unsharded
    step's), every rank's ZeRO-1 AdamW update equals the replicated
    update of its blocks bit for bit: params and m."""
    for r in mesh_results:
        bits = r["adamw_bits"]
        assert len(bits) > 20 and bits.all(), np.where(~bits)[0]


@pytest.mark.parametrize("case", ["nemo", "kimi"])
def test_adafactor_on_2x4_matches_unsharded(mesh_results, case):
    """Adafactor passed explicitly on the mesh: its row and column means
    and its RMS clip summed over the axes that split each block. Given
    the same gradients (rank 0's whole ones) and ``ADAFACTOR``'s
    settings, each leaf's change and its accumulators within 1e-5 of
    their largest."""
    from repro_torch.train.optimizer import adafactor
    from repro_torch.train.tree import leaves, unflatten

    full = params(case)
    before = {k: v.clone() for k, v in leaves(full)}
    g0 = mesh_results[0]
    grads = {k: torch.from_numpy(g0[f"{case}|ada_g{k}"]) for k in before}
    opt = adafactor(**ADAFACTOR)
    st = opt.init(full)
    opt.update(unflatten(full, [grads[k] for k, _ in leaves(full)]), st,
               full, torch.tensor(0, dtype=torch.int32))
    after = dict(leaves(full))
    got = assemble(mesh_results, case, "ada_p", "adafactor")
    for k, b in before.items():
        change = (after[k] - b).numpy().astype(np.float64)
        mine = got[k].astype(np.float64) - b.numpy()
        assert np.abs(change).max() > 0, k
        assert leaf_ratio(mine, change, 1e-5) <= 1.0, k
    want = dict(leaves(st))
    for r in mesh_results:
        lay = layout(case, int(r["data"]), int(r["model"]), "adafactor")
        for path, t in want.items():
            spec = lay.state_spec(path)
            block = t[lay.local_slice(tuple(t.shape), spec)].numpy()
            assert leaf_ratio(r[f"{case}|ada_s{path}"], block, 1e-5) <= \
                1.0, path


@pytest.mark.parametrize("name", MUTATIONS)
def test_mutation_is_caught(mesh_results, name):
    """Each mutation of reduced Mistral-NeMo's mesh step fails the
    unsharded rule that the step itself passes: a replicated leaf's
    gradient not summed over "model" (the grads), the softmax's max not
    reduced (the loss), a ZeRO block gathered out of order (the
    params)."""
    real = held_to_unsharded(mesh_results, "nemo")
    assert all(v <= 1.0 for v in real.values()), real
    key = {"model_sum": "grad", "max": "loss", "zero_order": "param"}[name]
    loss, grads, p, _ = unsharded("nemo")
    results = [{k.replace(f"mut_{name}|", "nemo|"): v for k, v in r.items()
                if k.startswith(f"mut_{name}|") or "|" not in k}
               for r in mesh_results]
    if key == "loss":
        worst = max(abs(float(r["nemo|loss"]) - loss) / abs(loss) / 1e-5
                    for r in results)
    elif key == "grad":
        apart = []                     # replicas that hold other values
        got = assemble(results, "nemo", "g", replicas=apart)
        worst = max(leaf_ratio(got[k], grads[k], 1e-5) for k in grads)
        assert apart and all("['layers']['ln" in k or k == "['final_ln']"
                             for k in apart), apart
    else:
        got = assemble(results, "nemo", "p")
        worst = max(float(np.abs(got[k].astype(np.float64) - p[k]).max())
                    / (1e-5 + 2 * LR_T) for k in p)
    assert worst > 1.0, (name, worst)


def test_optimizer_state_is_made_at_its_zero_blocks(mesh_results):
    """AdamW's m on each rank has its ZeRO block's shape (the rank's
    param block cut over "data" on repro's ZeRO dimension): at 2 x 4,
    1/8 of each leaf that both axes split, never a whole leaf that the
    mesh splits."""
    from repro_torch.launch.sharding import local_shape

    for case in ARCHS:
        for r in mesh_results:
            lay = layout(case, int(r["data"]), int(r["model"]))
            for path, lf in lay._leaves.items():
                m = r[f"{case}|m{path}"]
                spec = lay.state_spec(f"['m']{path}")
                assert m.shape == local_shape(lf.shape, spec, lay.mesh) == \
                    lf.zero_shape(), (case, path)
        nemo = layout("nemo", 0, 0)
        assert nemo.leaf("['layers']['mlp']['win']").zero_shape() == \
            (2, 32, 64)                   # (L, D / data, 2 F / model)


def test_vocab_parallel_cross_entropy_matches_the_whole_loss():
    """Four vocab blocks' losses, with the max and sums done by hand over
    the blocks, equal the one-card loss within 1e-6 relative, ignored
    labels included, and their gradients the whole logits' gradient;
    the loss with each block's own max does not."""
    from repro_torch.models import tp
    from repro_torch.models.layers import cross_entropy_loss

    gen = torch.Generator().manual_seed(3)
    b, s, v, n = 2, 5, 64, 4
    logits = (torch.randn(b, s, v, generator=gen) * 4).requires_grad_(True)
    labels = torch.randint(0, v, (b, s), generator=gen)
    labels[0, 1] = labels[1, 4] = -1
    want = cross_entropy_loss(logits, labels)
    want.backward()
    gw, w = logits.grad.clone(), v // n
    blocks = [logits.detach()[..., i * w:(i + 1) * w].clone()
              .requires_grad_(True) for i in range(n)]
    maxes = [t.detach().amax(-1) for t in blocks]
    m_all = torch.stack(maxes).amax(0)

    # block i's loss through tp's function, each reduction over the four
    # blocks done by adding the other blocks' (detached) terms to its own
    def loss_of(i, own_max=False):
        m_i = maxes[i] if own_max else m_all
        others = [j for j in range(n) if j != i]
        calls = []

        def reduce_sum(t):
            k = len(calls)
            calls.append(k)
            extra = 0.0
            for j in others:
                mj = maxes[j] if own_max else m_all
                x = blocks[j].detach().float()
                if k == 0:
                    extra = extra + torch.exp(x - mj[..., None]).sum(-1)
                else:
                    local = labels - j * w
                    mine = (local >= 0) & (local < w)
                    g = torch.gather(x, -1,
                                     local.clamp(0, w - 1)[..., None])[..., 0]
                    extra = extra + torch.where(mine, g, 0.0)
            return t + extra

        return tp.vocab_parallel_cross_entropy(blocks[i], labels, i * w,
                                               reduce_sum, lambda t: m_i)

    for t in blocks:
        t.grad = None
    losses = [loss_of(i) for i in range(n)]
    for i, l in enumerate(losses):
        assert abs(float(l) - float(want)) <= 1e-6 * abs(float(want))
        l.backward()
        torch.testing.assert_close(blocks[i].grad,
                                   gw[..., i * w:(i + 1) * w],
                                   rtol=1e-5, atol=1e-7)
    wrong = [float(loss_of(i, own_max=True)) for i in range(n)]
    assert max(abs(x - float(want)) for x in wrong) > 1e-3


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
