"""SchNet's train cells on a mesh (``build_cell("schnet", shape,
mesh=)``: the edges split over every axis, the node rows over the data
axis, params and AdamW state replicated) on 8 gloo ranks (a 2 x 4
("data", "model") mesh of CPU processes) and on one (1 x 1), against the
port's unsharded step and repro's ``_gnn_bundle`` step jitted with its
``shard_fn(mesh)`` shardings on 8 forced host devices ("ref" mode, as
``tests/test_distributed.py`` runs repro's sharded steps). Also the two
repairs that came with it: ``kernels/segment_sum.take`` (the recsys
lookups' and the atom embedding's row gather, its gradient through
``gather_segment_sum``) against ``jax.grad`` of ``jnp.take``, and the
collective record, one a process: a remat step and SchNet's mesh step
counted by hand.

One spawn of 8 ranks and one of 1 (this file run as a script, one
process a rank, meeting through a ``FileStore``; killed after
``TIMEOUT`` s; the ranks import no JAX) run the four reduced cells,
molecule, full_graph_sm, minibatch_lg and ogb_products, while this
process computes the unsharded step and repro's sharded one.

Tolerances (fp32):
  - world 1: bit for bit (loss, gradients, params and AdamW's m after
    one step): every collective a copy, the rank's body the one-card
    code;
  - 8 ranks against the unsharded port: loss within 1e-5 relative; each
    gradient leaf and m within 1e-5 of the leaf's largest; params within
    1e-5 + 2 lr_t (AdamW's first step is about lr_t sign(g)). The ranks
    sum their edges' partial aggregates, and each leaf's gradient parts,
    in another order than one card's sums: rounding only;
  - against repro's sharded step: the fp32 train-cell rule of
    ``tests/test_torch_train_cells.py``, loss and each m leaf (the
    gradient times 1 - b1) within 1e-4 of the leaf's largest; params
    within 1e-4 + 2 lr_t;
  - every rank's loss equal, and its replicated params and m equal to
    rank 0's bit for bit (the same reduced gradients, the same update).
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESH = (2, 4)
TIMEOUT = 240          # seconds a spawn may take before its ranks are killed
SEED = 7
LR_T = 1e-4 / 100      # AdamW's warmup at step 0
SHAPES = ("molecule", "full_graph_sm", "minibatch_lg", "ogb_products")
LEAVES = 9             # SchNet's param leaves: 6 stacked, input, 2 head


def cell(shape: str, mesh=None, device: str = "cpu"):
    from repro_torch.launch.steps import build_cell
    return build_cell("schnet", shape, reduced=True, device=device,
                      mesh=mesh)


def params(shape: str):
    """The seeded whole params of ``shape``'s cell (CPU)."""
    from repro_torch.models.schnet import init_params
    return init_params(cell(shape).model_cfg, seed=SEED, device="cpu")


def batch(shape: str) -> dict:
    """The seeded whole batch (``make_smoke_args``'s: repro's too)."""
    from repro_torch.launch.steps import smoke_batch
    return smoke_batch(cell(shape), SEED)


def step(shape: str, mesh=None, p=None, b=None):
    """One train step of ``shape`` (params ``p``, batch ``b``: whole, or
    a rank's blocks on ``mesh``): (loss, grads, params, m), and the
    collective record of the step (its ``fn`` alone)."""
    from repro_torch.launch import collectives as col
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    c = cell(shape, mesh)
    specs = None if mesh is None else c.executed_specs()[0]
    _, grads = grad_accum_value_and_grad(c.loss, 1, mesh, specs)(p, b)
    st = c.opt.init(p)
    col.take_records()
    p, st, loss = c.fn(p, st, b, torch.tensor(0, dtype=torch.int32))
    return (loss, grads, p, st["m"]), col.take_records()


# ---------------------------------------------------------------------------
# the spawns and the ranks (no JAX)
# ---------------------------------------------------------------------------
def start(mode: str, world: int, root) -> tuple:
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


def _save(out: dict, key: str, res, recs) -> None:
    from repro_torch.launch.collectives import collective_stats
    from repro_torch.train.tree import leaves

    loss, grads, p, m = res
    out[f"{key}|loss"] = loss.detach().numpy()
    for kind, tree in (("g", grads), ("p", p), ("m", m)):
        for path, t in leaves(tree):
            out[f"{key}|{kind}{path}"] = t.detach().numpy()
    stats = collective_stats(recs)
    for op in ("all-gather", "all-reduce"):
        out[f"{key}|{op}"] = np.array([stats[op]["count"],
                                       stats[op]["bytes"]])


def _remat_on_a_thread(mesh, out: dict) -> None:
    """A block under ``torch.utils.checkpoint`` holding one all-reduce
    over "model" and one all-gather over "data" and ending in a tanh
    (which saves its output: the backward recomputes the whole block),
    its backward run on another thread (as autograd's device thread runs
    it on the card): the record of the process holds the forward's two
    calls, the recompute's two and the backward's two all-reduces."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.launch import collectives as col

    w = torch.ones(4, 3, requires_grad=True)

    def block(x):
        y = col.all_reduce_sum(x * 2.0, mesh, "model")
        return col.all_gather(y, mesh, "data", dim=0).tanh()

    col.take_records()
    loss = checkpoint(block, w, use_reentrant=False).square().sum()
    t = threading.Thread(target=loss.backward)
    t.start()
    t.join()
    stats = col.collective_stats(col.take_records())
    out["remat"] = np.array([stats["all-reduce"]["count"],
                             stats["all-gather"]["count"],
                             stats["all-reduce"]["bytes"],
                             stats["all-gather"]["bytes"]])


def _rank_main(mode: str, rank: str, world: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import shard_args

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"),
                                     int(world)),
        rank=int(rank), world_size=int(world))
    try:
        shape = MESH if mode == "mesh" else (1, 1)
        mesh = make_host_mesh(*shape, device_type="cpu")
        out = {}
        for s in SHAPES:
            c = cell(s, mesh)
            p, _, b, _ = shard_args(c, (params(s), None, batch(s), None))
            _save(out, s, *step(s, mesh, p, b))
        if mode == "mesh":
            _remat_on_a_thread(mesh, out)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references (this process)
# ---------------------------------------------------------------------------
REPRO = """
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.launch import sharding as shd
from repro.launch.compat import AxisType, make_mesh
from repro.launch.steps import build_cell, make_smoke_args
mesh = make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for shape in SHAPES:
    b = build_cell("schnet", shape, reduced=True)
    params, opt, batch, step = make_smoke_args(b, seed=SEED)
    given = np.load(f"{ROOT}/params_{shape}.npz")
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: given[jax.tree_util.keystr(p)], params)
    in_sh = jax.tree.map(lambda s: shd.named(mesh, s), b.sharding_fn(mesh),
                         is_leaf=lambda x: isinstance(x, P))
    with mesh:
        fn = jax.jit(b.fn, in_shardings=in_sh,
                     out_shardings=(in_sh[0], in_sh[1], None))
        args = jax.tree.map(jax.device_put, (params, opt, batch, step), in_sh)
        p, o, loss = fn(*args)
    out[f"{shape}|loss"] = np.asarray(loss)
    for kind, tree in (("p", p), ("m", o["m"])):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{shape}|{kind}{jax.tree_util.keystr(path)}"] = np.asarray(a)
np.savez(f"{ROOT}/repro.npz", **out)
print("REPRO_OK")
"""


def start_repro(root) -> subprocess.Popen:
    """repro's sharded steps on 8 forced host devices, in a subprocess
    (started now; ``finish_repro`` reads them)."""
    from repro_torch.train.tree import leaves

    for s in SHAPES:
        np.savez(os.path.join(root, f"params_{s}.npz"),
                 **{k: v.numpy() for k, v in leaves(params(s))})
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_KERNEL_MODE="ref",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"SHAPES = {SHAPES!r}\nSEED = {SEED}\nROOT = {str(root)!r}\n" \
        + textwrap.dedent(REPRO)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns and repro's run at once; the unsharded steps are
    computed while they run."""
    root = tmp_path_factory.mktemp("repro")
    repro = start_repro(root)
    runs = [start("mesh", MESH[0] * MESH[1], tmp_path_factory.mktemp("m")),
            start("world1", 1, tmp_path_factory.mktemp("w"))]
    for s in SHAPES:
        unsharded(s)
    try:
        text, err = repro.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        repro.kill()
        repro.communicate()
        pytest.fail(f"repro's sharded steps hung past {TIMEOUT} s")
    assert repro.returncode == 0 and "REPRO_OK" in text, err[-4000:]
    out = [finish(run) for run in runs]
    return out[0], out[1][0], dict(np.load(os.path.join(root,
                                                        "repro.npz")))


_UNSHARDED: dict = {}


def unsharded(shape: str):
    """The port's one-card step of ``shape``: (loss, grads, params, m) as
    numpy, by path."""
    from repro_torch.train.tree import leaves

    if shape not in _UNSHARDED:
        (loss, grads, p, m), _ = step(shape, None, params(shape),
                                      batch(shape))
        _UNSHARDED[shape] = (float(loss),
                             *({k: v.detach().numpy() for k, v in
                                leaves(t)} for t in (grads, p, m)))
    return _UNSHARDED[shape]


def ratio(got, want, rel: float, add: float = 0.0) -> float:
    """The largest |got - want| over rel x the leaf's largest |want| (+
    ``add``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = rel * float(np.abs(want).max(initial=0.0)) + add
    err = float(np.abs(got - want).max(initial=0.0))
    return 0.0 if err == 0 else err / max(lim, 1e-30)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_world1_step_is_the_unsharded_step_bit_for_bit(spawned, shape):
    r = spawned[1]
    loss, grads, p, m = unsharded(shape)
    assert float(r[f"{shape}|loss"]) == loss
    for kind, want in (("g", grads), ("p", p), ("m", m)):
        for path, a in want.items():
            assert np.array_equal(r[f"{shape}|{kind}{path}"], a), \
                (kind, path)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_step_matches_the_unsharded_port(spawned, shape):
    ranks = spawned[0]
    loss, grads, p, m = unsharded(shape)
    for r in ranks:
        assert abs(float(r[f"{shape}|loss"]) - loss) <= 1e-5 * abs(loss)
        for path in grads:
            assert ratio(r[f"{shape}|g{path}"], grads[path], 1e-5) <= 1, path
            assert ratio(r[f"{shape}|m{path}"], m[path], 1e-5) <= 1, path
            assert ratio(r[f"{shape}|p{path}"], p[path], 0.0,
                         1e-5 + 2 * LR_T) <= 1, path
        for key in r:                  # replicated: every rank rank 0's
            if key.startswith(f"{shape}|"):
                assert np.array_equal(r[key], ranks[0][key]), key


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_step_matches_repros_sharded_step(spawned, shape):
    ranks, _, repro = spawned
    want_loss = float(repro[f"{shape}|loss"])
    r = ranks[0]
    assert abs(float(r[f"{shape}|loss"]) - want_loss) <= 1e-4 * abs(
        want_loss)
    paths = [k.split("|m", 1)[1] for k in repro if k.startswith(f"{shape}|m")]
    assert len(paths) == LEAVES
    for path in paths:
        assert ratio(r[f"{shape}|m{path}"], repro[f"{shape}|m{path}"],
                     1e-4) <= 1, path
        assert ratio(r[f"{shape}|p{path}"], repro[f"{shape}|p{path}"], 0.0,
                     1e-4 + 2 * LR_T) <= 1, path


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_step_collectives_by_hand(spawned, shape):
    """SchNet's step on 2 x 4, counted by hand: forward, the node rows'
    all-gather over "data" and one all-reduce over "data" and one over
    "model" a layer (the aggregate), the readout's sums over "data"
    (molecule: the energies; node classes: the masked sum and the count);
    backward, each of those but the count once more, the gather's as an
    all-reduce; the loss's mean over "data"; each of the 9 replicated
    gradient leaves over "data" and "model". The chunks' recompute
    (``torch.utils.checkpoint``) holds no collective."""
    from repro_torch.train.tree import leaves

    c = cell(shape)
    b = batch(shape)
    layers = c.model_cfg.n_interactions
    molecule = "atom_z" in b
    agg = 4 * b["graph_ids" if molecule else "labels"].shape[0] \
        * c.model_cfg.d_hidden                     # an (N, d) fp32 array
    grad_bytes = sum(4 * t.numel() for _, t in leaves(params(shape)))
    readout = 1 if molecule else 2                 # forward's calls
    readout_bytes = 2 * 4 * b["energy"].shape[0] if molecule else 3 * 4
    reduces = 2 * layers + readout + (2 * layers + 1) + 1 + 1 + 2 * LEAVES
    nbytes = 4 * layers * agg + agg + readout_bytes + 4 + 2 * grad_bytes
    for r in spawned[0]:
        assert list(r[f"{shape}|all-gather"]) == [1, agg]
        assert list(r[f"{shape}|all-reduce"]) == [reduces, nbytes]


def test_remat_recompute_lands_in_the_process_record(spawned):
    """The checkpointed block's backward on another thread: 2 all-reduces
    and an all-gather forward, the same again recomputed, and the two
    backwards (the sum's and the gather's reduce-scatter as an
    all-reduce): 4 all-reduces and 2 all-gathers in the process's
    record, where a record a thread held only the forward's."""
    for r in spawned[0]:
        ar, ag, ar_bytes, ag_bytes = r["remat"]
        assert (ar, ag) == (4, 2)
        assert ag_bytes == 2 * 4 * (2 * 4 * 3)
        assert ar_bytes == 3 * 4 * (4 * 3) + 4 * (2 * 4 * 3)


@pytest.mark.parametrize("width", [None, 3], ids=["1d", "2d"])
def test_take_gradient_matches_jnp_take(width):
    """``kernels/segment_sum.take`` (``recsys.lookup``'s row gather, also
    the atom embedding's) of a (V,) or (V, 3) table at (4, 5) ids, some
    repeated, some in [-V, -1] (row id + V), some out of range (NaN
    rows, adding to no row): the rows and the gradient of a weighted sum
    against ``jax.grad`` of ``jnp.take``, bit for bit (each row's terms
    summed in id order, as XLA's scatter on the CPU)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.kernels.segment_sum import take
    from repro_torch.models.recsys import lookup

    rng = np.random.default_rng(3)
    v = 11
    shape = (v,) if width is None else (v, width)
    table = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, v, (4, 5)).astype(np.int32)
    ids[0, :3] = 2                                 # one row, three times
    ids[1, 1], ids[2, 2], ids[3, 3] = -1, -v, v    # wrap, wrap, NaN
    ids[3, 4] = -v - 1                             # NaN
    out_shape = ids.shape + shape[1:]
    w = rng.standard_normal(out_shape).astype(np.float32)
    bad = np.zeros(ids.shape, bool)
    bad[3, 3] = bad[3, 4] = True
    w[bad] = 0.0                           # the NaN rows' cotangent is 0

    def f(t):
        rows = jnp.take(t, jnp.asarray(ids), axis=0)
        return jnp.sum(jnp.where(jnp.asarray(w) == 0, 0.0, rows * w))

    want_rows = np.asarray(jnp.take(table, jnp.asarray(ids), axis=0))
    want_grad = np.asarray(jax.grad(f)(jnp.asarray(table)))
    for fn in (take, lookup):
        t = torch.from_numpy(table.copy()).requires_grad_(True)
        rows = fn(t, torch.from_numpy(ids))
        np.testing.assert_array_equal(rows.detach().numpy(), want_rows)
        wt = torch.from_numpy(w)
        torch.where(wt == 0, 0.0, rows * wt).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), want_grad)


@pytest.mark.parametrize("arch", ["fm", "wide-deep"])
def test_lookup_train_steps_add_at_no_index(arch):
    """FM's and Wide&Deep's train steps run no aten op that adds at
    indices (``index_select``'s backward, an ``index_add``, did: atomics
    on the card); their lookups' gradients are ``gather_segment_sum``."""
    from repro_torch.launch.steps import build_cell, make_smoke_args
    from repro_torch.testing import accumulating_ops
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    c = build_cell(arch, "train_batch", reduced=True, device="cpu")
    p, _, b, _ = make_smoke_args(c, seed=2)
    assert accumulating_ops(
        lambda: grad_accum_value_and_grad(c.loss)(p, b)) == []


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
