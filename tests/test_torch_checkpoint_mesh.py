"""The elastic checkpoint of a sharded train state
(``train/checkpoint.CheckpointManager`` with ``mesh=``, ``specs=``,
``layout=``): saved on 8 gloo ranks (a 2 x 4 ("data", "model") mesh of
CPU processes) from a reduced Mistral-NeMo train cell (fp32, gated MLP:
its ``win`` blocks are ``[gate_r | up_r]``) after one step with ZeRO-1
AdamW and one with ZeRO-1 Adafactor, then restored:

  - on one CPU (no mesh): every leaf equals the ranks' blocks laid back
    whole, bit for bit (each rank's block, cut from the restored whole
    array as the step cuts it, ``models/tp.serving_blocks`` and the ZeRO
    layout, equals the block the rank saved);
  - on the same 8 ranks: each rank's blocks, bit for bit;
  - on a 2 x 2 mesh (4 ranks) and on 1 x 1 (one rank): the blocks cut
    from the whole arrays;
  - in repro (``repro.train.checkpoint``, a subprocess): the same arrays
    bit for bit; and a checkpoint repro saved restores onto the 2 x 2
    mesh, bit for bit its blocks.

A save on 1 x 1, and one on 2 x 4, writes the files a no-mesh save of
the same arrays writes (the same checksums). The ranks are this file run as a script (one process a
rank, meeting through a ``FileStore``; killed after ``TIMEOUT`` s); they
import no JAX.
"""
import dataclasses
import json
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
TIMEOUT = 240          # seconds a spawn may take before its ranks are killed
SEED = 11
ARCH = "mistral-nemo-12b"
OPTS = ("adamw", "adafactor")
MESHES = {"save": (2, 4), "restore": (2, 2), "world1": (1, 1)}


def config():
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH).model_config(True)
    return dataclasses.replace(cfg, dtype=torch.float32, remat=True)


def cell(mesh=None, device: str = "cpu"):
    from repro_torch.launch.steps import build_cell
    return build_cell(ARCH, "train_4k", reduced=True, device=device,
                      model_cfg=config(), mesh=mesh)


def whole_params():
    from repro_torch.models.bridge import train_tree
    from repro_torch.models.transformer import init_params
    return train_tree(init_params(config(), seed=SEED, device="cpu"))


def whole_state_shapes(opt: str):
    """The whole {"params", "opt_state"} tree of ``opt`` (meta tensors)."""
    from repro_torch.launch.steps import param_shapes
    from repro_torch.train.optimizer import get_optimizer

    p = param_shapes(ARCH, config())
    return {"params": p, "opt_state": get_optimizer(opt).init(p)}


def rank_specs(c, opt: str):
    """The rank's spec tree of its {"params", "opt_state"} and its ZeRO
    layout for ``opt``."""
    from repro_torch.launch.steps import zero_layout

    layout = zero_layout(c, opt)
    return ({"params": c.executed_specs()[0],
             "opt_state": layout.state_specs}, layout)


def ckpt_root(root, opt: str) -> str:
    return os.path.join(root, f"ck_{opt}")


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------
def _train_state(c, opt: str):
    """One ZeRO-1 step of ``opt`` on the rank's blocks: the rank's
    {"params", "opt_state"}."""
    from repro_torch.launch.steps import shard_args, smoke_batch
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.train_loop import grad_accum_value_and_grad

    p, _, b, _ = shard_args(c, (whole_params(), None, smoke_batch(c, SEED),
                                None))
    _, layout = rank_specs(c, opt)
    kw = dict(lr=0.1, warmup_steps=1) if opt == "adafactor" else {}
    o = get_optimizer(opt, layout=layout, **kw)
    st = o.init(p)
    _, g = grad_accum_value_and_grad(c.loss, 1, c.mesh,
                                     c.executed_specs()[0])(p, b)
    o.update(g, st, p, torch.tensor(0, dtype=torch.int32))
    return {"params": p, "opt_state": st}


def _keep(out: dict, prefix: str, tree) -> None:
    from repro_torch.train.tree import leaves
    for path, t in leaves(tree):
        out[f"{prefix}{path}"] = t.detach().numpy()


def _rank_main(mode: str, rank: str, world: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import coordinate, make_host_mesh
    from repro_torch.train import checkpoint
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves, tree_map

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"),
                                     int(world)),
        rank=int(rank), world_size=int(world))
    try:
        mesh = make_host_mesh(*MESHES[mode], device_type="cpu")
        # a stacked leaf gathered a layer slice at a time, as at full size
        checkpoint.GATHER_CHUNK = 256
        c = cell(mesh)
        out = {f"coord_{k}": np.int64(v)
               for k, v in coordinate(mesh).items()}
        for opt in OPTS:
            state = _train_state(c, opt)
            specs, layout = rank_specs(c, opt)
            blank = tree_map(torch.zeros_like, state)
            if mode == "save":
                _keep(out, f"{opt}|saved", state)
                CheckpointManager(ckpt_root(root, opt)).save(
                    1, state, mesh=mesh, specs=specs, layout=layout)
                got, step, _ = CheckpointManager(ckpt_root(root, opt)
                                                 ).restore(
                    blank, mesh=mesh, specs=specs, layout=layout)
                assert step == 1
                same = [torch.equal(a, b) for (_, a), (_, b) in
                        zip(leaves(got), leaves(state))]
                out[f"{opt}|round_trip"] = np.array(same)
                continue
            src = os.path.join(os.path.dirname(root), "save",
                               f"ck_{opt}")
            got, _, _ = CheckpointManager(src).restore(
                blank, mesh=mesh, specs=specs, layout=layout)
            _keep(out, f"{opt}|restored", got)
            if mode == "world1":       # a save on 1 x 1: a no-mesh save's
                CheckpointManager(os.path.join(root, f"mesh_{opt}")).save(
                    1, state, mesh=mesh, specs=specs, layout=layout)
                CheckpointManager(os.path.join(root, f"flat_{opt}")).save(
                    1, state)
            if mode == "restore" and opt == "adamw":
                got, _, _ = CheckpointManager(
                    os.path.join(os.path.dirname(root), "repro_ck")).restore(
                    blank, mesh=mesh, specs=specs, layout=layout)
                _keep(out, "repro|restored", got)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the spawns, repro and the references (this process)
# ---------------------------------------------------------------------------
def start(mode: str, root) -> tuple:
    world = MESHES[mode][0] * MESHES[mode][1]
    os.makedirs(os.path.join(root, mode), exist_ok=True)
    where = os.path.join(root, mode)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(where, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(r),
             str(world), where], env=env, stdout=log,
            stderr=subprocess.STDOUT))
    return mode, where, procs, logs, time.monotonic() + TIMEOUT


def finish(run: tuple) -> list:
    mode, where, procs, logs, deadline = run
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
        with open(os.path.join(where, f"rank{failed[0]}.log")) as f:
            pytest.fail(f"{mode}: ranks {failed} failed:\n{f.read()[-4000:]}")
    return [dict(np.load(os.path.join(where, f"rank{r}.npz")))
            for r in range(len(procs))]


REPRO_SAVE = """
import numpy as np
from repro.train.checkpoint import CheckpointManager
given = np.load(f"{ROOT}/repro_tree.npz")
tree = {"params": {}, "opt_state": {"m": {}, "v": {}}}
for name in given.files:
    keys = [k.strip("'") for k in name[1:-1].split("][")]
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = given[name]
CheckpointManager(f"{ROOT}/repro_ck").save(3, tree)
print("REPRO_SAVED")
"""

REPRO_RESTORE = """
import json, os
import numpy as np
import jax
from repro.train.checkpoint import CheckpointManager
out = {}
for opt in OPTS:
    d = f"{ROOT}/save/ck_{opt}"
    man = json.load(open(f"{d}/step_{1:010d}/manifest.json"))
    tree = {}
    for name, meta in man["leaves"].items():
        keys = [k.strip("'") for k in name[1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.zeros(meta["shape"], meta["dtype"])
    got, step, _ = CheckpointManager(d).restore(tree)
    assert step == 1
    for path, a in jax.tree_util.tree_flatten_with_path(got)[0]:
        out[f"{opt}|{jax.tree_util.keystr(path)}"] = np.asarray(a)
np.savez(f"{ROOT}/repro_restored.npz", **out)
print("REPRO_RESTORED")
"""


def run_repro(code: str, root, **names) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    head = "".join(f"{k} = {v!r}\n" for k, v in
                   dict(names, ROOT=str(root)).items())
    return subprocess.Popen([sys.executable, "-c", head
                             + textwrap.dedent(code)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def wait_repro(proc: subprocess.Popen, word: str) -> None:
    try:
        text, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"repro hung past {TIMEOUT} s")
    assert proc.returncode == 0 and word in text, err[-4000:]


def repro_tree() -> dict:
    """A whole AdamW train state of the cell's names and shapes, seeded
    values (repro writes it)."""
    from repro_torch.train.tree import leaves

    rng = np.random.default_rng(SEED)
    return {name: rng.standard_normal(tuple(t.shape)).astype(np.float32)
            for name, t in leaves(whole_state_shapes("adamw"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The save on 2 x 4 (repro saving its checkpoint meanwhile), then
    the restores on 2 x 2 and 1 x 1 and repro's restore, all at once."""
    root = tmp_path_factory.mktemp("ck")
    np.savez(os.path.join(root, "repro_tree.npz"), **repro_tree())
    saving = run_repro(REPRO_SAVE, root)
    saved = finish(start("save", root))
    wait_repro(saving, "REPRO_SAVED")
    restoring = run_repro(REPRO_RESTORE, root, OPTS=OPTS)
    later = [start("restore", root), start("world1", root)]
    out = {"save": saved, "restore": finish(later[0]),
           "world1": finish(later[1])}
    wait_repro(restoring, "REPRO_RESTORED")
    out["repro"] = dict(np.load(os.path.join(root, "repro_restored.npz")))
    out["root"] = str(root)
    return out


_WHOLE: dict = {}


def restored_whole(root: str, opt: str) -> dict:
    """The 2 x 4 checkpoint of ``opt`` restored on one CPU, by path."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves, tree_map

    if opt not in _WHOLE:
        target = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                          whole_state_shapes(opt))
        got, step, _ = CheckpointManager(
            os.path.join(root, "save", f"ck_{opt}")).restore(target)
        assert step == 1
        _WHOLE[opt] = {k: v for k, v in leaves(got)}
    return _WHOLE[opt]


def cut(whole: dict, opt: str, mesh_shape: tuple, coord: dict) -> dict:
    """The rank at ``coord``'s blocks of a whole train state (by path) as
    the step cuts them: the params by ``models/tp.serving_blocks``, the
    state at the ZeRO layout (AdamW's m and v the ZeRO block of the
    param's block; Adafactor's factors at their spec, its full v at the
    ZeRO block)."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import zero_layout
    from repro_torch.models.tp import serving_blocks
    from repro_torch.train.tree import leaves

    mesh = MeshShape(mesh_shape, ("data", "model"))
    meta = cell(device="meta")
    lay = zero_layout(meta, opt, mesh, coord)
    pspec = meta.sharding_fn(mesh)[0]
    params = {k[len("['params']"):]: v for k, v in whole.items()
              if k.startswith("['params']")}
    out = {}

    def nest(flat):
        tree = {}
        for name, t in flat.items():
            keys = [k.strip("'") for k in name[1:-1].split("][")]
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
        return tree

    blocks = dict(leaves(serving_blocks(nest(params), pspec, mesh,
                                        config().act, coord)))
    for path, t in blocks.items():
        out[f"['params']{path}"] = t
    for name, t in whole.items():
        if not name.startswith("['opt_state']"):
            continue
        path = name[len("['opt_state']"):]
        if opt == "adamw":
            param = path[len("['m']"):]
            block = serving_blocks(nest({param: t}), pspec, mesh,
                                   config().act, coord)
            out[name] = lay.leaf(param).zero_block(dict(leaves(block))[param])
        else:
            spec = lay.state_spec(path)
            if path.endswith("['v']"):
                param = path[:-len("['v']")]
                block = dict(leaves(serving_blocks(nest({param: t}), pspec,
                                                   mesh, config().act,
                                                   coord)))[param]
                out[name] = lay.leaf(param).zero_block(block)
            else:
                out[name] = t[lay.local_slice(tuple(t.shape), spec)]
    return out


def coord_of(r: dict) -> dict:
    return {"data": int(r["coord_data"]), "model": int(r["coord_model"])}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", OPTS)
def test_save_on_2x4_restores_on_one_cpu_as_the_gathered_state(runs, opt):
    whole = restored_whole(runs["root"], opt)
    assert len(whole) == sum(1 for k in runs["save"][0]
                             if k.startswith(f"{opt}|saved"))
    for r in runs["save"]:
        want = cut(whole, opt, MESHES["save"], coord_of(r))
        for name, t in want.items():
            assert np.array_equal(r[f"{opt}|saved{name}"], t.numpy()), name


@pytest.mark.parametrize("opt", OPTS)
def test_save_restores_on_its_own_mesh_bit_for_bit(runs, opt):
    for r in runs["save"]:
        assert r[f"{opt}|round_trip"].all()


@pytest.mark.parametrize("mode", ["restore", "world1"])
@pytest.mark.parametrize("opt", OPTS)
def test_restore_on_another_mesh_cuts_the_whole_arrays(runs, opt, mode):
    whole = restored_whole(runs["root"], opt)
    for r in runs[mode]:
        want = cut(whole, opt, MESHES[mode], coord_of(r))
        for name, t in want.items():
            assert np.array_equal(r[f"{opt}|restored{name}"], t.numpy()), \
                name


@pytest.mark.parametrize("opt", OPTS)
def test_a_save_on_one_rank_writes_a_no_mesh_saves_files(runs, opt):
    root = os.path.join(runs["root"], "world1")
    man = []
    for kind in ("mesh", "flat"):
        d = os.path.join(root, f"{kind}_{opt}", f"step_{1:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            man.append(json.load(f))
    assert man[0] == man[1]


@pytest.mark.parametrize("opt", OPTS)
def test_the_mesh_checkpoint_is_a_no_mesh_saves_bytes(runs, opt, tmp_path):
    """Every leaf file the 8 ranks wrote (each its blocks, in place) has
    the bytes ``np.save`` gives the whole array: a no-mesh save of the
    restored state has the same checksums, leaf by leaf."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import tree_map

    whole = restored_whole(runs["root"], opt)
    target = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                      whole_state_shapes(opt))
    tree, _, _ = CheckpointManager(os.path.join(
        runs["root"], "save", f"ck_{opt}")).restore(target)
    CheckpointManager(str(tmp_path)).save(1, tree)
    man = []
    for d in (os.path.join(runs["root"], "save", f"ck_{opt}"),
              str(tmp_path)):
        with open(os.path.join(d, f"step_{1:010d}", "manifest.json")) as f:
            man.append(json.load(f)["leaves"])
    assert sorted(man[0]) == sorted(man[1]) == sorted(whole)
    for name in man[0]:
        assert man[0][name] == man[1][name], name


@pytest.mark.parametrize("opt", OPTS)
def test_repro_restores_the_mesh_checkpoint(runs, opt):
    whole = restored_whole(runs["root"], opt)
    got = {k.split("|", 1)[1]: v for k, v in runs["repro"].items()
           if k.startswith(f"{opt}|")}
    assert sorted(got) == sorted(whole)
    for name, t in whole.items():
        assert np.array_equal(got[name], t.numpy()), name


def test_a_repro_checkpoint_restores_onto_a_port_mesh(runs):
    tree = repro_tree()
    want = {k: torch.from_numpy(v) for k, v in tree.items()}
    for r in runs["restore"]:
        blocks = cut(want, "adamw", MESHES["restore"], coord_of(r))
        assert len(blocks) == len(tree)
        for name, t in blocks.items():
            assert np.array_equal(r[f"repro|restored{name}"], t.numpy()), \
                name


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
