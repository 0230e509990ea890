"""The port's sharding rules (``repro_torch.launch.sharding``) against
repro's, from a mesh's shape and dimension names alone.

For every (arch x shape) cell that both packages register, at mesh
shapes (16, 16), (2, 16, 16), (2, 4) and (1, 1), the spec trees of the
cell's arguments (``CellBundle.sharding_fn``: params, optimizer state,
batch, step) equal repro's, leaf by leaf: repro's rules run on a
stand-in mesh that has only ``.shape`` and ``.axis_names`` (nothing in
repro changes). ``sanitize``, ``fabric_fanout_specs`` and
``effective_accum`` equal repro's on a grid. ``local_slice`` tiles every
leaf exactly over the ranks, and ``placements`` gives DTensor the same
blocks. Exact equality throughout: the rules are integer arithmetic on
shapes.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import all_cells as repro_cells
from repro.launch import sharding as rshd
from repro.launch import steps as rsteps
from repro_torch.configs import all_cells
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


class StandIn:
    """What repro's rules read of a mesh: ``shape`` and ``axis_names``."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


def repro_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RP))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def port_flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_flat(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: tuple(tree)}


def shared_cells() -> list:
    mine = {(c.arch, c.shape) for c in all_cells()}
    return sorted((c.arch, c.shape) for c in repro_cells()
                  if (c.arch, c.shape) in mine)


def test_both_packages_register_the_same_cells():
    assert {(c.arch, c.shape) for c in all_cells()} == \
        {(c.arch, c.shape) for c in repro_cells()}


@pytest.mark.parametrize("cell", shared_cells(),
                         ids=lambda c: f"{c[0]}/{c[1]}")
def test_spec_trees_equal_repros(cell):
    arch, shape = cell
    rb = rsteps.build_cell(arch, shape, reduced=False)
    pb = steps.build_cell(arch, shape, device="meta")
    assert pb.kind == rb.kind
    for name, (dims, names) in MESHES.items():
        want = rb.sharding_fn(StandIn(dims, names))
        got = pb.sharding_fn(MeshShape(dims, names))
        assert len(got) == len(want), name
        for slot, (g, w) in enumerate(zip(got, want)):
            assert port_flat(g) == repro_flat(w), (name, slot)


def test_sanitize_equals_repros():
    mesh_p = MeshShape((2, 16, 16), ("pod", "data", "model"))
    mesh_r = StandIn((2, 16, 16), ("pod", "data", "model"))
    entries = [None, "model", "data", "pod", ("pod", "data"),
               ("data", "model"), ("pod", "data", "model")]
    for dims in [(64, 48, 7), (512, 3, 1), (1, 1, 16), (32, 32, 32)]:
        for spec in itertools.product(entries, repeat=3):
            got = shd.sanitize(shd.P(*spec), dims, mesh_p)
            want = rshd.sanitize(RP(*spec), dims, mesh_r)
            assert tuple(got) == tuple(want), (dims, spec)
    # a spec longer than the shape: the extra entries come back None
    assert tuple(shd.sanitize(shd.P("data", "model"), (32,), mesh_p)) == \
        tuple(rshd.sanitize(RP("data", "model"), (32,), mesh_r))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fabric_fanout_specs_equal_repros(mesh):
    dims, names = MESHES[mesh]
    for n_shards in (1, 2, 3, 4, 8, 16, 32, 48, 512):
        got = shd.fabric_fanout_specs(MeshShape(dims, names), n_shards)
        want = rshd.fabric_fanout_specs(StandIn(dims, names), n_shards)
        assert [tuple(g) for g in got[:3]] == [tuple(w) for w in want[:3]]
        assert [tuple(g) for g in got[3]] == [tuple(w) for w in want[3]]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_effective_accum_equals_repros(mesh):
    dims, names = MESHES[mesh]
    for pref, batch in itertools.product((1, 2, 8, 16, 64),
                                         (1, 2, 16, 32, 256, 65_536)):
        assert steps.effective_accum(pref, batch, MeshShape(dims, names)) \
            == rsteps.effective_accum(pref, batch, StandIn(dims, names))
    assert steps.effective_accum(8, 2) == 8       # one card: as preferred


SPECS = [shd.P("model", None), shd.P(None, "data"), shd.P(("data",
         "model"), None), shd.P("data", "model"), shd.P(None, None),
         shd.P(("pod", "data"), "model"), shd.P(None, ("pod", "data",
                                                         "model"))]


def coords(mesh):
    names = mesh.mesh_dim_names
    for idx in itertools.product(*[range(s) for s in mesh.shape]):
        yield dict(zip(names, idx))


@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
def test_local_slice_tiles_each_leaf(mesh):
    m = MeshShape(*MESHES[mesh])
    sizes = dict(zip(m.mesh_dim_names, m.shape))
    for spec in SPECS:
        if any(a not in sizes for e in spec for a in shd._axes(e)):
            continue
        shape = (512, 512)
        cover = torch.zeros(shape, dtype=torch.int32)
        for c in coords(m):
            sl = shd.local_slice(shape, spec, m, c)
            assert cover[sl].shape == shd.local_shape(shape, spec, m)
            cover[sl] += 1
        named = {a for e in spec for a in shd._axes(e)}
        copies = int(np.prod([sizes[a] for a in m.mesh_dim_names
                              if a not in named]))
        assert bool((cover == copies).all()), spec


def test_placements_give_dtensor_the_same_blocks():
    """Under a fake world, each rank's DTensor block of a (64, 512) tensor
    (its local shape and global offset by DTensor's own rule) is the
    block ``local_slice`` cuts for that rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dims, names = MESHES["2x4"]
    shape = (64, 512)
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
            coord = dict(zip(names, mesh.get_coordinate()))
            for spec in SPECS[:5]:
                sl = shd.local_slice(shape, spec, mesh, coord)
                local, offset = compute_local_shape_and_global_offset(
                    shape, mesh, shd.placements(mesh, spec))
                assert tuple(local) == tuple(s.stop - s.start for s in sl)
                assert tuple(offset) == tuple(s.start for s in sl), \
                    (rank, spec)
        finally:
            dist.destroy_process_group()
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(MeshShape(dims, names), shd.P(("model", "data")))


def test_executed_keeps_experts_and_tables_only():
    """Every kind executes repro's spec trees whole (the experts and the
    tables among them, and everything repro tensor-parallelises), a
    graph batch too: its edges over every axis, its rows over the data
    axes."""
    m = MeshShape((2, 4), ("data", "model"))
    bundle = steps.build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                              device="meta")
    for tree in bundle.sharding_fn(m)[:2]:
        assert port_flat(shd.executed(tree)) == port_flat(tree)
    kept = port_flat(shd.executed(bundle.sharding_fn(m)[0]))
    for path, spec in kept.items():
        if path.endswith(("['moe']['w_in']", "['moe']['w_out']")):
            assert spec == (None, "model", "data", None)
    assert kept["['embed']"] == ("model", None)
    assert kept["['lm_head']"] == (None, "model")
    dlrm = steps.build_cell("dlrm-mlperf", "serve_p99", device="meta")
    kept = port_flat(shd.executed(dlrm.sharding_fn(m)[0]))
    assert kept["['tables']['table_0']"] == ("model", None)
    assert kept["['tables']['table_5']"] == (None, None)      # 3 rows
    assert kept["['top']['w0']"] == (None, "model")   # repro's TP, run here
    for arch, shape in (("dlrm-mlperf", "train_batch"),
                        ("mistral-nemo-12b", "train_4k"),
                        ("fm", "retrieval_cand")):
        b = steps.build_cell(arch, shape, reduced=True, device="meta")
        specs = b.sharding_fn(m)[b.batch_index]
        assert shd.executed_batch(specs, m, b.kind) == specs
    gnn = steps.build_cell("schnet", "full_graph_sm", reduced=True,
                           device="meta")
    specs = gnn.sharding_fn(m)[2]
    got = shd.executed_batch(specs, m, "train")
    assert specs["edge_index"] == (None, ("data", "model"))
    assert got == specs
    assert got["edge_index"] == (None, ("data", "model"))
    assert got["edge_dist"] == (("data", "model"),)
    assert got["node_feat"] == ("data", None)
