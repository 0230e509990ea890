"""Dry run of every cell on the production meshes (repro's
``launch/dryrun.py`` and ``hlo_analysis.cost_summary``, without XLA).

One process poses as rank 0 of a 256-rank (16 x 16) or 512-rank
(2 x 16 x 16) world under PyTorch's fake process group (no rank, card or
network behind it). For every cell of ``configs.all_cells()`` but the
embedder's (repro skips it too), the cell's params, optimizer state and
batch are made as ``meta`` tensors (shapes and dtypes, no values), its
spec trees come from ``launch/sharding`` (``CellBundle.sharding_fn``),
and each leaf becomes a DTensor of its rank-0 block with the spec's
placements. The record keeps repro's keys where they mean something
here: ``arch``, ``shape``, ``kind``, ``mesh``, ``n_chips``,
``optimizer``, ``argument_bytes`` (a rank's bytes of all the arguments
under repro's layout: its GSPMD tensor parallelism and ZeRO-1 included)
and ``status``; it adds ``fits_80gb`` (``argument_bytes`` against one
H100's 80 x 10^9 bytes), the largest leaves' placements, and
``executed_argument_bytes`` / ``executed_fits_80gb``, the same under
the layout the port's steps run (``executed_bytes``: the optimizer state
as ``train/zero`` makes it). The port's steps execute repro's layout
whole, tensor parallelism, ZeRO-1 and SchNet's edge-sharded batch
included, so the two counts are equal in every record, and every cell
fits. repro's temp bytes and
FLOPs come from XLA's compiled module; nothing here measures them, so
the record has none.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      mistral-nemo-12b --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --both-meshes --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

HBM_BYTES = 80e9                  # one H100
N_LARGEST = 4                     # leaves whose placement a record keeps


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry run: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def arg_shapes(bundle) -> tuple:
    """The cell's arguments as meta tensors, in ``fn``'s order."""
    from .steps import param_shapes, _optimizer

    batch = {k: _meta(v) for k, v in
             bundle.arg_specs[bundle.batch_index].items()}
    if bundle.kind == "retrieval":
        return (batch,)
    params = param_shapes(bundle.arch, bundle.model_cfg)
    if bundle.kind != "train":
        return params, batch
    return (params, _optimizer(bundle.optimizer).init(params), batch,
            torch.empty((), dtype=torch.int32, device="meta"))


def place(mesh, leaf: torch.Tensor, spec):
    """``leaf``'s rank-0 block as a DTensor under ``spec``'s placements;
    raises unless its global shape is ``leaf``'s."""
    from torch.distributed.tensor import DTensor

    from .sharding import local_shape, placements

    local = torch.empty(local_shape(tuple(leaf.shape), spec, mesh),
                        dtype=leaf.dtype, device="meta")
    dt = DTensor.from_local(local, mesh, placements(mesh, spec),
                            run_check=False, shape=leaf.shape,
                            stride=leaf.stride())
    if tuple(dt.shape) != tuple(leaf.shape):
        raise RuntimeError(f"{spec}: global {tuple(dt.shape)} from the "
                           f"placements, {tuple(leaf.shape)} in the cell")
    return dt


def executed_bytes(bundle, args, trees, mesh) -> int:
    """A rank's bytes of the arguments under the layout the port's steps
    run on ``mesh`` (``CellBundle.executed_specs``: every leaf at repro's
    spec), rank 0's: its param and batch blocks, and a train cell's
    optimizer state as ``train/zero`` makes it at the rank's ZeRO-1
    blocks (``steps.zero_layout(...).state_blocks``: the code the step's
    ``init`` runs, on meta tensors); a GNN's replicated, as
    ``gnn_param_specs`` leaves its params."""
    from ..configs import get_arch
    from ..train.tree import tensors, tree_map
    from .sharding import executed, executed_batch, local_shape
    from .steps import _optimizer, zero_layout

    def local(tree, specs):
        return tree_map(lambda leaf, spec: torch.empty(
            local_shape(tuple(leaf.shape), spec, mesh), dtype=leaf.dtype,
            device="meta"), tree, specs)

    i = bundle.batch_index
    out = [local(args[i], executed_batch(trees[i], mesh, bundle.kind))]
    if bundle.kind != "retrieval":
        params = local(args[0], executed(trees[0], bundle.kind))
        out.append(params)
        if bundle.kind == "train" and \
                get_arch(bundle.arch).family == "gnn":
            out += [_optimizer(bundle.optimizer).init(params), args[3]]
        elif bundle.kind == "train":
            coord = {a: 0 for a in mesh.mesh_dim_names}
            out += [zero_layout(bundle, mesh=mesh, coord=coord)
                    .state_blocks("meta"), args[3]]
    return sum(t.numel() * t.element_size() for tree in out
               for t in tensors(tree))


def run_cell(arch: str, shape: str, mesh, multi_pod: bool) -> dict:
    from ..train.tree import leaves
    from .steps import build_cell

    t0 = time.perf_counter()
    bundle = build_cell(arch, shape, device="meta")
    args = arg_shapes(bundle)
    trees = bundle.sharding_fn(mesh)
    rows = []
    for slot, (tree, specs) in enumerate(zip(args, trees)):
        flat_specs = dict(leaves(specs))
        for path, leaf in leaves(tree):
            dt = place(mesh, leaf, flat_specs[path])
            local = dt.to_local()
            rows.append((local.numel() * local.element_size(),
                         f"[{slot}]{path}", tuple(leaf.shape),
                         flat_specs[path], dt.placements))
    arg_bytes = sum(b for b, *_ in rows)
    run_bytes = executed_bytes(bundle, args, trees, mesh)
    rows.sort(key=lambda r: -r[0])
    return {
        "arch": arch, "shape": shape, "kind": bundle.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": 512 if multi_pod else 256,
        "optimizer": bundle.optimizer,
        "argument_bytes": arg_bytes,
        "fits_80gb": arg_bytes <= HBM_BYTES,
        "executed_argument_bytes": run_bytes,
        "executed_fits_80gb": run_bytes <= HBM_BYTES,
        "largest": [{"leaf": path, "shape": list(shp),
                     "spec": [list(e) if isinstance(e, tuple) else e
                              for e in spec],
                     "placements": [str(p) for p in pl],
                     "bytes_per_rank": b}
                    for b, path, shp, spec, pl in rows[:N_LARGEST]],
        "dry_s": round(time.perf_counter() - t0, 3),
        "status": "ok",
    }


def dry_run(cells, multi_pod: bool, log=print) -> list:
    """Records of ``cells`` ((arch, shape) pairs) on one production mesh,
    under a fake world of its size; a cell that fails is recorded so."""
    from .mesh import PRODUCTION, make_production_mesh

    shape, _ = PRODUCTION[multi_pod]
    n = 1
    for s in shape:
        n *= s
    out = []
    with fake_world(n):
        mesh = make_production_mesh(multi_pod, device_type="cpu")
        for arch, cell_shape in cells:
            try:
                rec = run_cell(arch, cell_shape, mesh, multi_pod)
                log(f"[dryrun] {arch}/{cell_shape} @ {rec['mesh']}: "
                    f"arg={rec['argument_bytes'] / 1e9:.2f}GB a rank "
                    f"fits_80gb={rec['fits_80gb']}; executed "
                    f"{rec['executed_argument_bytes'] / 1e9:.2f}GB "
                    f"fits_80gb={rec['executed_fits_80gb']}")
            except Exception as e:  # record failures, keep going
                rec = {"arch": arch, "shape": cell_shape,
                       "mesh": "2x16x16" if multi_pod else "16x16",
                       "status": "fail",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                log(f"[dryrun] {arch}/{cell_shape}: FAIL {rec['error']}")
            out.append(rec)
    return out


def all_dry_cells() -> list:
    from ..configs import all_cells

    return [(c.arch, c.shape) for c in all_cells()
            if c.arch != "minilm-embedder"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.all:
        cells = all_dry_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for multi_pod in meshes:
        results.extend(dry_run(cells, multi_pod))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{n_ok}/{len(results)} cells placed OK")


if __name__ == "__main__":
    main()
