"""The port's dry run (``repro_torch.launch.dryrun``): every cell but the
embedder's, on both production meshes (16 x 16 and 2 x 16 x 16), under
PyTorch's fake process group, as meta tensors with the placements of
``launch/sharding``.

  - every cell is placed (each leaf a DTensor whose global shape is the
    cell's), both meshes in well under 60 s;
  - each cell's ``argument_bytes`` (a rank's bytes of params, optimizer
    state, batch and step) equals the count made from repro's own spec
    trees and repro's own argument shapes (``jax.eval_shape``): exact,
    integer arithmetic;
  - the cells whose arguments exceed one H100's 80 GB are listed here
    (none: a rule that stopped sharding a large leaf, say Kimi-K2's
    experts over "data", would add cells to the list);
  - so are those that exceed it under the layout the port's steps run
    (``executed_argument_bytes``, none): every LM and recsys cell, train
    cells included, executes repro's layout whole (tensor parallelism,
    ZeRO-1's optimizer state at ``train/zero``'s blocks), so its count
    equals ``argument_bytes``; one cell's count is made by hand.
"""
import time

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RP

from repro.launch import steps as rsteps
from repro_torch.launch import dryrun

DOES_NOT_FIT = set()           # (arch, shape, mesh) over 80 GB a rank
# the same under the port's executed layout: repro's layout, whole
EXECUTED_DOES_NOT_FIT = set()
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def repro_argument_bytes(arch: str, shape: str, multi_pod: bool) -> int:
    """A rank's argument bytes from repro's spec trees and shapes."""
    dims, names = MESHES[multi_pod]
    sizes = dict(zip(names, dims))

    class StandIn:
        pass

    mesh = StandIn()
    mesh.shape, mesh.axis_names = sizes, names
    rb = rsteps.build_cell(arch, shape, reduced=False)
    total = 0
    for args, specs in zip(rb.arg_specs, rb.sharding_fn(mesh)):
        flat_s = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, RP))
        flat_a = jax.tree_util.tree_leaves(args)
        assert len(flat_s) == len(flat_a)
        for a, spec in zip(flat_a, flat_s):
            n = 1
            for d, dim in enumerate(a.shape):
                entry = spec[d] if d < len(spec) else None
                axes = () if entry is None else \
                    ((entry,) if isinstance(entry, str) else entry)
                n *= dim // int(np.prod([sizes[x] for x in axes]))
            total += n * np.dtype(a.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def records():
    t0 = time.perf_counter()
    cells = dryrun.all_dry_cells()
    recs = dryrun.dry_run(cells, False, log=lambda m: None) + \
        dryrun.dry_run(cells, True, log=lambda m: None)
    return recs, time.perf_counter() - t0


def test_every_cell_is_placed_on_both_meshes_in_time(records):
    recs, seconds = records
    assert seconds < 60, seconds
    cells = dryrun.all_dry_cells()
    assert len(cells) == 40 and not any(a == "minilm-embedder"
                                        for a, _ in cells)
    assert len(recs) == 2 * len(cells)
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
           for r in recs if r["status"] != "ok"]
    assert not bad, bad
    for r in recs:
        assert r["n_chips"] == (512 if r["mesh"] == "2x16x16" else 256)
        assert set(r) >= {"arch", "shape", "kind", "mesh", "n_chips",
                          "optimizer", "argument_bytes", "status",
                          "fits_80gb", "largest"}


def test_argument_bytes_equal_repros_count(records):
    recs, _ = records
    for r in recs:
        want = repro_argument_bytes(r["arch"], r["shape"],
                                    r["mesh"] == "2x16x16")
        assert r["argument_bytes"] == want, (r["arch"], r["shape"],
                                             r["mesh"])


def test_cells_over_80gb_are_the_listed_ones(records):
    recs, _ = records
    over = {(r["arch"], r["shape"], r["mesh"]) for r in recs
            if not r["fits_80gb"]}
    assert over == DOES_NOT_FIT
    assert all(r["fits_80gb"] == (r["argument_bytes"] <= 80e9)
               for r in recs)


def test_records_name_the_largest_leaves_placements(records):
    recs, _ = records
    kimi = next(r for r in recs if (r["arch"], r["shape"], r["mesh"]) ==
                ("kimi-k2-1t-a32b", "train_4k", "16x16"))
    assert kimi["optimizer"] == "adafactor"
    top = kimi["largest"][0]
    assert top["leaf"].startswith("[0]['layers']['moe']['w_")
    assert top["spec"] == [None, "model", "data", None]
    assert top["placements"] == ["S(2)", "S(1)"]
    dlrm = next(r for r in recs if (r["arch"], r["shape"], r["mesh"]) ==
                ("dlrm-mlperf", "serve_p99", "2x16x16"))
    assert dlrm["largest"][0]["placements"] == ["R", "R", "S(0)"]


def test_executed_layout_bytes(records):
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.launch.steps import param_shapes
    from repro_torch.train.tree import tensors

    recs, _ = records
    over = {(r["arch"], r["shape"], r["mesh"]) for r in recs
            if not r["executed_fits_80gb"]}
    assert over == EXECUTED_DOES_NOT_FIT
    for r in recs:
        assert r["executed_fits_80gb"] == \
            (r["executed_argument_bytes"] <= 80e9)
        # the executed layout shards a subset of what repro's shards
        assert r["executed_argument_bytes"] >= r["argument_bytes"]
    # by hand: Mistral-NeMo's train_4k on rank 0 of 16 x 16 holds 1/16 of
    # each tensor-parallel leaf in bf16 (the embedding's vocab rows, the
    # head's vocab columns, wq / wk / wv / win's columns, wo / wout's
    # rows) and the norms whole; AdamW's fp32 m and v over 1/16 of that
    # again (ZeRO-1 over "data" on d_model, free in every leaf); 1/16 of
    # the (256, 4096) int32 tokens and labels; the int32 step
    c = CONFIG
    d, layers, v = c.d_model, c.n_layers, c.vocab
    q, kv = c.n_heads * c.d_head, c.n_kv * c.d_head
    tp = 2 * v * d + layers * d * (2 * q + 2 * kv + 3 * c.d_ff)
    norms = d + 2 * layers * d
    assert tp + norms == c.n_params()
    want = 2 * (tp // 16 + norms) + 8 * (tp // 256 + norms // 16) + \
        2 * 256 * 4096 * 4 // 16 + 4
    assert want == 1_915_212_292
    for r in recs:
        if (r["arch"], r["shape"]) == ("mistral-nemo-12b", "train_4k") \
                and r["mesh"] == "16x16":
            assert r["executed_argument_bytes"] == r["argument_bytes"] == \
                want
    assert len(list(tensors(param_shapes("mistral-nemo-12b", CONFIG)))) \
        == 11


def test_serving_records_execute_repros_layout(records):
    """Every prefill and decode record, long_500k included, and every LM,
    recsys and SchNet train record, on both meshes: the rank's executed
    bytes are repro's argument bytes (the params at lm_param_specs or
    recsys_param_specs, the KV cache at lm_batch_specs, the optimizer
    state at zero1_opt_specs, SchNet's batch at gnn_batch_specs), under
    80 GB."""
    recs, _ = records
    serving = [r for r in recs if r["kind"] in ("prefill", "decode")]
    assert len(serving) == 2 * 5 * 3
    for r in serving:
        assert r["executed_argument_bytes"] == r["argument_bytes"], \
            (r["arch"], r["shape"], r["mesh"])
        assert r["executed_fits_80gb"]
    trains = [r for r in recs if r["kind"] == "train"]
    assert len(trains) == 2 * (9 + 4)
    assert sum(r["arch"] == "schnet" for r in trains) == 2 * 4
    for r in trains:
        assert r["executed_argument_bytes"] == r["argument_bytes"], \
            (r["arch"], r["shape"], r["mesh"])
        assert r["executed_fits_80gb"]
