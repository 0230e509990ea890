"""CPU tests of the benchmark harness: the generator, the kernel counts,
the imports, and whole runs at a tiny size on the port's plain path
(``device="cpu"``) that must come out correct, and not correct when the
timed path is broken underneath. Card-only checks carry the ``cuda``
marker and skip here."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lakebench import generator, run
from lakebench.checks import hot_ivf
from lakebench.counts import temporal_window_topk, topk_search_q8

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TINY = {"books": 9, "chunks_per_doc": 500, "corpus_rows": 4500}
BIG_SEED = 2**40 + 12345


def tiny_cell(workload: str, books: int = 9, **store) -> run.Cell:
    cell = run.Cell.load(workload)
    cell.config.update(TINY, books=books, corpus_rows=books * 500)
    cell.config["store"] = {**cell.config["store"], "hot_capacity": 1024,
                            **store}
    cell.mix.update(check_sample=96, warmup_rounds=1)
    return cell


def bench_line(cell: run.Cell, tmp_path, monkeypatch, capsys,
               seed: int = BIG_SEED, seconds: float = 0.3,
               trace: int = 0) -> dict:
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    args = run.parse(["--workload", cell.name, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    assert run.bench(args, cell, torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- generator ---------------------------------------------------------
def test_history_is_made_from_the_seed_alone():
    cfg = tiny_cell("pg19_v5.asof").config
    a = generator.make_history(cfg, BIG_SEED, "cpu")
    b = generator.make_history(cfg, BIG_SEED, "cpu")
    c = generator.make_history(cfg, -7, "cpu")
    assert torch.equal(a.emb, b.emb) and np.array_equal(a.vt, b.vt)
    assert not torch.equal(a.emb, c.emb)
    churn = 4500 // 8
    assert a.n == c.n == 4500 + 4 * churn
    # every passage is open exactly once; a closed row is closed at the
    # instant its successor is written
    cur = a.current()
    assert len(cur) == 4500 and len(set(a.key[cur])) == 4500
    for c_, (lo, hi) in enumerate(a.bounds[1:], start=1):
        assert (a.vf[lo:hi] == a.instants[c_]).all()
    assert (np.sort(a.vt[a.vt != generator.OPEN])
            == np.repeat(a.instants[1:], churn)).all()


def test_traffic_is_deterministic_and_unique():
    mix = dict(run.Cell.load("pg19_v5.asof").mix, vocab_size=300)
    inst = [1, 2, 3, 4, 5]
    a = generator.Traffic(mix, inst, BIG_SEED)
    b = generator.Traffic(mix, inst, BIG_SEED)
    xs = [a.next() for _ in range(10_000)]
    assert xs == [b.next() for _ in range(10_000)]
    assert len({t for t, _ in xs}) == len(xs)
    assert {at for _, at in xs} == set(inst)
    lens = np.array([len(t.split()) for t, _ in xs])
    assert lens.min() >= mix["words_min"]
    assert abs(lens.mean() - mix["words_mean"]) < 0.1


def test_every_seed_asks_the_same_work_in_another_order():
    """A block of requests has the same text lengths and the same count
    of each instant whatever the seed; only their order and the words
    change."""
    mix = run.Cell.load("pg19_v5.asof").mix
    inst = [1, 2, 3, 4, 5]
    n = generator.Traffic.BLOCK
    blocks = []
    for seed in (BIG_SEED, 3):
        t = generator.Traffic(mix, inst, seed)
        blocks.append([t.next() for _ in range(2 * n)])
    for lo in (0, n):
        a, b = (blk[lo:lo + n] for blk in blocks)
        assert sorted(len(x.split()) for x, _ in a) == \
            sorted(len(x.split()) for x, _ in b)
        assert sorted(at for _, at in a) == sorted(at for _, at in b)
        assert [x for x, _ in a] != [x for x, _ in b]
    counts = np.bincount([inst.index(at) for _, at in blocks[0][:n]])
    assert counts.max() - counts.min() <= 1


# -- kernel counts -----------------------------------------------------
def test_kernel_counts_by_hand():
    call = {"rows": 1000, "queries": 3, "dim": 8, "k": 2, "pool": 5}
    # fp32 rows + two int64 validity columns, fp32 queries, k scores+ids
    assert temporal_window_topk.work(call) == (
        1000 * 8 * 4 + 1000 * 8 * 2 + 3 * 8 * 4 + 3 * 2 * (4 + 4),
        2 * 3 * 1000 * 8)
    # int8 rows + bool mask, fp32 queries, the pool's scores+ids
    assert topk_search_q8.work(call) == (
        1000 * 8 + 1000 + 3 * 8 * 4 + 3 * 5 * 8, 2 * 3 * 1000 * 8)
    f32 = "void topk_list_kernel<float, 2, (anonymous namespace)::WindowMask>"
    i8 = "void topk_list_kernel<signed char, 2, (anonymous namespace)::BoolMask>"
    assert temporal_window_topk.matches(f32)
    assert not temporal_window_topk.matches(i8)
    assert topk_search_q8.matches(i8) and not topk_search_q8.matches(f32)


def test_hot_layout_follows_the_compactor():
    segs, mem = hot_ivf.layout(127 * 4096 + 2739, 4096)
    assert sorted(len(s) for s in segs) == [4096] * 3 + [16384] * 3 + \
        [65536] * 3 + [262144]
    assert len(mem) == 2739
    allpos = np.concatenate(segs + [mem])
    assert np.array_equal(np.sort(allpos), np.arange(127 * 4096 + 2739))
    segs, mem = hot_ivf.layout(2 * 4096, 4096)      # full memtable, 1 seal
    assert [len(s) for s in segs] == [4096] and len(mem) == 4096


# -- imports -----------------------------------------------------------
def test_no_import_of_jax_or_the_jax_package():
    bad = set(run.FORBIDDEN)
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in bad, f"{path}: {n}"


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole tiny run in a fresh process, then the top-level names in
    ``sys.modules``: ``repro_torch`` may be there, ``repro`` not."""
    code = (
        "import sys, torch; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from lakebench import run, test_lakebench as t\n"
        "cell = t.tiny_cell('pg19_v5.asof')\n"
        "args = run.parse(['--workload', cell.name, '--seed', '5',"
        " '--seconds', '0.2'])\n"
        "assert run.bench(args, cell, torch.device('cpu')) == 0\n"
        "print('LOADED', sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = eval(out.stdout.split("LOADED", 1)[1])
    assert "repro_torch" in loaded
    assert not set(loaded) & set(run.FORBIDDEN)


# -- whole runs on the port's plain path ---------------------------------
@pytest.mark.parametrize("workload", ["pg19_v5.asof", "pg19_v5_q8.current"])
def test_run_is_correct_and_its_last_line_complete(workload, tmp_path,
                                                   monkeypatch, capsys):
    cell = tiny_cell(workload)
    line = bench_line(cell, tmp_path, monkeypatch, capsys)
    assert line["correct"] is True, line["checks"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    # every end-to-end metric of the cell but the card's memory peak
    want = {m["name"] for m in cell.metrics("end_to_end")}
    assert want - {"device_peak_gb"} == set(line["metrics"])
    assert set(line["checks"]) == set(cell.limits["limits"])
    assert list(tmp_path.iterdir()) == []         # the store is removed


@pytest.mark.parametrize("workload", ["pg19_v5.asof", "pg19_v5_q8.current"])
def test_traced_run_reports_the_layers(workload, tmp_path, monkeypatch,
                                       capsys):
    """Every per-layer metric of the cell, but those read from the card's
    trace (none here)."""
    cell = tiny_cell(workload)
    line = bench_line(cell, tmp_path, monkeypatch, capsys, trace=1)
    assert line["correct"] is True
    want = {m["name"] for m in cell.metrics("per_layer")
            if m["source"] != "device_trace"}
    assert set(line["metrics"]) == want
    assert {"busy_s", "window_s"} <= set(line["device"])


def _break(monkeypatch, fault: str):
    """Break the timed path underneath the harness."""
    from repro_torch.core import store, temporal
    from repro_torch.index import lsm, quant

    if fault == "answer_altered":
        orig = store.LiveVectorLake.query_batch

        def altered(self, texts, *a, **kw):
            out = orig(self, texts, *a, **kw)
            for res in out:
                if res:
                    res[0].score += 1e-3
            return out
        monkeypatch.setattr(store.LiveVectorLake, "query_batch", altered)
    elif fault == "half_batch_left_out":
        orig = store.LiveVectorLake.query_batch

        def half(self, texts, *a, **kw):
            n = len(texts) // 2
            return orig(self, texts[:n], *a, **kw) + [[]] * (len(texts) - n)
        monkeypatch.setattr(store.LiveVectorLake, "query_batch", half)
    elif fault == "validity_ignored":
        orig = temporal.TemporalEngine._fused_topk

        def leak(self, qp, nq, res, t0s, t1s, k, visible=None):
            lo = np.full_like(t0s, -2**62)
            return orig(self, qp, nq, res, lo, lo + 2**63 - 1, k, visible)
        monkeypatch.setattr(temporal.TemporalEngine, "_fused_topk", leak)
    elif fault == "rescore_altered":
        orig = quant.rescore_topk

        def off(q, pool_idx, f32_rows, k):
            s, i = orig(q, pool_idx, f32_rows, k)
            return s + np.float32(1e-4), i
        monkeypatch.setattr(lsm, "rescore_topk", off)
        monkeypatch.setattr(quant, "rescore_topk", off)


@pytest.mark.parametrize("workload,fault", [
    ("pg19_v5.asof", "answer_altered"),
    ("pg19_v5.asof", "half_batch_left_out"),
    ("pg19_v5.asof", "validity_ignored"),
    ("pg19_v5_q8.current", "answer_altered"),
    ("pg19_v5_q8.current", "half_batch_left_out"),
    ("pg19_v5_q8.current", "rescore_altered"),
])
def test_a_broken_path_is_not_correct(workload, fault, tmp_path,
                                      monkeypatch, capsys):
    sys.path.insert(0, str(ROOT / "src"))
    _break(monkeypatch, fault)
    line = bench_line(tiny_cell(workload), tmp_path, monkeypatch, capsys)
    assert line["correct"] is False, line["checks"]


def test_int4_control_fails_the_hot_tier_check():
    """The control of the int8 cell (an int4 candidate pool in the
    program's place) must read over a limit at a size a test holds."""
    sys.path.insert(0, str(ROOT / "src"))
    from lakebench.control import control_numbers

    cell = tiny_cell("pg19_v5_q8.current", books=40)
    cell.config["store"]["hot_capacity"] = 4096
    cell.mix["check_sample"] = 512
    nums = control_numbers(cell, BIG_SEED, torch.device("cpu"), "int4_pool")
    assert any(v["value"] > v["limit"] for v in nums.values()), nums


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("workload,books", [("pg19_v5.asof", 120),
                                           ("pg19_v5_q8.current", 40)])
def test_tf32_control_fails_the_check(workload, books, cuda_device):
    """The TF32 control (the reference scored in TF32 in the program's
    place: below the fp32 temporal scan and the fp32 rescore) must read
    over a limit."""
    from lakebench.control import control_numbers

    sys.path.insert(0, str(ROOT / "src"))
    cell = tiny_cell(workload, books=books)
    cell.config["store"]["hot_capacity"] = 4096
    cell.mix["check_sample"] = 512
    nums = control_numbers(cell, BIG_SEED, cuda_device, "tf32")
    assert any(v["value"] > v["limit"] for v in nums.values()), nums
