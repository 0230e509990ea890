"""The benchmark of the PyTorch/CUDA port of LiveVectorLake.

    python -m lakebench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``lakebench/configs/<name>.json``)
and a traffic mix (``lakebench/mixes/<name>.json``). Set-up makes the
version history from the seed on the card, commits it into a cold tier
under ``$TMPDIR``, opens ``LiveVectorLake`` on it (its ``recover()``
builds the hot tier) and warms the cell's path. The window then runs the
mix as a closed loop through ``LiveVectorLake.query_batcher`` for
``--seconds``. Afterwards the program is freed and a sample of the
window's answers, drawn from the seed, is held to the plain reference
(``lakebench/checks/<check>.py``, limits in
``lakebench/limits/<workload>.json``).

``--trace 0`` switches the port's tracing off and reports the cell's
end-to-end metrics (readers in ``lakebench/end_to_end/``); ``--trace 1``
leaves it on, adds ``torch.profiler`` over the window and reports the
per-layer metrics (readers in ``lakebench/layer_metrics/``). The last
line of standard output is one JSON object; the numbers compared and
their limits are also the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
READERS = {"end_to_end": "end_to_end", "per_layer": "layer_metrics"}


class BenchError(RuntimeError):
    """The run cannot produce a result (no card, a missing file, a
    forbidden import): exit non-zero, print no result line."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_py(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"lakebench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_file(kind: str, name: str) -> Path:
    """The reader of a metric: ``<name>.py`` in the kind's folder, or, for
    a quantity split by the cells it is read in (``embed_ms.asof``), the
    file of the name without its last dotted parts (``embed_ms.py``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / READERS[kind] / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise BenchError(f"no reader for the metric {name!r}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def io_bytes() -> dict:
    """This process's written bytes so far (``/proc/self/io``)."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, val = line.split(":")
                out[key.strip()] = int(val)
    except OSError:
        pass
    return out


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    manifest: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        path = ROOT / "BENCHMARK.json"
        if not path.is_file():
            raise BenchError(f"no {path}")
        manifest = json.loads(path.read_text())
        entry = next((w for w in manifest["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in manifest["configs"]
                    if c["name"] == entry["config"])
        return cls(name, entry, json.loads((ROOT / conf["file"]).read_text()),
                   json.loads((HERE / "mixes" / f"{entry['traffic']}.json")
                              .read_text()),
                   json.loads((HERE / "limits" / f"{name}.json").read_text()),
                   manifest)

    def metrics(self, kind: str) -> list[dict]:
        """The manifest's metrics of ``kind`` this cell reports."""
        e2e = {m["name"]: m for m in self.manifest["end_to_end"]}

        def here(m):
            return "workloads" not in m or self.name in m["workloads"]

        if kind == "end_to_end":
            return [m for m in self.manifest["end_to_end"] if here(m)]
        return [m for m in self.manifest["per_layer"] if here(m)
                and here(e2e[m["moves"]])]


@dataclasses.dataclass
class Run:
    """What the readers of the metrics see."""
    cell: Cell
    seconds: float
    window: tuple
    setup_s: float
    traces: list            # root spans of the window's batches (traced)
    counters: dict          # the window batcher's counters
    peak_bytes: int
    device_ops: list        # devtrace.DeviceOp of the traced window
    trace_window_s: float
    dim: int
    k: int
    loop: object            # the window's loop.ClosedLoop
    phases: dict            # set-up phase -> seconds on the host clock

    def latencies_ms(self) -> list[float]:
        return self.loop.latencies_ms()

    def served_in_window(self) -> float:
        """Queries served in the window, the batch in flight at its close
        counted for the share of its run that the window saw."""
        return self.loop.work_in_window(*self.window)

    def per_batch(self, span_prefix: str, exact: bool = True):
        """Mean over the window's batches of the summed wall ms of the
        spans named ``span_prefix`` (or starting with it), or None when
        no batch has one."""
        if not self.traces:
            return None
        tot, hit = 0.0, False
        for root in self.traces:
            spans = (root.find(span_prefix) if exact
                     else root.find_prefix(span_prefix))
            hit |= bool(spans)
            tot += sum(sp.wall_ms for sp in spans)
        return tot / len(self.traces) if hit else None


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(torch, chips: int):
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: this "
                         "benchmark measures the card and has no CPU path")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} card(s), "
                         f"{torch.cuda.device_count()} visible")
    return torch.device("cuda:0")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def set_caches() -> None:
    """Fixed cache directories inside the checkout, so only a checkout's
    first run builds or compiles."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "lakebench_cache" / sub)
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    args = parse(argv)
    try:
        return bench(args)
    except BenchError as err:
        log(f"lakebench: {err}")
        return 2


def bench(args, cell: Cell | None = None, dev=None) -> int:
    """One run. ``cell`` and ``dev`` are for tests on the CPU, which skip
    the look for a card; a run on the card passes neither. A test's
    process holds other tests' imports, so there the module check counts
    only what the run itself loads."""
    preloaded = set() if dev is None else set(forbidden_modules())
    cell = cell or Cell.load(args.workload)
    set_caches()
    import torch

    dev = dev or card(torch, int(cell.entry["chips"]))
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise BenchError(f"the program (src/repro_torch) is not in {ROOT}")
    sys.path.insert(0, str(src))
    from repro_torch import obs
    from repro_torch.obs import REGISTRY

    from . import devtrace, generator, lake
    from .loop import ClosedLoop

    cfg, mix = cell.config, cell.mix
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    obs.set_enabled(bool(args.trace))
    io0 = io_bytes()
    phases = {}

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0
        log(f"lakebench: {name} {phases[name]:.3f} s")

    t = time.perf_counter()
    hist = generator.make_history(cfg, args.seed, dev)
    rows = hist.emb.cpu().numpy()
    hist.emb = None                      # the program gets host rows only
    if on_card:
        # the peak that device_peak_gb reads is the program's own
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    phase("history", t)
    base = Path(tempfile.mkdtemp(prefix="lakebench-"))
    try:
        t = time.perf_counter()
        lake.write_cold(str(base), hist, cfg, rows)
        phase("cold_commits", t)
        io1 = io_bytes()
        t = time.perf_counter()
        store = lake.open_lake(str(base), cfg, dev)
        phase("open_recover", t)
        io2 = io_bytes()
        t = time.perf_counter()
        k, batch = int(mix["k"]), int(mix["max_batch"])
        warm = ClosedLoop(store.query_batcher(k=k, max_batch=batch),
                          generator.Traffic(mix, hist.instants,
                                            generator.seed_of(args.seed, 9)),
                          int(mix["outstanding"]))
        for i in range(int(mix["warmup_rounds"])):
            t_round = time.perf_counter()
            warm.run(0.0)
            sync()
            log(f"lakebench: warm-up round {i} "
                f"{time.perf_counter() - t_round:.3f} s")
        phase("warmup", t)
        del warm
        gc.collect()
        batcher = store.query_batcher(k=k, max_batch=batch)
        traces = []

        def keep_trace():
            tr = obs.current_trace()
            if tr is not None:
                traces.append(tr.root)

        loop = ClosedLoop(batcher, generator.Traffic(mix, hist.instants,
                                                     args.seed),
                          int(mix["outstanding"]),
                          on_batch=keep_trace if args.trace else None,
                          sample=int(mix["check_sample"]),
                          rng=random.Random(generator.seed_of(args.seed, 5)))
        setup_s = time.perf_counter() - T_START
        log(f"lakebench: setup_s {setup_s:.3f}")
        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile
            # the card's activities only (the host's side is in the
            # program's spans); a test on the CPU profiles the host
            prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                       else ProfilerActivity.CPU])
            prof.__enter__()
        t_trace = time.perf_counter()
        window = loop.run(args.seconds)
        sync()
        trace_window_s = time.perf_counter() - t_trace
        ops = []
        if prof is not None:
            prof.__exit__(None, None, None)
            ops = devtrace.device_ops(prof)
            del prof
        peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
        label = {"batcher": batcher.label}
        counters = {n: REGISTRY.counter(n, **label).value for n in
                    ("batcher_requests", "batcher_batches",
                     "batcher_hedges", "batcher_failed_batches")}
        run = Run(cell, float(args.seconds), window, setup_s, traces,
                  counters, peak, ops, trace_window_s, int(cfg["dim"]), k,
                  loop, phases)
        kind = "per_layer" if args.trace else "end_to_end"
        metrics = {}
        for m in cell.metrics(kind):
            reader = load_py(reader_file(kind, m["name"]))
            val = reader.read(run)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        samples = [Sample(s.text, s.at, answer(s.req))
                   for s in loop.reservoir]
        attempted, failed = len(loop.t_sent), loop.failed()
        del store, batcher, loop, run, traces
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        io3 = io_bytes()
        log(f"lakebench: bytes written: cold {delta(io0, io1)}, open "
            f"{delta(io1, io2)}, whole run so far {delta(io0, io3)}")
        t = time.perf_counter()
        numbers = judge(cell, hist, rows, dev, samples)
        phase("check", t)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    found = sorted(set(forbidden_modules()) - preloaded)
    if found:
        raise BenchError(f"modules loaded that the run must not load: "
                         f"{found}")
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if on_card else "cpu"),
                         "count": int(cell.entry["chips"]),
                         "memory_peak_bytes": peak,
                         "power": power_limit() if on_card else ""}}
    if args.trace:
        summ = devtrace.summary(ops)
        result["device"]["busy_s"] = summ["busy_s"]
        result["device"]["window_s"] = trace_window_s
        result["breakdown"] = {"device_ops": summ["device_ops"],
                               "idle_gaps": summ["idle_gaps"]}
    result["setup_phases_s"] = phases
    result["batcher"] = counters
    result["checks"] = numbers
    for name, v in numbers.items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def delta(a: dict, b: dict) -> str:
    return (f"{(b.get('write_bytes', 0) - a.get('write_bytes', 0)) / 1e9:.3f}"
            f" GB to storage, {(b.get('wchar', 0) - a.get('wchar', 0)) / 1e9:.3f}"
            " GB by write calls")


@dataclasses.dataclass
class Sample:
    text: str
    at: object
    answer: object          # [(chunk id, score)], or None if never answered


def answer(req):
    """A request's answer as served, or None if it never got one."""
    if not req.done or req.error is not None:
        return None
    return [(r.chunk_id, r.score) for r in req.result]


def judge(cell: Cell, hist, rows, dev, samples) -> dict:
    """The check's numbers for ``samples``, each beside its limit."""
    import torch

    from .checks import load_check

    check = load_check(cell.limits["check"])
    ctx = check.context(hist, torch.as_tensor(rows, device=dev), rows,
                        cell.config, cell.mix)
    nums = check.numbers(ctx, samples)
    return {name: {"value": nums[name], "limit": float(lim)}
            for name, lim in cell.limits["limits"].items()}


if __name__ == "__main__":
    sys.exit(main())
