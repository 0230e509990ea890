"""repro_torch stands alone: it imports no JAX and nothing of repro, its
entry points run on the card unless asked for the CPU, and its kernel
build fails loudly instead of falling back."""
import os
import re
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.kernels.build as build
from repro_torch.core.hot_tier import HotTier
from repro_torch.core.cold_tier import ColdTier
from repro_torch.core.store import LiveVectorLake
from repro_torch.core.temporal import TemporalEngine
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.temporal_mask_score import ops as tops
from repro_torch.kernels.topk_search import ops as kops
from repro_torch.launch.ingest import main as ingest_cli
from repro_torch.shard import ShardFabric

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = list(path.relative_to(PKG.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "repro_torch.core.store" in mods and len(mods) > 40
    assert {"repro_torch.shard", "repro_torch.shard.planner",
            "repro_torch.shard.shard", "repro_torch.shard.rebalance",
            "repro_torch.serve.maintenance",
            "repro_torch.launch.ingest"} <= set(mods)
    code = f"""
import sys
sys.modules["jax"] = None            # any "import jax" now raises
import importlib
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "repro" or m.startswith("repro.") or m == "jax"
    or m.startswith("jax.") or m.startswith("jaxlib")))
assert not bad, bad
print("ok", len({mods!r}))
"""
    src = str(PKG.parent)
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_no_source_file_imports_repro_or_jax():
    pat = re.compile(r"^\s*(from|import)\s+(repro|jax|jaxlib)(\.|\s|$)",
                     re.M)
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        assert not pat.search(text), path
        assert "import jax" not in text and "from repro" not in text, path


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveVectorLake(str(tmp_path / "lake"))
    assert not (tmp_path / "lake").exists()    # refused before any write
    with pytest.raises(RuntimeError):
        HotTier(16)
    with pytest.raises(RuntimeError):
        TemporalEngine(ColdTier(str(tmp_path / "cold"), 16))
    lake = LiveVectorLake(str(tmp_path / "cpu"), dim=16, device="cpu")
    assert lake.hot.device.type == lake.temporal.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardFabric(str(tmp_path / "fab"))
    assert not (tmp_path / "fab").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest_cli(["--root", str(tmp_path / "cli"), "stats"])
    fab = ShardFabric(str(tmp_path / "fab-cpu"), dim=16, device="cpu")
    assert {fab.lake(s).store.device.type for s in fab.ring.shards} \
        == {"cpu"}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("topk_search")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(fake.parent) + os.pathsep
                       + os.environ["PATH"])
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="exit 3"):
        build.load("temporal_mask_score")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_names_every_source_and_rebuilds_on_edit(monkeypatch,
                                                       tmp_path):
    assert build.sources() == ["embedding_bag", "flash_attention",
                               "flash_decode", "segment_sum",
                               "temporal_mask_score", "topk_search"]
    for name in build.sources():
        assert "sm_90a" in " ".join(build.NVCC_FLAGS)
        assert build.lib_path(name).parent == build.BUILD_DIR
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.lib_path("topk_search")
    (csrc / "topk_tile.cuh").write_text(
        (csrc / "topk_tile.cuh").read_text() + "\n")
    assert build.lib_path("topk_search") != before


class _StubEntry:
    """A ctypes function whose first signature declaration pauses (the
    binding thread is preempted between two entries)."""

    def __init__(self, pause=None):
        self._argtypes, self.restype, self._pause = None, None, pause

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self._argtypes = value
        if self._pause is not None:
            pause, self._pause = self._pause, None
            pause()


class _StubLib:
    def __init__(self, first, pause):
        self._entries = {first: _StubEntry(pause)}

    def __getattr__(self, name):
        return self._entries.setdefault(name, _StubEntry())


@pytest.mark.parametrize("ops,first,second", [
    (kops, "topk_search_f32", "topk_search_q8"),
    (tops, "temporal_window_topk_f32", "temporal_window_topk_q8")])
def test_no_thread_sees_a_half_bound_library(monkeypatch, ops, first,
                                             second):
    """A thread that asks for a scan library while another is binding it
    waits for every entry to be declared: it never gets the library with
    its f32 entry bound and its q8 entry not (ctypes would then pass the
    q8 call's 64-bit pointers as int)."""
    import threading

    paused, release = threading.Event(), threading.Event()

    def pause():
        paused.set()
        release.wait(5.0)

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", lambda names=None: {})
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: _StubLib(first, pause))
    seen = {}

    def first_user():
        ops._lib()

    def second_user():
        lib = ops._lib()
        seen["q8"] = getattr(lib, second).argtypes

    a = threading.Thread(target=first_user)
    a.start()
    assert paused.wait(5.0)          # a is between the two entries
    b = threading.Thread(target=second_user)
    b.start()
    b.join(0.3)
    waited = b.is_alive()            # b must wait for a's binding
    release.set()
    a.join(5.0)
    b.join(5.0)
    assert not a.is_alive() and not b.is_alive()
    assert seen["q8"] is not None, "second thread got a half-bound library"
    assert waited


@pytest.mark.parametrize("ops,entry", [(kops, "topk_search_q8"),
                                       (tops, "temporal_window_topk_q8")])
def test_a_library_loaded_unbound_is_bound_before_use(monkeypatch, ops,
                                                      entry):
    """A library someone loaded without its binder (a preload of every
    source) is bound when a wrapper first asks for it, and a library
    swapped in under the same name is bound again."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_bound", {}, raising=False)
    monkeypatch.setattr(build, "build", lambda names=None: {})
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: _StubLib(entry, None))
    name = ops.__name__.split(".")[-2]
    first = build.load(name)
    assert getattr(first, entry).argtypes is None
    assert ops._lib() is first and getattr(first, entry).argtypes
    other = _StubLib(entry, None)
    build._loaded[name] = other
    assert ops._lib() is other and getattr(other, entry).argtypes


def test_launch_counts_lose_no_update_across_threads():
    import sys
    import threading

    before = kops.launches, kops.launches_q8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [kops._count(1, q8)
                                               for _ in range(2000)
                                               for q8 in (False, True)])
              for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert (kops.launches - before[0], kops.launches_q8 - before[1]) \
        == (32000, 32000)
    kops.launches, kops.launches_q8 = before
