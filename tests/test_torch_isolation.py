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
                               "flash_decode", "temporal_mask_score",
                               "topk_search"]
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
