"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``src/repro_torch/csrc/<name>.cu`` becomes one shared library with
a plain C interface, ``build/repro_torch/lib<name>-<digest>.so`` at the
root of the checkout, compiled at first use for ``sm_90a`` (Hopper).
``<digest>`` hashes the source, the shared headers and the flags, so an
edited source is rebuilt and a built one is reused. ``build()`` starts
one ``nvcc`` per source, all at once. A missing ``nvcc`` or a failed
compile raises: there is no fallback.

Run ``python -m repro_torch.kernels.build`` to build every source and
print the compiler's register and shared-memory report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[str, ctypes.CDLL] = {}     # name -> the library ``load`` bound
_lock = threading.Lock()


def sources() -> list[str]:
    """Names of the buildable sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "of repro_torch are compiled at first use and need the CUDA "
        "toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every named source (default: all) that is not built yet,
    one ``nvcc`` each, all started together. Returns the compiler's
    output per compiled source; raises on the first failure."""
    names = sources() if names is None else list(names)
    todo = [(n, lib_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, bind=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``bind(lib)`` declares its C signatures, once a library and under the
    lock, before this call returns it: a thread that asks with ``bind``
    never gets a library whose entries are half declared (ctypes would
    pass 64-bit pointers as ``int``), whoever loaded it first."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        if bind is not None and _bound.get(name) is not lib:
            bind(lib)
            _bound[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry of
    ``lib``."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


if __name__ == "__main__":
    for src, log in build().items():
        print(f"== {src}.cu\n{log}")
