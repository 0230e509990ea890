"""Fault-tolerant checkpointing with elastic restore (repro's
``train/checkpoint.py`` in PyTorch, the same on-disk format).

  - per-leaf .npy blobs under step directories, written tmp-then-rename;
  - a manifest.json committed LAST by atomic rename: a checkpoint is
    visible iff its manifest exists, so a crash mid-save can never be
    mistaken for a complete checkpoint;
  - SHA-256 content checksums per leaf (``blob_checksum``), verified on
    load;
  - leaves named by their ``jax.tree_util.keystr`` path
    (``['params']['layers']['attn']['wq']``, ``train/tree.leaves``) and
    numbered in JAX's flatten order, so a checkpoint one package writes
    restores in the other; a bf16 leaf is stored as repro stores it (2
    raw bytes a value, ``'<V2'`` in the .npy header, dtype "bfloat16" in
    the manifest);
  - ELASTIC restore: leaves are whole logical arrays; on one card that
    means a restore onto the caller's device (``device``, or each target
    leaf's own);
  - async save: the copy to the host runs inline, the disk write on a
    background thread that overlaps the next step;
  - retention: the last ``keep_last`` checkpoints are kept, older ones
    pruned.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.hashing import blob_checksum
from .tree import leaves, unflatten


def to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf as the numpy array repro would save: bf16 as 2-byte void
    values (numpy has no bfloat16 without ml_dtypes). Always a copy: the
    train step updates its params in place while an async save writes."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("<V2"))
    return t.numpy()


def from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded .npy array as a tensor; "bfloat16" leaves come back from
    their 2-byte void form."""
    a = np.asarray(a, order="C")             # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16" or (a.dtype.kind == "V"
                                    and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, root: str, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: Optional[dict] = None) -> str:
        """Copy every leaf to the host, then write (optionally async)."""
        host = [(name, to_host(t), _dtype_name(t))
                for name, t in leaves(tree)]
        if blocking:
            self._write(step, host, extra or {})
        else:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._pending.start()
        return self._step_dir(step)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def _write(self, step: int, host, extra: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}, "extra": extra}
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            with open(path, "rb") as f:
                csum = blob_checksum(f.read())
            manifest["leaves"][name] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha256": csum}
        # manifest written INSIDE tmp, then the whole dir renamed: the
        # rename is the commit point
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- load ---------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.root, d,
                                                "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None,
                device=None, verify: bool = True
                ) -> tuple[Any, int, dict]:
        """Restore into the STRUCTURE of target_tree (shapes must match):
        a new tree of tensors in each target leaf's dtype, on ``device``
        (None: each target leaf's device)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.root}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        named = leaves(target_tree)
        missing = [n for n, _ in named if n not in manifest["leaves"]]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
        new_leaves = []
        for name, tgt in named:
            meta = manifest["leaves"][name]
            path = os.path.join(d, meta["file"])
            if verify:
                with open(path, "rb") as f:
                    if blob_checksum(f.read()) != meta["sha256"]:
                        raise IOError(f"checksum mismatch for {name}")
            t = from_host(np.load(path), meta["dtype"])
            if tuple(t.shape) != tuple(tgt.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(t.shape)} != {tuple(tgt.shape)}")
            new_leaves.append(t.to(device=device or tgt.device,
                                   dtype=tgt.dtype))
        return (unflatten(target_tree, new_leaves), step,
                manifest.get("extra", {}))
