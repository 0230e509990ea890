"""Fault-tolerant checkpointing with elastic restore (repro's
``train/checkpoint.py`` in PyTorch, the same on-disk format).

  - per-leaf .npy blobs under step directories, written tmp-then-rename;
  - a manifest.json committed LAST by atomic rename: a checkpoint is
    visible iff its manifest exists, so a crash mid-save can never be
    mistaken for a complete checkpoint;
  - SHA-256 content checksums per leaf (``blob_checksum`` of the file),
    verified on load;
  - leaves named by their ``jax.tree_util.keystr`` path
    (``['params']['layers']['attn']['wq']``, ``train/tree.leaves``) and
    numbered in JAX's flatten order, so a checkpoint one package writes
    restores in the other; a bf16 leaf is stored as repro stores it (2
    raw bytes a value, ``'<V2'`` in the .npy header, dtype "bfloat16" in
    the manifest);
  - ELASTIC restore: leaves are whole logical arrays, so a checkpoint
    written on any mesh restores on any other, on one card or CPU, or in
    repro. On one card a restore goes onto the caller's device
    (``device``, or each target leaf's own). On a mesh (``mesh=``,
    ``specs=``, ``layout=``) ``save`` writes each rank's block's bytes
    at their places in the whole leaf's file (no leaf is ever gathered:
    the save moves no data between ranks), and ``restore`` cuts each
    rank its blocks out of the whole arrays. A block lies at its spec's
    ``local_slice`` (``launch/sharding``), a gated leaf's (``[gate |
    up]``, the ZeRO layout's ``act``) as ``[gate_r | up_r]``:
    ``train/zero.block_runs``. Every rank writes into the same files, so
    the checkpoint directory must be one that every rank sees; a
    restore verifies its files' checksums on a few threads at once;
  - async save: the copy to the host runs inline, the disk write on a
    background thread that overlaps the next step (one card; a mesh
    save returns when committed);
  - retention: the last ``keep_last`` checkpoints are kept, older ones
    pruned.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.hashing import file_checksum
from .tree import leaves, unflatten

GATHER_CHUNK = 1 << 26    # elements of a block copied to the host at a time, about


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
             extra: Optional[dict] = None, mesh=None, specs: Any = None,
             layout=None) -> str:
        """Copy every leaf to the host, then write (optionally async).

        On a ``mesh`` (every rank calls it): ``tree`` is this rank's
        blocks, ``specs`` a tree of the same structure holding each
        leaf's spec (for a train state ``{"params": the param specs,
        "opt_state": the state's}``: ``CellBundle.sharding_fn(mesh)``'s
        first two), ``layout`` the rank's ``train/zero.ZeroLayout`` (its
        ``act`` marks the gated leaves; None: no leaf is gated). Each
        rank writes its blocks into the leaves' files, rank i mod world
        syncs and hashes leaf i's, and rank 0 commits the manifest once
        the others' entries reach it; the call returns once it is
        committed (``blocking`` is ignored)."""
        if mesh is not None:
            return self._save_mesh(step, tree, extra or {}, mesh, specs,
                                   getattr(layout, "act", ""))
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

    def _begin(self, step: int) -> str:
        tmp = self._step_dir(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    @staticmethod
    def _write_leaf(tmp: str, i: int, arr: np.ndarray, dtype: str) -> dict:
        """Write leaf ``i``'s .npy file, hashing its bytes as they are
        written (``blob_checksum`` of the file, without reading it
        back)."""
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            out = _Hashed(f)
            np.save(out, arr)
            f.flush()
            os.fsync(f.fileno())
        return {"file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha256": out.hash.hexdigest()}

    def _commit(self, step: int, tmp: str, manifest: dict) -> None:
        # manifest written INSIDE tmp, then the whole dir renamed: the
        # rename is the commit point
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def _write(self, step: int, host, extra: dict) -> None:
        tmp = self._begin(step)
        manifest = {"step": step, "leaves": {}, "extra": extra}
        for i, (name, arr, dtype) in enumerate(host):
            manifest["leaves"][name] = self._write_leaf(tmp, i, arr, dtype)
        self._commit(step, tmp, manifest)

    def _save_mesh(self, step: int, tree, extra: dict, mesh, specs,
                   act: str) -> str:
        """Rank 0 lays out every leaf's .npy file (the header ``np.save``
        writes, then room for the whole array); each rank writes its
        block's bytes at their places in the file (of blocks that ranks
        hold alike, the one at coordinate 0 of the other axes; a leaf no
        axis splits, rank i mod world), with no collective but barriers;
        then rank i mod world hashes and syncs leaf i's file, and rank 0
        commits the manifest with every leaf's entry."""
        from concurrent.futures import ThreadPoolExecutor

        import torch.distributed as dist

        from ..launch.mesh import coordinate

        me, world = dist.get_rank(), dist.get_world_size()
        tmp = self._step_dir(step) + ".tmp"
        coord = coordinate(mesh)
        flat_specs = dict(leaves(specs))
        plan = []                       # (i, name, block, spec, shape, dtype)
        for i, (name, t) in enumerate(leaves(tree)):
            spec, shape = _whole(t, flat_specs[name], mesh)
            plan.append((i, name, t.detach(), spec, shape,
                         to_host(t.reshape(-1)[:1]).dtype))
        if me == 0:
            self._begin(step)
            for i, _, _, _, shape, dtype in plan:
                _lay_out(os.path.join(tmp, f"leaf_{i:05d}.npy"), shape,
                         dtype)
        dist.barrier()
        for i, name, t, spec, shape, dtype in plan:
            axes = _split_axes(spec, mesh)
            if axes:
                mine = all(coord[a] == 0 for a, n in
                           zip(mesh.mesh_dim_names, mesh.shape)
                           if n > 1 and a not in axes)
                runs = _runs(name, shape, spec, mesh, coord, act)
            else:
                mine, runs = i % world == me, tuple(((0, n),) for n in shape)
            if mine:
                _write_block(os.path.join(tmp, f"leaf_{i:05d}.npy"), t,
                             runs, shape)
        dist.barrier()
        owned = [(i, name, shape, dtype) for i, name, _, _, shape, dtype
                 in plan if i % world == me]
        with ThreadPoolExecutor(max_workers=max(1, min(8, len(owned)))) \
                as pool:
            sums = list(pool.map(lambda o: _seal(os.path.join(
                tmp, f"leaf_{o[0]:05d}.npy")), owned))
        mine = {name: {"file": f"leaf_{i:05d}.npy", "shape": list(shape),
                       "dtype": _dtype_name(plan[i][2]), "sha256": csum}
                for (i, name, shape, _), csum in zip(owned, sums)}
        entries = [None] * world
        dist.all_gather_object(entries, mine)
        if me == 0:
            written = {k: v for e in entries for k, v in e.items()}
            self._commit(step, tmp, {
                "step": step, "extra": extra,
                "leaves": {name: written[name] for _, name, *_ in plan}})
        dist.barrier()
        return self._step_dir(step)

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
                device=None, verify: bool = True, mesh=None,
                specs: Any = None, layout=None) -> tuple[Any, int, dict]:
        """Restore into the STRUCTURE of target_tree: a new tree of tensors
        in each target leaf's dtype, on ``device`` (None: each target
        leaf's device). Without a mesh the shapes must match. On a
        ``mesh`` (``specs`` and ``layout`` as ``save`` takes them)
        ``target_tree`` is this rank's blocks: each whole array of the
        checkpoint is cut to the rank's block, which must have the
        target's shape (elastic: any mesh, or none, may have written
        it)."""
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
        flat_specs = dict(leaves(specs)) if mesh is not None else {}
        act = getattr(layout, "act", "")
        if verify:
            _verify(d, manifest, [name for name, _ in named])
        new_leaves = []
        for name, tgt in named:
            meta = manifest["leaves"][name]
            path = os.path.join(d, meta["file"])
            if mesh is None:
                arr = np.load(path)
            else:                      # read only the rank's block
                arr = _block_of(name, np.load(path, mmap_mode="r"),
                                flat_specs[name], mesh, act)
            t = from_host(arr, meta["dtype"])
            if tuple(t.shape) != tuple(tgt.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(t.shape)} != {tuple(tgt.shape)}")
            new_leaves.append(t.to(device=device or tgt.device,
                                   dtype=tgt.dtype))
        return (unflatten(target_tree, new_leaves), step,
                manifest.get("extra", {}))


def _verify(d: str, manifest: dict, names: list) -> None:
    """Each named leaf's file against its checksum, the files hashed on a
    few threads at once (reading and SHA-256 release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    metas = [manifest["leaves"][n] for n in names]
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(names)))) as pool:
        sums = list(pool.map(lambda m: file_checksum(
            os.path.join(d, m["file"])), metas))
    for name, meta, got in zip(names, metas, sums):
        if got != meta["sha256"]:
            raise IOError(f"checksum mismatch for {name}")


class _Hashed:
    """A file's ``write`` that also feeds the bytes to SHA-256
    (``core/hashing.blob_checksum``'s hash)."""

    def __init__(self, f):
        self.f, self.hash = f, hashlib.sha256()

    def write(self, data) -> int:
        self.hash.update(data)
        return self.f.write(data)


# ---------------------------------------------------------------------------
# a leaf's blocks on a mesh
# ---------------------------------------------------------------------------
def _split_axes(spec, mesh) -> tuple:
    """The axes (size > 1, mesh order) that split a leaf under ``spec``."""
    from ..launch.sharding import _axes

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    named = {a for e in spec for a in _axes(e)}
    return tuple(a for a in mesh.mesh_dim_names
                 if a in named and sizes[a] > 1)


def _runs(name: str, shape: tuple, spec, mesh, coord: dict, act: str):
    from ..models.tp import gated_leaf
    from .zero import block_runs

    return block_runs(shape, spec, mesh, coord, gated_leaf(name, act))


def _index(runs) -> tuple:
    """numpy's index of the positions ``runs`` (``block_runs``'): slices
    where each dimension is one run."""
    if all(len(r) == 1 for r in runs):
        return tuple(slice(lo, hi) for ((lo, hi),) in runs)
    return np.ix_(*[np.concatenate([np.arange(lo, hi) for lo, hi in r])
                    for r in runs])


def _block_of(name: str, arr: np.ndarray, spec, mesh, act: str
              ) -> np.ndarray:
    """This rank's block of the whole array ``arr`` (a memory map) under
    ``spec``, a copy in memory."""
    from ..launch.mesh import coordinate

    if arr.ndim == 0 or not _split_axes(spec, mesh):
        return np.array(arr)
    return np.array(arr[_index(_runs(name, arr.shape, spec, mesh,
                                     coordinate(mesh), act))])


def _whole(t: torch.Tensor, spec, mesh) -> tuple:
    """(``spec`` padded to ``t``'s dimensions, the whole leaf's shape)
    of a rank's block ``t``."""
    from ..launch.sharding import _axes

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    return spec, tuple(n * int(np.prod([sizes[a] for a in _axes(e)]))
                       for n, e in zip(t.shape, spec))


def _lay_out(path: str, shape: tuple, dtype) -> None:
    """An .npy file of ``shape`` and ``dtype``: the header ``np.save``
    writes, then zeros for the data (the ranks write their blocks)."""
    head = np.lib.format.header_data_from_array_1_0(np.empty((0,), dtype))
    head["shape"] = tuple(shape)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, head)
        f.truncate(f.tell() + int(np.prod(shape)) * np.dtype(dtype).itemsize)


def _write_block(path: str, t: torch.Tensor, runs, shape: tuple) -> None:
    """Write a rank's block ``t`` of a leaf of ``shape`` into its .npy
    file (laid out by ``_lay_out``) at the global positions ``runs``: one
    write for each span that is contiguous in the file (the run of the
    last dimension that the block cuts, times the whole dimensions after
    it), copied to the host ``GATHER_CHUNK`` elements of the block's
    first dimension at a time."""
    nd = len(shape)
    if nd == 0:
        with open(path, "r+b") as f:
            f.seek(-t.element_size(), os.SEEK_END)
            f.write(to_host(t).tobytes())
        return
    cut = [d for d in range(nd) if runs[d] != ((0, shape[d]),)]
    j = max(cut) if cut else 0        # spans: runs of dim j, whole after
    unit = int(np.prod(shape[j + 1:]))
    stride = [int(np.prod(shape[d + 1:])) for d in range(nd)]
    pos = [np.concatenate([np.arange(lo, hi) for lo, hi in r]) for r in runs]
    local = []                          # each run of dim j in the block
    b = 0
    for lo, hi in runs[j]:
        local.append((lo, hi, b))
        b += hi - lo
    per = max(1, GATHER_CHUNK // max(1, t[0].numel())) if nd > 1 \
        else t.shape[0]
    with open(path, "r+b") as f:
        fd = f.fileno()
        start = f.seek(0, os.SEEK_END) - int(np.prod(shape)) * \
            t.element_size()
        item = t.element_size()
        for a in range(0, t.shape[0], per):
            h = to_host(t[a:a + per])
            if j == 0:                  # spans of dim 0 in rows a..
                for lo, hi, b in local:
                    s, e = max(a, b), min(a + len(h), b + hi - lo)
                    if s < e:
                        os.pwrite(fd, h[s - a:e - a].tobytes(),
                                  start + (lo + s - b) * unit * item)
                continue
            for idx in np.ndindex(*h.shape[:j]):
                off = pos[0][a + idx[0]] * stride[0] + sum(
                    pos[d][idx[d]] * stride[d] for d in range(1, j))
                row = h[idx]
                for lo, hi, b in local:
                    os.pwrite(fd, row[b:b + hi - lo].tobytes(),
                              start + (int(off) + lo * unit) * item)


def _seal(path: str) -> str:
    """Sync a written leaf's file to disk; its checksum."""
    with open(path, "rb+") as f:
        os.fsync(f.fileno())
    return file_checksum(path)
