"""Device meshes (repro's ``launch/mesh.py`` on ``torch.distributed``).

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis extends data parallelism across pods.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
current process group, one rank a card. The sharding rules
(``launch/sharding``) read only a mesh's ``mesh_dim_names`` and
``shape``, so they also take a ``MeshShape``: the same two attributes
with no process group behind them (the dry run, the parity tests, and a
one-card replay of a mesh's ranks).

FUNCTIONS, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import dataclasses

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and dimension names, without ranks or groups."""
    shape: tuple
    mesh_dim_names: tuple


def _init(shape: tuple, names: tuple, device_type):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"process group of {n} ranks; the world has "
                           f"{have}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device_type=None):
    """The production mesh over a 256-rank (512 with ``multi_pod``)
    world; raises unless the process group has that size. CUDA unless
    the caller asks for ``device_type="cpu"`` (the dry run's fake
    group)."""
    shape, names = PRODUCTION[multi_pod]
    return _init(shape, names, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type=None):
    """A (data, model) mesh over the current process group (tests, the
    card). CUDA unless the caller asks for ``device_type="cpu"``."""
    return _init((data, model), ("data", "model"), device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axis group: ('pod','data') on multi-pod meshes."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def coordinate(mesh) -> dict:
    """This rank's {axis name: index} on ``mesh`` (a ``DeviceMesh``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
