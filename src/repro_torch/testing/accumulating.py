"""Which ops of a call add into a tensor at indices: on the card such an
op (``index_add_``, ``scatter_add_``, ``index_put_`` with accumulate, the
backward of ``index_select`` or ``gather``, ...) adds with float atomics
in no fixed order, so a gradient through it changes from run to run.
``accumulating_ops(fn)`` lists them for ``fn()``, backward included, by
watching every aten call at the dispatcher."""
from __future__ import annotations

from typing import Callable

# aten ops that add into a tensor at indices
ACCUMULATING = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_",
    "index_select_backward", "embedding_dense_backward",
    "embedding_backward", "_embedding_bag_backward",
    "_embedding_bag_dense_backward"})
# aten ops that do where their ``accumulate`` argument (4th) is true
ACCUMULATE_FLAG = frozenset({"index_put", "index_put_", "_index_put_impl",
                             "_index_put_impl_", "put", "put_"})


def accumulating_ops(fn: Callable) -> list[str]:
    """The names of the accumulating aten ops that ``fn()`` runs, in call
    order; the autograd engine's threads carry the watch into a
    backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen: list[str] = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name in ACCUMULATING:
                seen.append(name)
            elif name in ACCUMULATE_FLAG and kwargs.get(
                    "accumulate", len(args) > 3 and args[3]):
                seen.append(f"{name}(accumulate=True)")
            return func(*args, **kwargs)

    with Watch():
        fn()
    return seen
