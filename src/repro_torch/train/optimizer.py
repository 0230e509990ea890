"""Optimizers of the train path (repro's ``train/optimizer.py`` in
PyTorch): AdamW, Adafactor and SGD with repro's ``(init, update)``
contract over a param tree (``train/tree``).

``update(grads, state, params, step)`` returns ``(params, state)`` as
repro's does, but updates both IN PLACE and returns the same trees: at
Mistral-NeMo's width the params, grads, m and v of 8 layers take 42 GB,
and a second copy of any of them would not fit one card beside the
step's activations. It runs under ``torch.no_grad``. Each leaf is updated
in fp32 (m, v and the factored accumulators are fp32) and rounded once to
its dtype.

Granularity is repro's: a param tree keeps each layer's params stacked
(L, ...), and

  - Adafactor factors every leaf of ndim >= 2 over its two trailing
    dims, so a stacked (L, D) norm scale is factored across the layer
    axis and its update clipped over all L layers at once;
  - a leaf of ndim >= 3 with more than one layer is updated slice by
    slice over its leading axis (repro's ``_layer_mapped``): Adafactor's
    row means and RMS clip are those of one layer's matrix, and the fp32
    temporaries are one slice's. AdamW is elementwise, so its slices
    (and the row chunks of a large 2-d leaf) change no value, only the
    size of the temporaries.

The schedule terms (warmup, bias corrections, Adafactor's decay) are
fp32 scalars computed on the param's device, as repro's traced step
computes them, so no step reads back to the host.

On a mesh (``layout``, a ``train/zero.ZeroLayout``: ``launch/steps``
passes one to a train cell's optimizer), ``init`` makes the state at the
rank's ZeRO-1 blocks and ``update`` takes the rank's param blocks and
their gradients (summed over the axes their spec does not name): each
leaf's ZeRO block is updated, then all-gathered over the ZeRO axes into
the param block in place. AdamW's update is then the replicated one bit
for bit. Adafactor's factored statistics (the row and column means of a
layer's matrix, the RMS of its update) are summed over the axes that
split the block, so they are those of the whole matrix; its accumulators
lie at repro's ``zero1_opt_specs`` and are all-gathered whole for the
step (they are a matrix's row and column vectors).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .tree import leaves, tree_map

CHUNK = 1 << 26       # elements of one AdamW temporary, at most


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (params, opt_state)


def _layer_mapped(fn: Callable, *arrays: torch.Tensor) -> None:
    """``fn`` on each leading-axis slice of a layer-stacked leaf (ndim >= 3,
    more than one layer), else on the whole leaf."""
    if arrays[0].dim() >= 3 and arrays[0].shape[0] > 1:
        for i in range(arrays[0].shape[0]):
            fn(*(a[i] for a in arrays))
    else:
        fn(*arrays)


def _row_chunks(fn: Callable, *arrays: torch.Tensor) -> None:
    """``fn`` on row chunks of at most ``CHUNK`` elements (an elementwise
    ``fn`` only)."""
    a0 = arrays[0]
    if a0.dim() == 0 or a0.numel() <= CHUNK:
        fn(*arrays)
        return
    per = max(1, CHUNK // max(1, a0[0].numel()))
    for i in range(0, a0.shape[0], per):
        fn(*(a[i:i + per] for a in arrays))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _step(step, like: torch.Tensor) -> torch.Tensor:
    """The step as an fp32 scalar on ``like``'s device."""
    if isinstance(step, torch.Tensor):
        return step.to(device=like.device, dtype=torch.float32)
    return _f32(float(step), like)


def _warmup(lr: float, warmup_steps: int, step: torch.Tensor
            ) -> torch.Tensor:
    return lr * torch.clamp((step + 1.0) / warmup_steps, max=1.0)


def _first(params) -> torch.Tensor:
    return leaves(params)[0][1]


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          warmup_steps: int = 100, layout=None) -> Optimizer:
    def init(params):
        if layout is not None:
            return layout.state_blocks(_first(params).device)
        return {"m": tree_map(lambda p: _zeros(p.shape, p), params),
                "v": tree_map(lambda p: _zeros(p.shape, p), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if not leaves(params):
            return params, state
        s = _step(step, _first(params))
        lr_t = _warmup(lr, warmup_steps, s)
        bc1 = 1.0 - _f32(b1, s) ** (s + 1.0)
        bc2 = 1.0 - _f32(b2, s) ** (s + 1.0)

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)

        for (path, g), (_, m), (_, v), (_, p) in zip(
                leaves(grads), leaves(state["m"]), leaves(state["v"]),
                leaves(params)):
            lf = None if layout is None else layout.leaf(path)
            if lf is not None:
                g, p_all, p = lf.zero_block(g), p, lf.zero_block(p)
            _layer_mapped(lambda *a: _row_chunks(upd, *a), g, m, v, p)
            if lf is not None:
                layout.gather_back(p_all, lf)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, factored second moment)
# ---------------------------------------------------------------------------
def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              warmup_steps: int = 100, layout=None) -> Optimizer:
    """Factored state for >= 2-d params (row/col accumulators over the two
    trailing dims); full state for 0/1-d. No fp32 master copy, no
    momentum."""

    def factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        if layout is not None:
            return layout.state_blocks(_first(params).device)

        def per_leaf(p):
            if factored(p):
                return {"r": _zeros(p.shape[:-1], p),
                        "c": _zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": _zeros(p.shape, p)}

        return tree_map(per_leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        if not leaves(params):
            return params, state
        s = _step(step, _first(params))
        lr_t = _warmup(lr, warmup_steps, s)
        beta = 1.0 - (s + 1.0) ** -decay

        def clip_apply(u, p):
            rms_u = torch.sqrt(u.square().mean() + 1e-12)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p.copy_(p.float() - lr_t * u)

        def upd_factored(g, r, c, p):
            g = g.float()
            g2 = g.square() + eps
            r.copy_(beta * r + (1 - beta) * g2.mean(-1))
            c.copy_(beta * c + (1 - beta) * g2.mean(-2))
            r_norm = r / torch.clamp(r.mean(-1, keepdim=True), min=eps)
            v_inv = torch.rsqrt(torch.clamp(r_norm[..., None]
                                            * c[..., None, :], min=eps))
            clip_apply(g * v_inv, p)

        def upd_full(g, v, p):
            g = g.float()
            v.copy_(beta * v + (1 - beta) * (g.square() + eps))
            clip_apply(g * torch.rsqrt(torch.clamp(v, min=eps)), p)

        def visit(g, st, p, path=""):
            if isinstance(p, dict):
                for k in p:
                    visit(g[k], st[k], p[k], f"{path}[{k!r}]")
            elif layout is not None and _cut(layout.leaf(path), st):
                lf = layout.leaf(path)
                _adafactor_block(layout, lf, path, lf.zero_block(g), st,
                                 lf.zero_block(p), beta, lr_t, eps,
                                 clip_threshold)
                layout.gather_back(p, lf)
            elif factored(p):
                _layer_mapped(upd_factored, g, st["r"], st["c"], p)
            else:
                _layer_mapped(upd_full, g, st["v"], p)

        visit(grads, state, params)
        return params, state

    return Optimizer(init, update)


def _cut(lf, st: dict) -> bool:
    """Whether a leaf's ZeRO block or its Adafactor state is a part of
    the whole (else the one-card update runs on it as it is)."""
    whole = {"v": lf.shape, "r": lf.shape[:-1],
             "c": lf.shape[:-2] + lf.shape[-1:]}
    return bool(lf.split_axes) or any(tuple(t.shape) != whole[k]
                                      for k, t in st.items())


def _adafactor_block(layout, lf, path: str, g: torch.Tensor, st: dict,
                     p: torch.Tensor, beta, lr_t, eps: float,
                     clip_threshold: float) -> None:
    """Adafactor's update of the ZeRO block ``p`` (gradient block ``g``)
    of a leaf that the mesh splits (``lf.split_axes``). The sums behind
    the row and column means and the RMS are taken over the block and
    summed over the axes that split it, each written at the block's
    global positions in a tensor of the whole matrix's statistics (zeros
    elsewhere), so that the sum is theirs; the accumulators (at their
    own spec) are gathered whole, updated, and cut back."""
    shape, nd = lf.shape, len(lf.shape)
    axes, dev = lf.split_axes, g.device
    g = g.float()
    mapped = nd >= 3 and shape[0] > 1        # a layer's matrix at a time

    def placed(full_shape, part, dims):
        out = part.new_zeros(full_shape)
        out[lf.index(dims, dev)] = part
        return layout.reduce(out, axes)

    def accumulate(name, full_shape, new):
        spec = layout.state_spec(f"{path}['{name}']")
        whole = layout.gather_state(st[name], full_shape, spec)
        whole = beta * whole + (1 - beta) * new
        st[name].copy_(whole[layout.local_slice(full_shape, spec)])
        return whole

    if nd >= 2:
        g2 = g.square() + eps
        r_dims = list(range(nd - 1))
        c_dims = list(range(nd - 2)) + [nd - 1]
        r_shape = shape[:-1]
        c_shape = shape[:-2] + shape[-1:]
        r = accumulate("r", r_shape,
                       placed(r_shape, g2.sum(-1), r_dims) / shape[-1])
        c = accumulate("c", c_shape,
                       placed(c_shape, g2.sum(-2), c_dims) / shape[-2])
        r_norm = r / torch.clamp(r.mean(-1, keepdim=True), min=eps)
        v_inv = torch.rsqrt(torch.clamp(
            r_norm[lf.index(r_dims, dev)][..., None]
            * c[lf.index(c_dims, dev)][..., None, :], min=eps))
        u = g * v_inv
    else:
        v = st["v"]
        v.copy_(beta * v + (1 - beta) * (g.square() + eps))
        u = g * torch.rsqrt(torch.clamp(v, min=eps))
    if mapped:
        unit = 1
        for n in shape[1:]:
            unit *= n
        sq = placed((shape[0],), u.square().sum(tuple(range(1, nd))), [0])
        rms = torch.sqrt(sq / unit + 1e-12)[lf.index([0], dev)[0]]
        rms = rms.reshape(-1, *[1] * (nd - 1))
    else:
        unit = 1
        for n in shape:
            unit *= n
        rms = torch.sqrt(layout.reduce(u.square().sum(), axes) / unit
                         + 1e-12)
    u = u / torch.clamp(rms / clip_threshold, min=1.0)
    p.copy_(p.float() - lr_t * u)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        for (_, g), (_, p) in zip(leaves(grads), leaves(params)):
            p.copy_(p.float() - lr * g.float())
        return params, state

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    """The optimizer ``name`` ("adamw", "adafactor" or "sgd"); ``kw`` its
    settings, ``layout=`` a ``train/zero.ZeroLayout`` for a rank of a
    mesh."""
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgd":
        return sgd(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
