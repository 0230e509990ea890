"""Carry weights between repro's param pytrees and the port's params, so
that both packages compute the same function: into the port's serving
modules (``params_from_repro``) and, for training, into train trees, the
port's copy of repro's own layout (``tree_from_numpy``, ``train_tree``),
params and optimizer state alike.

repro keeps a transformer's params as nested dicts of arrays, with every
layer's params stacked on a leading (L, ...) axis:

    {"embed": (V, D), "final_ln": (D,), "lm_head": (D, V),
     "layers": {"ln1": (L, D), "ln2": (L, D),
                "attn": {"wq": (L, D, H*Dh), "wk", "wv", "wo", ["bq", ...]},
                "mlp": {"win": (L, D, F'), "wout": (L, F, D)}}}

An MoE layer holds "moe" in place of "mlp": {"router": (L, D, E) fp32,
"w_in": (L, E_pad, D, F'), "w_out": (L, E_pad, F, D), ["shared_w_in",
"shared_w_out"]}. The router stays fp32 in a bf16 model, as repro keeps
it, and the experts keep their padded E_pad axis.

Pass it as numpy arrays (``jax.tree.map(np.asarray, params)``): this
module imports no JAX. bf16 arrays (numpy's ``ml_dtypes`` bfloat16) are
widened to fp32 on the way, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.common import resolve_device
from .transformer import TransformerConfig, layer_module, model_module


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":      # bfloat16 and other extension types
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def params_from_repro(np_tree: dict, cfg: TransformerConfig, device=None):
    """repro's param pytree (numpy leaves) -> the port's modules, in
    ``cfg.dtype`` on ``device`` (None = the card); an MoE router in
    fp32."""
    device = resolve_device(device)
    lay = np_tree["layers"]
    n = np.asarray(lay["ln1"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"params hold {n} layers, config {cfg.n_layers}")

    def conv(a):
        return _tensor(a, cfg.dtype, device)

    ffn = "moe" if "moe" in lay else "mlp"

    def conv_ffn(name, a):
        if name == "router":
            return _tensor(a, torch.float32, device)
        return conv(a)

    layers = []
    for i in range(n):
        layers.append(layer_module({
            "ln1": conv(lay["ln1"][i]), "ln2": conv(lay["ln2"][i]),
            "attn": {k: conv(v[i]) for k, v in lay["attn"].items()},
            ffn: {k: conv_ffn(k, v[i]) for k, v in lay[ffn].items()},
        }))
    return model_module(conv(np_tree["embed"]), layers,
                        conv(np_tree["final_ln"]), conv(np_tree["lm_head"]))


def params_to_repro(params) -> dict:
    """The port's modules -> repro's param pytree, numpy leaves (fp32 for
    bf16 parameters), layers stacked on a leading axis."""
    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    layers = list(params["layers"])

    def stack(get):
        return np.stack([host(get(lp)) for lp in layers])

    def group(sub):
        return {name: stack(lambda lp, n=name: lp[sub][n])
                for name, _ in layers[0][sub].named_parameters()}

    ffn = "moe" if hasattr(layers[0], "moe") else "mlp"
    return {
        "embed": host(params["embed"]),
        "final_ln": host(params["final_ln"]),
        "lm_head": host(params["lm_head"]),
        "layers": {
            "ln1": stack(lambda lp: lp["ln1"]),
            "ln2": stack(lambda lp: lp["ln2"]),
            "attn": group("attn"),
            ffn: group(ffn),
        },
    }


# ---------------------------------------------------------------------------
# recsys: FM, DLRM, Wide&Deep (BERT4Rec is a transformer: params_from_repro)
# ---------------------------------------------------------------------------
def recsys_params_from_repro(np_tree: dict, arch: str, cfg, device=None):
    """repro's recsys param pytree (numpy leaves) of ``arch`` ("fm",
    "dlrm-mlperf", "wide-deep" or "bert4rec") -> the port's modules, in
    ``cfg.dtype`` on ``device`` (None = the card)."""
    from . import recsys

    if arch == "bert4rec":
        return params_from_repro(np_tree, cfg, device)
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, cfg.dtype, device)

    build = {"fm": recsys.fm_module, "dlrm-mlperf": recsys.dlrm_module,
             "wide-deep": recsys.widedeep_module}
    if arch not in build:
        raise KeyError(f"no recsys bridge for {arch!r}")
    return build[arch](conv(np_tree))


def recsys_params_to_repro(params, arch: str) -> dict:
    """The port's recsys modules -> repro's param pytree (numpy leaves,
    fp32 for bf16 parameters)."""
    if arch == "bert4rec":
        return params_to_repro(params)
    out: dict = {}
    for name, t in params.named_parameters():
        t = t.detach().cpu()
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


# ---------------------------------------------------------------------------
# train trees: repro's layout as dicts of leaf tensors
# ---------------------------------------------------------------------------
def tree_from_numpy(np_tree, device=None, dtype=None):
    """repro's pytree (numpy leaves: params, optimizer state) -> a dict
    tree of tensors on ``device`` (None = the card), each leaf in its own
    dtype (numpy's bfloat16 -> torch.bfloat16, exactly) or in ``dtype``
    where given. An empty dict stays empty (SGD's state)."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        want = dtype
        if a.dtype.kind not in "fiub":       # ml_dtypes' bfloat16
            want = want or torch.bfloat16
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device=device,
                                                dtype=want)

    return conv(np_tree)


def tree_to_numpy(tree):
    """A dict tree of tensors -> numpy leaves (bf16 widened to fp32,
    exactly), for repro (``jnp.asarray(..., dtype)`` narrows it back)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_tree(params) -> dict:
    """The port's serving params (``init_params``, ``*_init``,
    ``params_from_repro``) as a train tree: repro's layout, a dict of
    leaf tensors; a transformer's layers stacked on a leading axis (a
    copy), a recsys model's tensors as they lie (no copy)."""
    from .transformer import stack_layers

    if hasattr(params, "layers"):
        return stack_layers(params)
    out: dict = {}
    for name, t in params.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach()
    return out
