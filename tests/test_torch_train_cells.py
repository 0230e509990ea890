"""Port parity for the train cells: repro_torch's ``launch/steps``
``build_cell`` of every LM, recsys and GNN arch's train shape, at reduced
size on the CPU, against repro's on the same arrays (``make_smoke_args``
gives both the same batch; repro's params and optimizer state cross as
numpy through ``models/bridge.tree_from_numpy``). The reference is
``jax.value_and_grad`` of repro's loss, with repro's attention and bags
in their "ref" mode (the CPU default here).

Each cell is held twice. In fp32 (params widened, exactly): the loss and
every gradient leaf within 1e-4 of the leaf's largest |value| (the sums
run in other orders on the two sides; measured at most 0.021 of that
limit). As registered (bf16 for the LM archs), each grad in its param's
dtype: the loss under the BF16 rule of tests/test_torch_lm_cells.py (one
rounding step plus 2**-5 of itself), but every gradient leaf within
2**-4 of repro's in relative L2 norm (``GRAD_BF16``), and no farther from
the exact gradient (repro's fp32 one) than 1.25 x repro's own bf16
gradient is, in relative L2 norm (``BF16_ACCURACY``; floored at 2**-9,
about one bf16 rounding of the gradient alone). The per-element BF16
rule measured 1.1-1.3x over its limit on the dense archs' grads and up
to 26x on the MoE experts' (two layers of backward, each side rounding
to bf16 at other points, and a token near an expert's capacity edge
kept by one side only); the relative norms measured at most 0.038
(Kimi-K2's ln2), and the port's distance from the exact gradient at
most 1.03 x repro's (Nemotron-4's lm_head). Then a whole step
(``bundle.fn``: grads, optimizer update) against repro's in fp32, params
and optimizer state within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import schnet as repro_schnet_cfg
from repro.launch import steps as repro_steps
from repro.models import recsys as repro_recsys
from repro.models import schnet as repro_schnet
from repro.models import transformer as repro_tfm
from repro_torch.configs import all_cells
from repro_torch.launch import steps
from repro_torch.models.bridge import tree_from_numpy, tree_to_numpy
from repro_torch.testing import rounding_agree
from repro_torch.train.train_loop import grad_accum_value_and_grad
from repro_torch.train.tree import leaves

BF16 = dict(rel=2 ** -7, slack=2 ** -5)
GRAD_BF16 = 2 ** -4
BF16_ACCURACY = 1.25
TRAIN_CELLS = [c for c in all_cells() if c.kind == "train"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def _repro_loss(rb):
    cfg = rb.model_cfg
    if rb.arch == "schnet":
        info = repro_schnet_cfg.SHAPES_REDUCED[rb.shape]
        if info.get("molecular"):
            return lambda p, b: repro_schnet.energy_loss(
                p, cfg, dict(b, n_graphs=info["graphs"]))
        return lambda p, b: repro_schnet.node_class_loss(p, cfg, b)
    fns = {"fm": repro_recsys.fm_loss,
           "wide-deep": repro_recsys.widedeep_loss,
           "dlrm-mlperf": repro_recsys.dlrm_loss,
           "bert4rec": repro_recsys.bert4rec_loss}
    if rb.arch in fns:
        return lambda p, b: fns[rb.arch](p, cfg, b)
    return lambda p, b: repro_tfm.loss_fn(p, b, cfg)


def _named(tree) -> dict:
    return dict(leaves(tree))


def _repro_named(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(jnp.asarray(a, jnp.float32))
            for p, a in flat}


def _cells(seed):
    def make(c):
        rb = repro_steps.build_cell(c.arch, c.shape, reduced=True)
        r_args = repro_steps.make_smoke_args(rb, seed=seed)
        pb = steps.build_cell(c.arch, c.shape, reduced=True, device="cpu")
        return rb, r_args, pb
    return make


def test_train_cells_are_repros():
    assert len(TRAIN_CELLS) == 13
    for c in TRAIN_CELLS:
        rb = repro_steps.build_cell(c.arch, c.shape, reduced=True)
        pb = steps.build_cell(c.arch, c.shape, reduced=True, device="cpu")
        assert (pb.kind, pb.optimizer, pb.accum) == ("train", rb.optimizer,
                                                     1)
        full = steps.build_cell(c.arch, c.shape, device="cpu")
        assert full.accum == steps.TRAIN_ACCUM_STEPS.get(c.arch, 1)


@pytest.mark.parametrize("cell", TRAIN_CELLS, ids=lambda c: c.key)
def test_train_cell_loss_and_grads_match_repro(cell):
    rb, r_args, pb = _cells(7)(cell)
    r_params, _, r_batch, _ = r_args
    p_args = steps.make_smoke_args(
        pb, seed=7, params=tree_from_numpy(_np_tree(r_params), "cpu"))
    params, opt_state, batch, step = p_args
    assert int(step) == 0 and list(batch) == list(r_batch)
    for name in r_batch:                                 # the same batch
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(r_batch[name], jnp.float32)),
            batch[name].float().numpy())
    # the optimizer's fresh state is repro's
    r_opt = _repro_named(r_args[1])
    p_opt = _named(opt_state)
    assert sorted(r_opt) == sorted(p_opt)
    loss_r = _repro_loss(rb)

    exact = None                            # repro's fp32 gradient
    for dtype in ("fp32", "registered"):
        rp = r_params if dtype == "registered" else _f32(r_params)
        want_l, want_g = jax.value_and_grad(loss_r)(rp, r_batch)
        pp = tree_from_numpy(_np_tree(rp), "cpu")
        got_l, got_g = grad_accum_value_and_grad(pb.loss)(pp, batch)
        want_g = _repro_named(want_g)
        exact = exact or want_g
        got = _named(got_g)
        assert sorted(got) == sorted(want_g)
        bf16 = dtype == "registered" and pb.model_cfg.dtype == torch.bfloat16
        for name, g in got.items():
            assert g.dtype == _named(pp)[name].dtype, name
            w = torch.from_numpy(want_g[name].copy())
            assert bool(torch.isfinite(g.float()).all()), name
            if bf16:
                rel = float(torch.linalg.vector_norm(g.float() - w)
                            / torch.linalg.vector_norm(w))
                assert rel <= GRAD_BF16, (name, rel)
                x = torch.from_numpy(exact[name].copy())
                norm = torch.linalg.vector_norm(x)
                mine = float(torch.linalg.vector_norm(g.float() - x) / norm)
                theirs = float(torch.linalg.vector_norm(w - x) / norm)
                assert mine <= BF16_ACCURACY * max(theirs, 2 ** -9), (
                    name, mine, theirs)
            else:
                lim = 1e-4 * max(float(w.abs().max()), 1e-30)
                err = float((g.float() - w).abs().max()) if g.numel() else 0
                assert err <= lim, (name, err, lim)
        if bf16:
            ok, ratio = rounding_agree(got_l.reshape(1, 1),
                                       torch.tensor([[float(want_l)]]),
                                       **BF16)
            assert ok, ratio
        else:
            assert abs(float(got_l) - float(want_l)) <= 1e-4 * max(
                1.0, abs(float(want_l)))


@pytest.mark.parametrize("cell", TRAIN_CELLS, ids=lambda c: c.key)
def test_train_step_matches_repro(cell):
    """One whole step in fp32: grads and the optimizer's update in place,
    against repro's step function on the same params and state. A param
    within 1e-4 of its leaf's largest |value| plus 2 lr_t: AdamW's first
    step moves a param by about lr_t * sign(g), and a leaf whose exact
    gradient is 0 (a key bias: softmax ignores a constant shift of the
    logits) has a gradient of rounding noise whose sign the two sides
    need not share. The optimizer state within 1e-4 of the largest
    |value| of its tree (m, v) for the same reason."""
    rb, r_args, pb = _cells(3)(cell)
    r_params, r_batch, r_step = _f32(r_args[0]), r_args[2], r_args[3]
    opt = {"adamw": repro_steps.adamw, "adafactor":
           repro_steps.adafactor}[rb.optimizer]()
    r_opt = opt.init(r_params)
    want_p, want_o, want_l = rb.fn(r_params, r_opt, r_batch, r_step)
    params = tree_from_numpy(_np_tree(r_params), "cpu")
    opt_state = tree_from_numpy(_np_tree(r_opt), "cpu")
    _, _, batch, step = steps.make_smoke_args(pb, seed=3, params=params)
    got_p, got_o, got_l = pb.fn(params, opt_state, batch, step)
    assert got_p is params and got_o is opt_state
    assert abs(float(got_l) - float(want_l)) <= 1e-4 * max(
        1.0, abs(float(want_l)))
    lr_t = 1e-4 / 100                    # adamw's lr, warmup step 0
    for state, got, want in ((False, got_p, want_p), (True, got_o, want_o)):
        got, want = _named(got), _repro_named(want)
        assert sorted(got) == sorted(want)
        whole = max(float(np.abs(w).max()) for w in want.values() if w.size)
        for name, t in got.items():
            w = want[name]
            lim = 1e-4 * whole if state else \
                1e-4 * float(np.abs(w).max()) + 2 * lr_t
            err = float(np.abs(t.detach().float().numpy() - w).max()) \
                if t.numel() else 0.0
            assert err <= lim, (name, err, lim)
    # the bridge carries the tree back to repro's leaves
    back = tree_to_numpy(got_p)
    assert sorted(_repro_named(back)) == sorted(_repro_named(want_p))
