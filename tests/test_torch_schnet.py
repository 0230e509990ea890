"""Port parity for SchNet: repro_torch's ``kernels/segment_sum`` (its
plain version, the CPU path), ``models/schnet``, ``data/sampler`` and the
bridge, against repro's on the same numpy inputs from a seed.

Tolerances: the plain ``gather_segment_sum`` and its gradients within
1e-5 of repro's ``jax.ops.segment_sum(jnp.take(x, src, axis=0) * w, dst,
n)`` times max(1, the sum of |term| over the output's edges) (the two sum
the same terms in other orders; a row of 700 terms of order 1 measured
2.7e-5 apart), NaN at exactly the same places. The model at the reduced
sizes within 1e-4 (rtol and atol; the port's matmuls and the filter's rbf
round apart from XLA's). The chunked forward (``edge_chunk``) against one
chunk: loss and every gradient leaf within 1e-5 of its largest |value|
(the chunks' sums add at the rows that straddle a chunk boundary, one
rounding apart). The sampler and the bridge bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sampler as repro_sampler
from repro.models import schnet as rs
from repro_torch.data import sampler
from repro_torch.kernels.segment_sum import (EdgePlan, gather_segment_sum,
                                             gather_segment_sum_plain,
                                             segment_sum,
                                             segment_sum_bwd_plain,
                                             segment_sum_plain, weight_grad)
from repro_torch.launch import steps
from repro_torch.models import schnet as ps
from repro_torch.models.bridge import tree_from_numpy, tree_to_numpy
from repro_torch.testing import accumulating_ops
from repro_torch.train import optimizer
from repro_torch.train.train_loop import Trainer, grad_accum_value_and_grad
from repro_torch.train.tree import leaves

TOL = dict(rtol=1e-4, atol=1e-4)
MOLECULE = ps.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=20)
FEATURE = dataclasses.replace(MOLECULE, d_feat=12, n_classes=5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _repro(x, src, dst, n_out, w=None):
    def f(x, w):
        rows = jnp.take(x, src, axis=0)
        return jax.ops.segment_sum(rows if w is None else rows * w, dst,
                                   num_segments=n_out)
    return f


def _close(got, want, scale):
    """Within 1e-5 of max(1, ``scale``) (the sum of |term| of each
    output), NaN at the same places."""
    got, want, scale = got.numpy(), np.asarray(want), np.asarray(scale)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got - want)[ok]
    assert (err <= 1e-5 * np.maximum(1.0, scale[ok])).all(), err.max()


def _edges(rng, n, n_out, e):
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n_out, e).astype(np.int32))


def _case(name, rng):
    """(x, src, dst, n_out, w) of a named case."""
    n, n_out, e, d = 30, 25, 200, 8
    src, dst = _edges(rng, n, n_out, e)
    w = rng.standard_normal((e, d)).astype(np.float32)
    if name == "wrapped_src":
        src[::3] -= n                              # [-n, -1]: row src + n
    elif name == "bad_src":
        src[::7] = n + 3                           # NaN rows
        src[1::11] = -n - 2
    elif name == "bad_dst":
        dst[::5] = n_out
        dst[1::9] = -1                             # negatives are dropped
    elif name == "empty_rows":
        dst = (dst % 10).astype(np.int32)          # rows 10..24 get nothing
    elif name == "no_w":
        w = None
    elif name == "d1":
        w = w[:, :1].copy()
        d = 1
    elif name == "hot_row":                        # > CHUNK edges into row 0
        e = 900
        src, dst = _edges(rng, n, n_out, e)
        dst[: 700] = 0
        w = rng.standard_normal((e, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x, src, dst, n_out, w


CASES = ["basic", "wrapped_src", "bad_src", "bad_dst", "empty_rows", "no_w",
         "d1", "hot_row"]


@pytest.mark.parametrize("name", CASES)
def test_gather_segment_sum_matches_repro(name):
    x, src, dst, n_out, w = _case(name, np.random.default_rng(3))
    f = _repro(x, src, dst, n_out, w)
    want = f(x, w)
    got = gather_segment_sum(_t(x), _t(src), _t(dst), n_out,
                             None if w is None else _t(w))
    _close(got, want, f(np.abs(x), None if w is None else np.abs(w)))
    alone = gather_segment_sum_plain(_t(x), _t(src), _t(dst), n_out,
                                     None if w is None else _t(w))
    assert torch.equal(alone.nan_to_num(7.0), got.nan_to_num(7.0))
    if name == "empty_rows":
        assert float(got[10:].abs().max()) == 0.0


@pytest.mark.parametrize("name", CASES)
def test_gather_segment_sum_grads_match_jax(name):
    rng = np.random.default_rng(4)
    x, src, dst, n_out, w = _case(name, rng)
    g = rng.standard_normal((n_out, x.shape[1])).astype(np.float32)
    f = _repro(x, src, dst, n_out, w)
    if w is None:
        _, vjp = jax.vjp(lambda x: f(x, None), x)
        (want_dx,), want_dw = vjp(g), None
    else:
        _, vjp = jax.vjp(f, x, w)
        want_dx, want_dw = vjp(g)
    xt = _t(x).requires_grad_(True)
    wt = None if w is None else _t(w).requires_grad_(True)
    out = gather_segment_sum(xt, _t(src), _t(dst), n_out, wt)
    out.backward(_t(g))
    # dx sums |g[dst] * w| over each row's edges; dw is one product
    _, vjp_abs = jax.vjp(lambda x: f(x, None if w is None else np.abs(w)),
                         x)
    _close(xt.grad, want_dx, vjp_abs(np.abs(g))[0])
    if w is not None:
        _close(wt.grad, want_dw, np.abs(np.asarray(want_dw)))


def _same(a, b):
    """Bit for bit where not NaN, NaN at the same places."""
    assert a.shape == b.shape
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(torch.where(a.isnan(), 0.0, a).view(torch.int32),
                       torch.where(b.isnan(), 0.0, b).view(torch.int32))


@pytest.mark.parametrize("name", CASES)
def test_segment_sum_bwd_plain_is_dx_and_weight_grad(name):
    """The backward's plain version gives dx as the forward body summed
    over the plan's src order and dw as ``weight_grad``, bit for bit
    (signed zeros included), NaN at the same places; dw also equals
    x[src] * g[dst] rounded once in numpy, with a NaN row for a bad src
    and x[src] * 0 for a dropped dst. The plan's ``skip`` lists exactly
    the edges its src order leaves out, ``gap`` the longest run of rows
    no chunk of that order reaches (the kernel zeroes those rows itself
    where it is short) and ``longest`` its most slots in a chunk."""
    rng = np.random.default_rng(6)
    x, src, dst, n_out, w = _case(name, rng)
    n, d = x.shape
    g = rng.standard_normal((n_out, d)).astype(np.float32)
    g[::4, 0] = -0.0
    plan = EdgePlan(_t(src), _t(dst), n, n_out)
    wt = None if w is None else _t(w)
    dx, dw = segment_sum_bwd_plain(_t(x), _t(g), wt, plan)
    _same(dx, segment_sum_plain(_t(g), wt, plan.bwd))
    if w is None:
        assert dw is None
    s = np.where(src < 0, src + n, src)
    src_ok = (s >= 0) & (s < n)
    dst_ok = (dst >= 0) & (dst < n_out)
    if w is not None:
        _same(dw, weight_grad(_t(x), _t(g), plan))
        rows = np.where(src_ok[:, None], x[np.where(src_ok, s, 0)], np.nan)
        cot = np.where(dst_ok[:, None], g[np.where(dst_ok, dst, 0)], 0.0)
        _same(dw, _t((rows * cot).astype(np.float32)))
        assert bool(dw.isnan().any()) == (name == "bad_src")
    np.testing.assert_array_equal(plan.skip.numpy(),
                                  np.flatnonzero(~(src_ok & dst_ok)))
    reached = np.zeros(n + 2, bool)
    reached[1:-1][s[src_ok & dst_ok]] = True
    reached[0] = reached[-1] = True
    assert plan.bwd["gap"] == int(np.diff(np.flatnonzero(reached)).max()) - 1
    per_row = np.bincount(s[src_ok & dst_ok], minlength=n)
    assert plan.bwd["longest"] == min(256, int(per_row.max()))
    only_dx = segment_sum_bwd_plain(_t(x), _t(g), wt, plan, dw=False)
    _same(only_dx[0], dx)
    assert only_dx[1] is None
    only_dw = segment_sum_bwd_plain(_t(x), _t(g), wt, plan, dx=False)
    assert only_dw[0] is None
    if w is not None:
        _same(only_dw[1], dw)


@pytest.mark.parametrize("wants", ["x", "w", "both"])
@pytest.mark.parametrize("name", ["basic", "bad_src", "bad_dst", "hot_row"])
def test_gather_segment_sum_autograd_asks_only_what_it_needs(name, wants):
    """Autograd through ``gather_segment_sum`` with only x, only w or both
    requiring grad: the gradients asked for equal ``segment_sum_bwd_plain``
    bit for bit (the same whichever else is asked), the others stay
    None, and the backward makes one call of ``segment_sum_bwd``."""
    from repro_torch.kernels.segment_sum import ops as ss
    rng = np.random.default_rng(7)
    x, src, dst, n_out, w = _case(name, rng)
    g = _t(rng.standard_normal((n_out, x.shape[1])).astype(np.float32))
    plan = EdgePlan(_t(src), _t(dst), x.shape[0], n_out)
    xt = _t(x).requires_grad_(wants in ("x", "both"))
    wt = _t(w).requires_grad_(wants in ("w", "both"))
    want_dx, want_dw = segment_sum_bwd_plain(_t(x), g, _t(w), plan)
    calls = []
    real = ss.segment_sum_bwd_plain
    ss.segment_sum_bwd_plain = lambda *a: calls.append(a[4:]) or real(*a)
    try:
        gather_segment_sum(xt, None, None, n_out, wt, plan=plan).backward(g)
    finally:
        ss.segment_sum_bwd_plain = real
    assert calls == [(wants != "w", wants != "x")]
    if wants == "w":
        assert xt.grad is None
    else:
        _same(xt.grad, want_dx)
    if wants == "x":
        assert wt.grad is None
    else:
        _same(wt.grad, want_dw)


def test_plan_orders_and_reuse():
    """One plan serves the forward and the gradient: its forward order
    sorts the kept edges by dst, its backward order the edges of an
    in-range src and a kept dst by src, both stably (ascending edge id
    within a row)."""
    rng = np.random.default_rng(5)
    x, src, dst, n_out, w = _case("bad_dst", rng)
    src[::13] = 99                                   # out of range
    plan = EdgePlan(_t(src), _t(dst), x.shape[0], n_out)
    fwd_edges = plan.fwd["edge"].numpy()
    keep = (dst >= 0) & (dst < n_out)
    np.testing.assert_array_equal(
        fwd_edges, np.argsort(np.where(keep, dst, n_out),
                              kind="stable")[:keep.sum()])
    kept = keep & (src < x.shape[0])
    np.testing.assert_array_equal(
        plan.bwd["edge"].numpy(),
        np.argsort(np.where(kept, src, x.shape[0]),
                   kind="stable")[:kept.sum()])
    got = gather_segment_sum(_t(x), None, None, n_out, _t(w), plan=plan)
    want = gather_segment_sum(_t(x), _t(src), _t(dst), n_out, _t(w))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    with pytest.raises(ValueError, match="plan for"):
        gather_segment_sum(_t(x), None, None, n_out + 1, _t(w), plan=plan)


def test_segment_sum_takes_only_fp32_at_the_plans_sizes():
    """SchNet computes in fp32: any other dtype raises; so does an x or a
    w of other rows than the plan was made for (no row is read out of
    range)."""
    x = torch.ones((4, 3), dtype=torch.float64)
    plan = EdgePlan(torch.tensor([0, 1]), torch.tensor([1, 2]), 4, 3)
    with pytest.raises(TypeError, match="float32"):
        segment_sum(x, None, plan.fwd)
    with pytest.raises(TypeError, match="float32"):
        segment_sum(x.float(), x[:2], plan.fwd)
    with pytest.raises(ValueError, match="plan wants"):
        segment_sum(x.float()[:3], None, plan.fwd)   # another plan's x
    with pytest.raises(ValueError, match="plan wants"):
        segment_sum(x.float(), x.float()[:1], plan.fwd)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _graph(rng, n, e, isolated=0):
    """Edges among the first n - isolated nodes; distances up to 12 (some
    beyond the cutoff)."""
    live = n - isolated
    ei = np.stack([rng.integers(0, live, e), rng.integers(0, live, e)])
    return ei.astype(np.int32), (rng.random(e) * 12).astype(np.float32)


def _params(cfg, seed):
    p = rs.init_params(jax.random.PRNGKey(seed), dataclasses.replace(
        cfg, dtype=jnp.float32))
    return p, tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _rcfg(cfg):
    return rs.SchNetConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)
                              if f.name != "dtype"})


def _batch(cfg, rng, n=40, e=160, isolated=0, graphs=4):
    ei, dist = _graph(rng, n, e, isolated)
    b = {"edge_index": ei, "edge_dist": dist}
    if cfg.d_feat:
        b["node_feat"] = rng.standard_normal((n, cfg.d_feat)).astype(
            np.float32)
        labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
        labels[::3] = -1                           # off the seeds
        b["labels"] = labels
    else:
        b["atom_z"] = rng.integers(1, 50, n).astype(np.int32)
        b["graph_ids"] = np.repeat(np.arange(graphs), n // graphs).astype(
            np.int32)
        b["energy"] = rng.standard_normal(graphs).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("cfg,isolated", [(MOLECULE, 0), (FEATURE, 0),
                                          (MOLECULE, 10), (FEATURE, 10)],
                         ids=["molecule", "featureful", "molecule-isolated",
                              "featureful-isolated"])
def test_forward_matches_repro(cfg, isolated):
    rng = np.random.default_rng(6)
    rp, pp = _params(cfg, 1)
    b = _batch(cfg, rng, isolated=isolated)
    kw = {"node_feat": b["node_feat"]} if cfg.d_feat else \
        {"atom_z": b["atom_z"]}
    want = rs.forward(rp, _rcfg(cfg), edge_index=b["edge_index"],
                      edge_dist=b["edge_dist"], **kw)
    got = ps.forward(pp, cfg, edge_index=_t(b["edge_index"]),
                     edge_dist=_t(b["edge_dist"]),
                     **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cfg.d_feat:
        np.testing.assert_allclose(
            ps.readout_node_logits(pp, got).numpy(),
            np.asarray(rs.readout_node_logits(rp, want)), **TOL)
    else:
        gid = b["graph_ids"].copy()
        gid[-3:] = [4, -1, 9]                       # dropped graph ids
        np.testing.assert_allclose(
            ps.readout_energy(pp, got, _t(gid), 4).detach().numpy(),
            np.asarray(rs.readout_energy(rp, want, gid, 4)), **TOL)


@pytest.mark.parametrize("cfg", [MOLECULE, FEATURE],
                         ids=["energy_loss", "node_class_loss"])
def test_loss_and_grads_match_repro(cfg):
    rng = np.random.default_rng(8)
    rp, pp = _params(cfg, 2)
    b = _batch(cfg, rng, isolated=5)
    if cfg.d_feat:
        def r_loss(p):
            return rs.node_class_loss(p, _rcfg(cfg), b)

        def p_loss(p, batch):
            return ps.node_class_loss(p, cfg, batch)
    else:
        def r_loss(p):
            return rs.energy_loss(p, _rcfg(cfg), dict(b, n_graphs=4))

        def p_loss(p, batch):
            return ps.energy_loss(p, cfg, dict(batch, n_graphs=4))
    want_l, want_g = jax.value_and_grad(r_loss)(rp)
    got_l, got_g = grad_accum_value_and_grad(p_loss)(pp, _torch_batch(b))
    assert abs(float(got_l) - float(want_l)) <= 1e-4 * max(
        1.0, abs(float(want_l)))
    flat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(want_g)[0]}
    got = dict(leaves(got_g))
    assert sorted(got) == sorted(flat)
    for name, g in got.items():
        lim = 1e-4 * max(float(np.abs(flat[name]).max()), 1e-30)
        assert float(np.abs(g.numpy() - flat[name]).max()) <= lim, name


@pytest.mark.parametrize("shape", ["molecule", "minibatch_lg"])
def test_train_path_adds_at_no_index(shape):
    """No aten op of a SchNet step's loss and gradients (one edge chunk
    and several) adds into a tensor at indices: on the card such an op
    adds with atomics, in no fixed order. ``index_select``'s backward and
    ``jnp.take``'s port ``lookup`` (the control) are such ops."""
    table = torch.zeros((5, 3), requires_grad=True)
    ids = torch.tensor([0, 1, 1])
    assert accumulating_ops(
        lambda: table.index_select(0, ids).sum().backward()) != []
    cell = steps.build_cell("schnet", shape, reduced=True, device="cpu")
    params, _, batch, _ = steps.make_smoke_args(cell, seed=3)
    cfg = cell.model_cfg
    loss = ps.energy_loss if shape == "molecule" else ps.node_class_loss
    if shape == "molecule":
        batch["n_graphs"] = 4
    for chunk in (1 << 22, 50):
        vg = grad_accum_value_and_grad(
            lambda p, b, c=chunk: loss(p, cfg, b, edge_chunk=c))
        assert accumulating_ops(lambda: vg(params, batch)) == []


def test_atom_embedding_grad_matches_jnp_take():
    """The embedding's backward (``gather_segment_sum`` into the table)
    against ``jax.vjp`` of ``jnp.take``: a negative id in [-V, -1] adds to
    row id + V, an id out of range adds to no row and reads NaN."""
    rng = np.random.default_rng(9)
    table = rng.standard_normal((20, 4)).astype(np.float32)
    ids = np.array([0, 3, 3, 19, -1, -20, 25, -21, 7, 3], np.int32)
    g = rng.standard_normal((10, 4)).astype(np.float32)
    g[[6, 7]] = 0.0                                # the NaN rows' cotangent
    t = _t(table).requires_grad_(True)
    out = ps.embed(t, _t(ids))
    assert bool(torch.isnan(out[6:8]).all())
    out.backward(_t(g))
    _, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(ids), axis=0),
                     jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", [MOLECULE, FEATURE],
                         ids=["molecule", "featureful"])
@pytest.mark.parametrize("chunk", [16, 50, 159])
def test_chunked_forward_and_grads(cfg, chunk):
    """The filter network and aggregation over chunks of ``edge_chunk``
    edges (dst-sorted, each under checkpoint) against one chunk."""
    rng = np.random.default_rng(10)
    _, pp = _params(cfg, 3)
    batch = _torch_batch(_batch(cfg, rng, isolated=3))
    loss = ps.node_class_loss if cfg.d_feat else ps.energy_loss
    if not cfg.d_feat:
        batch["n_graphs"] = 4

    def run(edge_chunk):
        return grad_accum_value_and_grad(
            lambda p, b: loss(p, cfg, b, edge_chunk=edge_chunk))(pp, batch)

    one_l, one_g = run(1 << 20)
    got_l, got_g = run(chunk)
    assert len(ps.edge_chunks(batch["edge_index"], 40, chunk)) == \
        -(-160 // chunk)
    assert abs(float(got_l) - float(one_l)) <= 1e-5 * max(1.0,
                                                           abs(float(one_l)))
    want = dict(leaves(one_g))
    for name, g in leaves(got_g):
        lim = 1e-5 * max(float(want[name].abs().max()), 1e-30)
        assert float((g - want[name]).abs().max()) <= lim, name


def test_edge_chunks_reach_only_their_rows():
    """Each chunk's plan covers just the dst range its edges reach (a
    chunk of dropped edges alone: the one row N - 1); the chunks' sums,
    each added into its rows in chunk order, against repro's over all
    edges, with a hot row across several chunks and dropped dst (negative
    and >= N) filling the last ones."""
    rng = np.random.default_rng(12)
    n, e, d, chunk = 30, 200, 5, 16
    src, dst = _edges(rng, n, n, e)
    dst[:60] = 7
    dst[-25:] = rng.choice([-3, n, n + 5], 25)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((e, d)).astype(np.float32)
    chunks = ps.edge_chunks(_t(np.stack([src, dst])), n, chunk)
    assert len(chunks) == -(-e // chunk)
    agg = torch.zeros((n, d))
    for perm, lo, plan in chunks:
        reach = dst[perm.numpy()]
        reach = reach[(reach >= 0) & (reach < n)]
        if len(reach):
            assert (lo, plan.n_out) == (reach.min(), reach.max() - lo + 1)
        else:
            assert (lo, plan.n_out) == (n - 1, 1)
        agg[lo:lo + plan.n_out] += gather_segment_sum(
            _t(x), None, None, plan.n_out, _t(w)[perm], plan=plan)
    want = _repro(x, src, dst, n)(x, w)
    _close(agg, want, jax.ops.segment_sum(
        np.abs(x[src] * w), dst, num_segments=n))


def test_init_params_tree_is_repros():
    for cfg in (MOLECULE, FEATURE, dataclasses.replace(
            FEATURE, n_interactions=3, d_hidden=64, n_rbf=300)):
        rp = rs.init_params(jax.random.PRNGKey(0), _rcfg(cfg))
        pp = ps.init_params(cfg, seed=0, device="cpu")
        want = {jax.tree_util.keystr(p): a.shape for p, a in
                jax.tree_util.tree_flatten_with_path(rp)[0]}
        got = {n: tuple(t.shape) for n, t in leaves(pp)}
        assert got == want
        assert sum(t.numel() for _, t in leaves(pp)) == cfg.n_params() + \
            cfg.n_interactions * cfg.d_hidden           # + atom_b
        again = ps.init_params(cfg, seed=0, device="cpu")
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(leaves(pp), leaves(again)))


def test_bridge_round_trip():
    """repro's SchNet params cross into the port's tree as numpy
    (``tree_from_numpy``) and back (``tree_to_numpy``) bit for bit, and
    the port's forward on them is repro's."""
    for cfg in (MOLECULE, FEATURE):
        rp, pp = _params(cfg, 4)
        back = tree_to_numpy(pp)
        flat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                jax.tree_util.tree_flatten_with_path(rp)[0]}
        got = {jax.tree_util.keystr(p): a for p, a in
               jax.tree_util.tree_flatten_with_path(back)[0]}
        assert sorted(got) == sorted(flat)
        for name in flat:
            np.testing.assert_array_equal(got[name], flat[name])
        assert isinstance(pp["interactions"]["filt_w1"], torch.Tensor)


# ---------------------------------------------------------------------------
# the sampler, the cells, the CLI
# ---------------------------------------------------------------------------
def test_sampler_is_repros():
    rng = np.random.default_rng(11)
    n, e = 500, 6000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    edges[:, :40] = 7                              # self loops of node 7
    got_csr = sampler.make_csr(n, edges)
    want_csr = repro_sampler.make_csr(n, edges)
    for a, b in zip(got_csr, want_csr):
        np.testing.assert_array_equal(a, b)
    seeds = np.array([0, 7, 499, 3, 250], np.int64)
    for fn in (None, lambda s, d: np.abs(s - d).astype(np.float32) % 11):
        got = sampler.sample_subgraph(*got_csr, seeds, (4, 3),
                                      np.random.default_rng(12),
                                      edge_dist_fn=fn)
        want = repro_sampler.sample_subgraph(*want_csr, seeds, (4, 3),
                                             np.random.default_rng(12),
                                             edge_dist_fn=fn)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name))


def test_sampled_batch_trains():
    """A step of the reduced minibatch_lg cell on a batch from
    ``sample_subgraph`` (labels -1 off the seeds, padding edges (0, 0) past
    the cutoff) matches repro's loss on the same batch."""
    rng = np.random.default_rng(13)
    n, e = 300, 3000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    sub = sampler.sample_subgraph(*sampler.make_csr(n, edges),
                                  rng.choice(n, 4, replace=False), (3, 2),
                                  np.random.default_rng(14))
    cell = steps.build_cell("schnet", "minibatch_lg", reduced=True,
                            device="cpu")
    cfg = cell.model_cfg
    feats = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    node_feat = np.where(sub.node_ids[:, None] >= 0,
                         feats[np.maximum(sub.node_ids, 0)], 0.0)
    labels = np.where(sub.seed_mask, rng.integers(0, cfg.n_classes,
                                                  len(sub.node_ids)), -1)
    b = {"edge_index": sub.edge_index, "edge_dist": sub.edge_dist,
         "node_feat": node_feat.astype(np.float32),
         "labels": labels.astype(np.int32)}
    rp, pp = _params(cfg, 5)
    want = rs.node_class_loss(rp, _rcfg(cfg), b)
    opt_state = optimizer.adamw().init(pp)
    _, _, got = cell.fn(pp, opt_state, _torch_batch(b), torch.tensor(0))
    assert abs(float(got) - float(want)) <= 1e-4 * max(1.0, abs(float(want)))


def test_gnn_cell_takes_no_microbatches():
    cell = steps.build_cell("schnet", "molecule", device="cpu")
    assert (cell.kind, cell.optimizer, cell.accum) == ("train", "adamw", 1)
    assert cell.model_cfg == ps.SchNetConfig()
    assert steps.build_cell("schnet", "molecule", device="cpu",
                            accum=1).accum == 1
    with pytest.raises(ValueError, match="not samples"):
        steps.build_cell("schnet", "minibatch_lg", device="cpu", accum=2)


def test_molecule_cell_resumes_bit_for_bit(tmp_path):
    """Four steps of the reduced molecule cell straight, against two
    steps, a checkpoint, a brand-new Trainer restored from it and two
    more: params and optimizer state bit for bit."""
    cell = steps.build_cell("schnet", "molecule", reduced=True,
                            device="cpu")
    p0, _, _, _ = steps.make_smoke_args(cell, seed=1)
    batches = [steps.smoke_batch(cell, seed=10 + i) for i in range(4)]
    fresh = lambda: tree_from_numpy(tree_to_numpy(p0), "cpu")  # noqa: E731
    one = Trainer(cell.loss, optimizer.adamw(warmup_steps=1), fresh())
    one.run(batches, n_steps=4)
    ck = str(tmp_path / "ck")
    two = Trainer(cell.loss, optimizer.adamw(warmup_steps=1), fresh(), ck,
                  checkpoint_every=2, async_checkpoint=False)
    two.run(batches[:2], n_steps=2)
    three = Trainer(cell.loss, optimizer.adamw(warmup_steps=1), fresh(), ck)
    assert three.try_restore() and three.state.step == 2
    three.run(batches[2:], n_steps=2)
    for a, b in ((one.state.params, three.state.params),
                 (one.state.opt_state, three.state.opt_state)):
        for (n, x), (_, y) in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y), n


def test_train_cli_runs_schnet(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "schnet", "--shape", "molecule",
                      "--reduced", "--steps", "3", "--device", "cpu"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert "step" in capsys.readouterr().out
