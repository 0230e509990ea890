"""Port parity for the training substrate: repro_torch's ``train/``
(optimizers, gradient compression, checkpoints, the Trainer), the train
pieces of ``models/layers`` and ``launch/steps`` (gradient accumulation),
``data/pipeline`` and the train CLI, against repro's on the same numpy
inputs, on the CPU.

Optimizer trees keep repro's layer-stacked leaves: a (L, D) norm scale,
(L, D, F) weights, a 1-d bias, a 0-d scalar and a (V, D) table, with
L = 3. Tolerances: optimizers and compression 1e-6 (fp32, the same
operations in the same order on both sides; measured 0 to 1.2e-7),
losses and gradients 1e-4 of the largest |value| (sums in other
orders)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as repro_pipeline
from repro.launch import steps as repro_steps
from repro.models import transformer as repro_tfm
from repro.train import grad_compress as repro_gc
from repro.train import optimizer as repro_opt
from repro.train.checkpoint import CheckpointManager as ReproCkpt
from repro.train.train_loop import Trainer as ReproTrainer
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models.bridge import tree_from_numpy, tree_to_numpy
from repro_torch.train import grad_compress, optimizer
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_loop import (Trainer,
                                          grad_accum_value_and_grad)
from repro_torch.train.tree import leaves

L = 3


def _tree(rng, scale=1.0):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa
    return {"embed": f(11, 8), "w0": f(),
            "layers": {"ln1": f(L, 8), "attn": {"wq": f(L, 8, 12),
                                                "bq": f(L, 12)},
                       "mlp": {"win": f(L, 8, 16)}},
            "bias": f(5)}


def _named_np(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in flat}


def _close(got_tree, want_tree, tol=1e-6):
    got = {n: t.detach().numpy() for n, t in leaves(got_tree)}
    want = _named_np(want_tree)
    assert sorted(got) == sorted(want)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=tol, atol=tol,
                                   err_msg=n)


def test_leaf_names_are_jax_keystr():
    rng = np.random.default_rng(0)
    t = _tree(rng)
    assert [n for n, _ in leaves(tree_from_numpy(t, "cpu"))] == \
        list(_named_np(t))


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, warmup_steps=3)),
    ("adamw", dict(lr=1e-3, weight_decay=0.3, warmup_steps=1)),
    ("adafactor", dict(lr=1e-2, warmup_steps=2)),
    ("sgd", dict(lr=0.1)),
])
def test_optimizer_matches_repro(name, kw):
    """Five steps on the same stacked tree and grads: params and state
    within 1e-6. Adafactor factors the (L, D) leaf across its layers and
    clips each (L, D, F) leaf's update one layer at a time, as repro."""
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    r_opt, t_opt = (repro_opt.get_optimizer(name, **kw),
                    optimizer.get_optimizer(name, **kw))
    r_p = jax.tree.map(jnp.asarray, p_np)
    r_s = r_opt.init(r_p)
    t_p = tree_from_numpy(p_np, "cpu")
    t_s = t_opt.init(t_p)
    _close(t_s, r_s)
    for step in range(5):
        g_np = _tree(rng, scale=10.0 ** (step - 2))
        r_p, r_s = r_opt.update(jax.tree.map(jnp.asarray, g_np), r_s, r_p,
                                jnp.asarray(step, jnp.int32))
        t_p2, t_s2 = t_opt.update(tree_from_numpy(g_np, "cpu"), t_s, t_p,
                                  torch.tensor(step, dtype=torch.int32))
        assert t_p2 is t_p and t_s2 is t_s                 # in place
        _close(t_p, r_p)
        _close(t_s, r_s)


def test_adafactor_state_granularity():
    """The factored state of repro's stacked leaves: (L, D) -> r (L,),
    c (D,); (L, D, F) -> r (L, D), c (L, F); 0/1-d -> v."""
    t = tree_from_numpy(_tree(np.random.default_rng(2)), "cpu")
    st = optimizer.adafactor().init(t)
    assert st["layers"]["ln1"]["r"].shape == (L,)
    assert st["layers"]["ln1"]["c"].shape == (8,)
    assert st["layers"]["mlp"]["win"]["r"].shape == (L, 8)
    assert st["layers"]["mlp"]["win"]["c"].shape == (L, 16)
    assert st["bias"]["v"].shape == (5,) and st["w0"]["v"].shape == ()


def test_adamw_bf16_param_rounds_once():
    p = {"w": torch.tensor([1.0, -2.0, 3.0], dtype=torch.bfloat16)}
    opt = optimizer.adamw(lr=0.1, warmup_steps=1)
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.float32
    g = {"w": torch.tensor([0.5, 0.5, -0.5], dtype=torch.bfloat16)}
    ref = (p["w"].float() - 0.1 * (torch.sign(g["w"].float())
                                   + 0.01 * p["w"].float()))
    opt.update(g, st, p, 0)
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], ref.to(torch.bfloat16))


def test_compress_decompress_matches_repro():
    """Four steps of int8 compression with error feedback: the grads and
    the carried error within 1e-6 of repro's; one scale a stacked leaf
    (its amax over all L layers)."""
    rng = np.random.default_rng(3)
    r_e = repro_gc.init_state(jax.tree.map(jnp.asarray, _tree(rng)))
    t_e = grad_compress.init_state(tree_from_numpy(_tree(rng), "cpu"))
    for _ in range(4):
        g = _tree(rng)
        r_g, r_e = repro_gc.compress_decompress(
            jax.tree.map(jnp.asarray, g), r_e)
        t_g, t_e = grad_compress.compress_decompress(
            tree_from_numpy(g, "cpu"), t_e)
        _close(t_g, r_g)
        _close(t_e, r_e)
    x = torch.from_numpy(_tree(rng)["layers"]["mlp"]["win"])
    q, scale = grad_compress.quantize_int8(x)
    assert q.dtype == torch.int8 and scale.shape == ()
    assert float(scale) == pytest.approx(float(x.abs().max() + 1e-12) / 127)
    err = (grad_compress.dequantize_int8(q, scale) - x).abs().max()
    assert float(err) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_removes_bias():
    rng = np.random.default_rng(4)
    g_true = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    ef = {"g": torch.zeros(256)}
    acc = torch.zeros(256)
    for _ in range(200):
        deq, ef = grad_compress.compress_decompress({"g": g_true}, ef)
        acc += deq["g"]
    np.testing.assert_allclose((acc / 200).numpy(), g_true.numpy(),
                               rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "nested": {"b": torch.ones(5, dtype=torch.int32),
                           "h": torch.randn(6).to(torch.bfloat16)}}
        mgr.save(7, tree, extra={"note": "x"})
        restored, step, extra = mgr.restore(tree)
        assert step == 7 and extra == {"note": "x"}
        for (n, a), (_, b) in zip(leaves(restored), leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b), n

    def test_corruption_detected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = {"a": torch.ones(4)}
        d = mgr.save(1, tree)
        with open(os.path.join(d, "leaf_00000.npy"), "r+b") as f:
            f.seek(-1, 2)
            f.write(b"\xff")
        with pytest.raises(IOError, match="checksum"):
            mgr.restore(tree)

    def test_partial_save_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"a": torch.ones(3)})
        os.makedirs(str(tmp_path / "step_0000000002.tmp"))
        assert mgr.all_steps() == [1]

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"a": torch.ones(2)})
        assert mgr.all_steps() == [3, 4]

    def test_async_save_copies_before_the_next_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t = torch.ones((1000, 100))
        mgr.save(3, {"a": t}, blocking=False)
        t.add_(1.0)                    # the next step updates in place
        mgr.wait()
        assert mgr.all_steps() == [3]
        restored, _, _ = mgr.restore({"a": t})
        assert float(restored["a"].max()) == 1.0

    def test_trainer_crash_resume(self, tmp_path):
        """Four steps straight, against two steps, a checkpoint, a brand-
        new Trainer restored from it and two more: params and optimizer
        state bit for bit."""
        cell = steps.build_cell("mistral-nemo-12b", "train_4k", reduced=True,
                                device="cpu")
        p0, _, _, _ = steps.make_smoke_args(cell, seed=1)
        batches = [steps.smoke_batch(cell, seed=10 + i) for i in range(4)]
        fresh = lambda: tree_from_numpy(tree_to_numpy(p0), "cpu",  # noqa
                                        torch.bfloat16)
        one = Trainer(cell.loss, optimizer.adamw(warmup_steps=1), fresh())
        one.run(batches, n_steps=4)
        ck = str(tmp_path / "ck")
        two = Trainer(cell.loss, optimizer.adamw(warmup_steps=1), fresh(),
                      ck, checkpoint_every=2, async_checkpoint=False)
        two.run(batches[:2], n_steps=2)
        three = Trainer(cell.loss, optimizer.adamw(warmup_steps=1), fresh(),
                        ck)
        assert three.try_restore() and three.state.step == 2
        three.run(batches[2:], n_steps=2)
        for a, b in ((one.state.params, three.state.params),
                     (one.state.opt_state, three.state.opt_state)):
            for (n, x), (_, y) in zip(leaves(a), leaves(b)):
                assert torch.equal(x, y), n

    @pytest.mark.parametrize("direction", ["port->repro", "repro->port"])
    def test_cross_package_restore(self, tmp_path, direction):
        """A train cell's params and AdamW state, written by one package,
        restore in the other with every leaf equal (fp32)."""
        rb = repro_steps.build_cell("dlrm-mlperf", "train_batch",
                                    reduced=True)
        r_params, r_opt, _, _ = repro_steps.make_smoke_args(rb, seed=2)
        tree_np = {"params": jax.tree.map(np.asarray, r_params),
                   "opt_state": jax.tree.map(np.asarray, r_opt)}
        port_tree = tree_from_numpy(tree_np, "cpu")
        if direction == "port->repro":
            CheckpointManager(str(tmp_path)).save(5, port_tree)
            got, step, _ = ReproCkpt(str(tmp_path)).restore(
                jax.tree.map(jnp.asarray, tree_np))
            want = tree_np
            got = jax.tree.map(np.asarray, got)
        else:
            ReproCkpt(str(tmp_path)).save(5, jax.tree.map(jnp.asarray,
                                                          tree_np))
            got, step, _ = CheckpointManager(str(tmp_path)).restore(
                port_tree)
            got, want = tree_to_numpy(got), tree_np
        assert step == 5
        g, w = _named_np(got), _named_np(want)
        assert sorted(g) == sorted(w)
        for n in g:
            np.testing.assert_array_equal(g[n], w[n], err_msg=n)
        names = json.load(open(tmp_path / "step_0000000005" /
                               "manifest.json"))["leaves"]
        assert "['params']['tables']['table_0']" in names
        assert "['opt_state']['m']['bot']['w0']" in names


# ---------------------------------------------------------------------------
# the Trainer, gradient accumulation, the layers' train pieces
# ---------------------------------------------------------------------------
def _lm_cell(seed=1):
    rb = repro_steps.build_cell("mistral-nemo-12b", "train_4k", reduced=True)
    r_params = jax.tree.map(lambda a: a.astype(jnp.float32),
                            repro_steps.make_smoke_args(rb, seed=seed)[0])
    pb = steps.build_cell("mistral-nemo-12b", "train_4k", reduced=True,
                          device="cpu")
    return rb, r_params, pb


def test_trainer_loss_history_matches_repro():
    """Four AdamW steps of the reduced Mistral-NeMo cell in fp32 through
    both packages' Trainers: every step's loss and grad norm within
    1e-4."""
    rb, r_params, pb = _lm_cell()
    cfg = rb.model_cfg
    batches = [steps.smoke_batch(pb, seed=20 + i) for i in range(4)]
    r_batches = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
                 for b in batches]
    r = ReproTrainer(lambda p, b: repro_tfm.loss_fn(p, b, cfg),
                     repro_opt.adamw(warmup_steps=2), r_params)
    t = Trainer(pb.loss, optimizer.adamw(warmup_steps=2),
                tree_from_numpy(jax.tree.map(np.asarray, r_params), "cpu"))
    want = r.run(r_batches, n_steps=4, log_every=1)
    got = t.run(batches, n_steps=4, log_every=1)
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_repro(accum):
    """Microbatch j is rows j::accum; loss and grads are the means over
    the microbatches (fp32, within 1e-4 of each leaf's largest)."""
    rb, r_params, pb = _lm_cell(seed=2)
    cfg = rb.model_cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(4, cfg.vocab, (8, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels[:, :3] = -1
    fn = repro_steps.grad_accum_value_and_grad(
        lambda p, b: repro_tfm.loss_fn(p, b, cfg), accum)
    want_l, want_g = fn(r_params, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)})
    vg = steps.grad_accum_value_and_grad(pb.loss, accum)
    got_l, got_g = vg(tree_from_numpy(jax.tree.map(np.asarray, r_params),
                                      "cpu"),
                      {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    assert abs(float(got_l) - float(want_l)) <= 1e-4 * abs(float(want_l))
    want = _named_np(want_g)
    for n, g in leaves(got_g):
        lim = 1e-4 * float(np.abs(want[n]).max())
        assert float(np.abs(g.numpy() - want[n]).max()) <= lim, n


def test_cross_entropy_matches_repro():
    from repro.models.layers import cross_entropy_loss as repro_ce
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[0, :4] = -1
    got = layers.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    want = repro_ce(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    none = -np.ones((2, 7), np.int32)              # nothing to count: 0
    assert float(layers.cross_entropy_loss(torch.from_numpy(logits),
                                           torch.from_numpy(none))) == 0.0


def test_chunked_attention_matches_repro():
    from repro.models.layers import chunked_attention as repro_chunked
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 4, 48, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    for causal in (True, False):
        got = layers.chunked_attention(*(torch.from_numpy(x)
                                         for x in (q, k, v)), causal=causal,
                                       chunk=16)
        want = repro_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_grad_cast_keeps_bf16_grads_bf16():
    """A bf16 param's grad is bf16 without any cast (autograd returns a
    gradient in its input's dtype), through fp32 ops downstream."""
    w = torch.randn(4, 4).to(torch.bfloat16).requires_grad_(True)
    x = torch.randn(3, 4).to(torch.bfloat16)
    loss = (x @ layers.grad_cast(w)).float().square().sum()
    loss.backward()
    assert w.grad.dtype == torch.bfloat16
    assert layers.grad_cast(w) is w


def test_remat_gives_the_same_grads():
    """cfg.remat recomputes each layer in the backward: the same loss and
    grads, bit for bit, as without it."""
    import dataclasses
    pb = steps.build_cell("qwen2-moe-a2.7b", "train_4k", reduced=True,
                          device="cpu")
    params, _, batch, _ = steps.make_smoke_args(pb, seed=3)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pb.model_cfg, remat=remat)
        out.append(grad_accum_value_and_grad(
            lambda p, b: steps.tfm.loss_fn(p, b, cfg))(params, batch))
    assert torch.equal(out[0][0], out[1][0])
    for (n, a), (_, b) in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# data pipeline and CLI
# ---------------------------------------------------------------------------
def test_pipeline_is_repros():
    a = pipeline.synthetic_lm_batches(100, 2, 8, seed=3)
    b = repro_pipeline.synthetic_lm_batches(100, 2, 8, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    got = list(pipeline.Prefetcher(iter(range(5)), depth=2))
    assert got == [0, 1, 2, 3, 4]
    r = next(pipeline.synthetic_recsys_batches(3, 10, 4, seed=1))
    w = next(repro_pipeline.synthetic_recsys_batches(3, 10, 4, seed=1))
    np.testing.assert_array_equal(r["ids"], w["ids"])


def test_train_cli_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    first = train.main(["--arch", "fm", "--shape", "train_batch",
                        "--reduced", "--steps", "4", "--device", "cpu",
                        "--checkpoint-dir", ck, "--checkpoint-every", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == first
    assert sorted(os.listdir(ck)) == ["step_0000000002", "step_0000000004"]
    again = train.main(["--arch", "fm", "--shape", "train_batch",
                        "--reduced", "--steps", "2", "--device", "cpu",
                        "--checkpoint-dir", ck, "--resume",
                        "--compress-grads"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert np.isfinite(again["last_loss"])


def test_lookup_backward_matches_jnp_take():
    """FM's and Wide&Deep's ``lookup`` (plain torch: repro has no kernel
    there): its backward adds each in-range id's cotangent to its row, a
    negative id in [-V, -1] to row id + V, and an id outside adds to no
    row (its forward row is NaN), as jax.vjp of ``jnp.take``."""
    from repro_torch.models.recsys import lookup
    rng = np.random.default_rng(11)
    table = rng.standard_normal((20, 4)).astype(np.float32)
    ids = np.array([[0, 3, 3], [19, -1, -20], [25, -21, 7]], np.int32)
    g = rng.standard_normal((3, 3, 4)).astype(np.float32)
    g[np.isin(ids, [25, -21])] = 0.0         # the NaN rows' cotangent
    t = torch.from_numpy(table).requires_grad_(True)
    out = lookup(t, torch.from_numpy(ids))
    assert bool(torch.isnan(out[2, :2]).all())
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(ids), axis=0),
                     jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)
