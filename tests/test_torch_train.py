"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs go through both packages: logits and labels
through ``cross_entropy``; gradient trees through ``clip_by_global_norm``
and ``adamw_update``; steps through ``cosine_schedule``; (seed, step)
through ``SyntheticLMData.batch_at`` (bitwise).  Three ``make_train_step``
steps of the ``qwen2_0_5b`` smoke config (3 layers, d_model 96, head dim
16, vocab 512, remat on) start from JAX's parameters and AdamW state after
one JAX step, carried across with ``convert``; a checkpoint written by
JAX's ``CheckpointManager`` restores in the port, and one the port writes
restores in JAX.  The loop pieces mirror ``tests/test_train_substrate.py``.

Tolerances: the loss, optimizer and schedule arithmetic in f32 at rtol
1e-6 (the same f32 operations; XLA may fuse them into another rounding
order).  The train steps with ``activation_dtype="float32"``: loss and
grad norm rtol 1e-5 (f32 matmuls summed in another order); every
parameter within 1e-3 of the summed learning rates of JAX's (AdamW's
normalized step moves an element by about lr, and the gradients agree to
about 1e-5 relative, so the steps agree far inside a thousandth of lr;
an element whose step took the other sign would be up to 2 lr off).  In
the default bf16 activations, the loss and grad norm at 0.05 relative (the
bf16 tolerance of ``tests/test_torch_lm.py``).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.params import init_params as jinit
from repro.train import checkpoint as JC
from repro.train import loss as JLoss
from repro.train import optimizer as JO
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                       SyntheticLMData, shard_batch)
from repro_torch.launch import train as launch_train
from repro_torch.models import params as TP
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO
from repro_torch.train.fault_tolerance import (LoopConfig, RestartableLoop,
                                               StepTimer)
from repro_torch.train import step as TS
from repro_torch.train.loss import cross_entropy
from repro_torch.train.step import (loss_and_grads, make_eval_step,
                                    make_train_step)

ARCH = "qwen2_0_5b"
B, S = 2, 32
LR, WARMUP, TOTAL = 3e-3, 2, 10


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if torch.is_tensor(tree)
                               else tree, dtype=np.float32)}


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked, z_loss):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)   # some right answers
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want = JLoss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask),
                               z_loss=z_loss)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask),
                        z_loss=z_loss)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)
    # the gradient through the detached max is the reference's
    jg = jax.grad(lambda x: JLoss.cross_entropy(
        x, jnp.asarray(labels), z_loss=z_loss)[0])(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    cross_entropy(x, torch.from_numpy(labels), z_loss=z_loss)[0].backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)


# -------------------------------------------------------------- optimizer
def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (4, 5), "b": (5,)}, "c": (3, 2, 2)}

    def make(shape_tree, scale):
        if isinstance(shape_tree, dict):
            return {k: make(v, scale) for k, v in shape_tree.items()}
        return (scale * rng.standard_normal(shape_tree)).astype(np.float32)
    return make(shapes, 1.0), make(shapes, 0.5)


@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads, _ = _grad_trees(1)
    want, wnorm = JO.clip_by_global_norm(jax.tree_util.tree_map(
        jnp.asarray, grads), max_norm)
    got, norm = TO.clip_by_global_norm(_torch_tree(grads), max_norm)
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    np.testing.assert_allclose(TO.global_norm(got).item(),
                               float(JO.global_norm(want)), rtol=1e-6)
    for k, v in _flat(got).items():
        np.testing.assert_allclose(v, _flat(_np_tree(want))[k], rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference(weight_decay):
    _, params = _grad_trees(2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JO.adamw_init(jp)
    tp = _torch_tree(params)
    ts = TO.adamw_init(tp)
    for i in range(4):
        g = _grad_trees(10 + i)[0]
        jp, js = JO.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp, jnp.float32(0.01),
                                 weight_decay=weight_decay)
        tp, ts = TO.adamw_update(_torch_tree(g), ts, tp,
                                 torch.tensor(0.01), weight_decay=weight_decay)
    assert int(ts.step) == int(js.step) == 4 and ts.step.dtype == torch.int32
    for mine, ref in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        want = _flat(_np_tree(ref))
        for k, v in _flat(mine).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-9)


def test_cosine_schedule_matches_reference():
    want = JO.cosine_schedule(1e-3, warmup=10, total=100)
    got = TO.cosine_schedule(1e-3, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 130):
        np.testing.assert_allclose(
            got(torch.tensor(step, dtype=torch.int32)).item(),
            float(want(jnp.int32(step))), rtol=1e-6, atol=1e-12)
    assert got(torch.tensor(0)).item() == 0.0


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("lag", [1, 2])
def test_batch_at_is_bitwise_the_reference(lag):
    kw = dict(vocab_size=97, seq_len=40, global_batch=3, seed=5, lag=lag)
    mine = SyntheticLMData(DataConfig(**kw))
    ref = JData(JDataConfig(**kw))
    assert mine.host_batch == ref.host_batch == 3
    for step in (0, 1, 17):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_and_shard_batch():
    pf = Prefetcher(iter(range(10)), depth=3)
    assert [next(pf) for _ in range(10)] == list(range(10))
    batch = SyntheticLMData(DataConfig(64, 8, 2)).batch_at(0)
    placed = shard_batch(batch, "cpu")
    assert placed["tokens"].dtype == torch.int32
    assert torch.equal(placed["labels"], torch.from_numpy(batch["labels"]))


# ------------------------------------------------------------- train step
def _configs(dtype):
    over = dict(activation_dtype=dtype)
    return (dataclasses.replace(jget(ARCH), **over),
            dataclasses.replace(tget(ARCH), **over))


class WithExtras:
    """A data source whose ``batch_at(step)`` adds ``extras(step)`` (a dict
    of numpy arrays: a frontend's ``patch_embeds`` or ``frames``) to the
    batch of ``data``."""

    def __init__(self, data, extras):
        self.data, self.extras = data, extras

    def batch_at(self, step):
        batch = self.data.batch_at(step)
        if self.extras is not None:
            batch.update(self.extras(step))
        return batch


def _start(jcfg, jstep, seed=0, tree=None, seq=S, extras=None):
    """JAX's params and AdamW state after one JAX step from its init (or
    from the numpy tree ``tree``), and the data (B sequences of ``seq``,
    with ``extras(step)`` added to each batch)."""
    params = (jinit(jax.random.PRNGKey(seed), jcfg) if tree is None
              else jax.tree_util.tree_map(jnp.asarray, tree))
    state = JO.adamw_init(params)
    data = WithExtras(JData(JDataConfig(jcfg.vocab_size, seq, B, seed=seed,
                                        lag=1)), extras)
    batch = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
    params, state, _ = jstep(params, state, batch)
    return params, state, data


def three_train_steps_match_jax(jcfg, tcfg, dtype, *, tree=None, seed=0,
                                seq=S, jax_ctx=contextlib.nullcontext,
                                port_ctx=contextlib.nullcontext,
                                outliers=0.0, extras=None):
    """Three ``make_train_step`` steps (remat on, the cosine schedule)
    against JAX's jitted step, from JAX's params and AdamW state after one
    JAX step from its init (or from the numpy tree ``tree``), carried
    across with ``convert``: lr to 1e-6; in f32 the loss and grad norm to
    rtol 1e-5, the accuracy to 1e-6 and every parameter within 1e-3 of the
    summed learning rates; in bf16 the loss and grad norm to 0.05
    relative.  JAX's four steps run inside ``jax_ctx()``, then the port's
    three inside ``port_ctx()`` (an MoE test records JAX's routes and
    checks or forces the port's).  ``extras(step)`` adds a frontend's
    inputs to each batch (:class:`WithExtras`).

    ``outliers``: the share of a leaf's elements that may lie past 1e-3 of
    the summed learning rates, if within 1e-2 of them.  An element whose
    gradient is near zero (an expert weight few tokens reach) agrees only
    to f32 noise relative to its leaf's largest, and AdamW's normalised
    step magnifies that to a fraction of lr."""
    sched = dict(base_lr=LR, warmup=WARMUP, total=TOTAL)
    jstep = jax.jit(jmake_train_step(
        jcfg, learning_rate=JO.cosine_schedule(**sched), remat=True))
    tstep = make_train_step(tcfg, learning_rate=TO.cosine_schedule(**sched),
                            remat=True)
    with jax_ctx():
        jp, js, data = _start(jcfg, jstep, seed, tree, seq, extras)
        tp = lm_params_from_numpy(_np_tree(jp), tcfg, device="cpu")
        ts = adamw_state_from_numpy(_np_tree(js), tcfg, device="cpu")
        jms = []
        for step in (1, 2, 3):
            jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                        data.batch_at(step).items()})
            jms.append(jm)
    moved = []
    with port_ctx():
        for step, jm in zip((1, 2, 3), jms):
            tp, ts, tm = tstep(tp, ts, shard_batch(data.batch_at(step),
                                                   "cpu"))
            lr = float(jm["lr"])
            assert tm["lr"].item() == pytest.approx(lr, rel=1e-6)
            if dtype == "float32":
                np.testing.assert_allclose(tm["loss"].item(),
                                           float(jm["loss"]), rtol=1e-5)
                np.testing.assert_allclose(tm["grad_norm"].item(),
                                           float(jm["grad_norm"]),
                                           rtol=1e-5)
                np.testing.assert_allclose(tm["accuracy"].item(),
                                           float(jm["accuracy"]), atol=1e-6)
            else:
                for name in ("loss", "grad_norm"):
                    assert tm[name].item() == pytest.approx(
                        float(jm[name]), rel=0.05), name
            moved.append(lr)
    assert int(ts.step) == int(js.step) == 4
    if dtype != "float32":
        return
    want = _flat(_np_tree(jp))
    for k, v in _flat(tp).items():
        err = np.abs(v - want[k])
        past = int((err > 1e-3 * sum(moved)).sum())
        assert past <= outliers * v.size, (k, past, float(err.max()))
        np.testing.assert_allclose(v, want[k], rtol=0,
                                   atol=(1e-2 if past else 1e-3) * sum(moved),
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax(dtype):
    three_train_steps_match_jax(*_configs(dtype), dtype)


def remat_grads_are_bitwise(tcfg, params, seq=16, extras=None):
    """``loss_and_grads`` with remat and without: the same loss and
    gradients, bit for bit; returns the loss.  ``extras(step)`` adds a
    frontend's inputs to the batch (:class:`WithExtras`)."""
    batch = shard_batch(WithExtras(SyntheticLMData(DataConfig(
        tcfg.vocab_size, seq, 2, lag=1)), extras).batch_at(3), "cpu")
    l1, _, g1 = loss_and_grads(params, tcfg, batch, remat=True)
    l0, _, g0 = loss_and_grads(params, tcfg, batch, remat=False)
    assert torch.equal(l1, l0)
    flat0 = _flat(g0)
    assert sorted(flat0) == sorted(_flat(g1))
    for k, v in _flat(g1).items():
        np.testing.assert_array_equal(v, flat0[k], err_msg=k)
    return l0, batch


def test_loss_and_grads_without_remat_match_remat():
    _, tcfg = _configs("float32")
    params = lm_params_from_numpy(_np_tree(jinit(jax.random.PRNGKey(1),
                                                 dataclasses.replace(
                                                     jget(ARCH),
                                                     activation_dtype=
                                                     "float32"))),
                                  tcfg, device="cpu")
    l0, batch = remat_grads_are_bitwise(tcfg, params)
    ev = make_eval_step(tcfg)(params, batch)
    assert ev["loss"].item() == pytest.approx(l0.item(), rel=1e-6)


# ------------------------------------------------------- donated step
def _port_start(arch, seed=0):
    """A smoke config's port params (f32) and AdamW state after one
    step, and its data."""
    cfg = tget(arch)
    params = TP.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    data = SyntheticLMData(DataConfig(cfg.vocab_size, S, B, seed=seed,
                                      lag=1))
    step = make_train_step(cfg, learning_rate=LR)
    params, state, _ = step(params, TO.adamw_init(params),
                            shard_batch(data.batch_at(0), "cpu"))
    return cfg, params, state, data


def _copy(params, state):
    clone = lambda t: t.clone()
    return (TO.tree_map(clone, params),
            TO.AdamWState(clone(state.step), TO.tree_map(clone, state.mu),
                          TO.tree_map(clone, state.nu)))


def _bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        np.testing.assert_array_equal(v, fb[k], err_msg=k)


@pytest.mark.parametrize("arch", [ARCH, "mixtral_8x22b"])
def test_donated_step_is_bitwise_the_functional_one(arch, monkeypatch):
    """A step of ``make_train_step`` against the functional step from the
    same state (moments nonzero, after one step): ``loss_and_grads``,
    ``clip_by_global_norm`` and ``adamw_update`` on clones.  The same
    metrics, parameters and moments, bit for bit, written into the
    tensors given (same storage).  The slice threshold is set below one
    expert's weights, so that each expert leaf is updated in runs of its
    rows."""
    cfg, params, state, data = _port_start(arch)
    limit = 12000
    monkeypatch.setattr(TO, "DONATE_SLICE_ELEMENTS", limit)
    if cfg.moe is not None:
        w_gate = params["blocks"]["mlp"]["w_gate"]      # (L, E, d, f)
        chunks = list(TO._chunks(tuple(w_gate.shape), limit))
        assert w_gate[0, 0].numel() > limit
        assert all(len(c) == 3 for c in chunks) and len(chunks) > (
            w_gate.shape[0] * w_gate.shape[1])
    fp, fs = _copy(params, state)
    leaves = lambda: [params, state.mu, state.nu, state.step]
    ptrs = [t.data_ptr() for t in TO.tree_leaves(leaves())]
    batch = shard_batch(data.batch_at(1), "cpu")
    loss, acc, grads = loss_and_grads(fp, cfg, batch, remat=True)
    grads, gnorm = TO.clip_by_global_norm(grads, 1.0)
    lr = torch.tensor(LR, dtype=torch.float32)
    fp, fs = TO.adamw_update(grads, fs, fp, lr, weight_decay=0.1)
    fm = {"loss": loss, "accuracy": acc, "grad_norm": gnorm, "lr": lr}
    dp, ds, dm = make_train_step(cfg, learning_rate=LR)(params, state,
                                                        batch)
    assert dp is params and ds.mu is state.mu and ds.nu is state.nu
    assert ds.step is state.step and int(state.step) == int(fs.step) == 2
    assert sorted(dm) == sorted(fm)
    for name in fm:
        assert torch.equal(dm[name], fm[name]), name
    _bitwise(params, fp)
    _bitwise(state.mu, fs.mu)
    _bitwise(state.nu, fs.nu)
    assert [t.data_ptr() for t in TO.tree_leaves(leaves())] == ptrs


def _failing_upd(monkeypatch, fail_on_call):
    """Make the update's per-slice arithmetic raise once, on its
    ``fail_on_call``-th call (1-based)."""
    upd, calls = TO._upd, []

    def failing(*args):
        calls.append(1)
        if len(calls) == fail_on_call:
            raise RuntimeError("injected failure")
        return upd(*args)

    monkeypatch.setattr(TO, "_upd", failing)
    return calls


def _loop(tmp_path, steps):
    ckpt = TC.CheckpointManager(tmp_path, async_save=False)
    return RestartableLoop(ckpt, LoopConfig(
        total_steps=steps, checkpoint_every=0, max_step_retries=2,
        log_every=0), log=lambda s: None)


def test_donated_step_half_written_is_not_retried(tmp_path, monkeypatch):
    """A failure after the step's first write marks the state: the
    loop's retries on it raise ``DonatedStateError``, and so does any
    later step on it."""
    cfg, params, state, data = _port_start(ARCH)
    donated = make_train_step(cfg, learning_rate=LR)

    def one_step(st, step):
        p, o, _ = donated(st["params"], st["opt"],
                          shard_batch(data.batch_at(step), "cpu"))
        return {"params": p, "opt": o}

    _failing_upd(monkeypatch, fail_on_call=2)
    with pytest.raises(TO.DonatedStateError, match="donated"):
        _loop(tmp_path, 2).run({"params": params, "opt": state}, one_step,
                               start_step=1)
    with pytest.raises(TO.DonatedStateError):
        donated(params, state, shard_batch(data.batch_at(1), "cpu"))


@pytest.mark.parametrize("where", ["update", "forward"])
def test_donated_step_failing_before_its_first_write_retries(
        where, tmp_path, monkeypatch):
    """A failure before the first write (in the forward, or the first
    slice's arithmetic) leaves the state as it was: the loop's retry
    gives the values of a run that never failed, bit for bit."""
    cfg, params, state, data = _port_start(ARCH)
    clean_p, clean_s = _copy(params, state)
    donated = make_train_step(cfg, learning_rate=LR)

    def one_step(st, step):
        p, o, _ = donated(st["params"], st["opt"],
                          shard_batch(data.batch_at(step), "cpu"))
        return {"params": p, "opt": o}

    clean = _loop(tmp_path / "clean", 2).run(
        {"params": clean_p, "opt": clean_s}, one_step, start_step=1)
    if where == "update":
        calls = _failing_upd(monkeypatch, fail_on_call=1)
    else:
        forward, calls = TS.lm_forward, []

        def failing(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected failure")
            return forward(*args, **kwargs)

        monkeypatch.setattr(TS, "lm_forward", failing)
    out = _loop(tmp_path / "retried", 2).run(
        {"params": params, "opt": state}, one_step, start_step=1)
    assert len(calls) > 1
    assert not getattr(out["opt"].step, "donated", False)
    assert int(out["opt"].step) == int(clean["opt"].step) == 2
    _bitwise(out["params"], clean["params"])
    _bitwise(out["opt"].mu, clean["opt"].mu)


def test_launch_train_smoke_loss_falls(tmp_path, capsys):
    """``launch/train.py --smoke`` (the donated step in the restartable
    loop) trains the dense smoke config: the loss falls."""
    losses = launch_train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "8",
        "--batch", "4", "--seq", "32", "--lr", "3e-3", "--warmup", "2",
        "--ckpt-dir", str(tmp_path), "--log-every", "0"])
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert "final loss" in capsys.readouterr().out
    assert TC.CheckpointManager(tmp_path).latest_step() == 7


# ------------------------------------------------------------- checkpoint
def _jax_state(dtype):
    jcfg, tcfg = _configs(dtype)
    jstep = jax.jit(jmake_train_step(jcfg, learning_rate=LR, remat=True))
    jp, js, data = _start(jcfg, jstep, seed=4)
    return jcfg, tcfg, jstep, jp, js, data


def test_port_restores_a_jax_checkpoint_and_steps_alike(tmp_path):
    jcfg, tcfg, jstep, jp, js, data = _jax_state("float32")
    JC.CheckpointManager(tmp_path, async_save=False).save(
        7, {"params": jp, "opt": js})
    template = {"params": lm_params_from_numpy(
        jax.tree_util.tree_map(np.zeros_like, _np_tree(jp)), tcfg,
        device="cpu"), "opt": TO.adamw_init(lm_params_from_numpy(
            _np_tree(jp), tcfg, device="cpu"))}
    ckpt = TC.CheckpointManager(tmp_path)
    assert ckpt.latest_step() == 7
    got = ckpt.restore(7, template)
    assert isinstance(got["opt"], TO.AdamWState)
    assert got["opt"].step.shape == () and got["opt"].step.dtype == torch.int32
    assert int(got["opt"].step) == int(js.step) == 1
    for mine, ref in ((got["params"], jp), (got["opt"].mu, js.mu),
                      (got["opt"].nu, js.nu)):
        want = _flat(_np_tree(ref))
        for k, v in _flat(mine).items():
            np.testing.assert_array_equal(v, want[k])
    batch = data.batch_at(5)
    _, _, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tcfg, learning_rate=LR, remat=True)
    _, _, tm = tstep(got["params"], got["opt"], shard_batch(batch, "cpu"))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)


def test_jax_restores_a_port_checkpoint(tmp_path):
    jcfg, tcfg, _, jp, js, _ = _jax_state("float32")
    tree = {"params": lm_params_from_numpy(_np_tree(jp), tcfg, device="cpu"),
            "opt": adamw_state_from_numpy(_np_tree(js), tcfg, device="cpu")}
    ckpt = TC.CheckpointManager(tmp_path, async_save=True)
    ckpt.save(3, tree)
    ckpt.wait()
    got = JC.CheckpointManager(tmp_path).restore(3, {"params": jp, "opt": js})
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        got, {"params": jp, "opt": js})


def test_checkpoint_save_is_a_snapshot_a_donated_step_cannot_reach(
        tmp_path):
    """``save`` copies every leaf to the host before it returns, so a
    donated step may write into the saved tensors while the write runs."""
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "n": {"i": torch.arange(4, dtype=torch.int32)}}
    ckpt = TC.CheckpointManager(tmp_path, async_save=True)
    ckpt.save(1, tree)
    tree["w"].mul_(-1)
    tree["n"]["i"].add_(7)
    ckpt.wait()
    out = ckpt.restore(1, tree)
    assert torch.equal(out["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(out["n"]["i"], torch.arange(4, dtype=torch.int32))


def test_checkpoint_gc_and_uncommitted(tmp_path):
    ckpt = TC.CheckpointManager(tmp_path, keep_last_k=2, async_save=False)
    tree = {"w": torch.ones(3), "n": {"i": torch.arange(4, dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [3, 4]
    out = ckpt.restore(4, tree)
    assert torch.equal(out["n"]["i"], tree["n"]["i"])
    (tmp_path / "step_00000004.COMMITTED").unlink()
    assert ckpt.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore(4, tree)


# --------------------------------------------------------- fault tolerance
def test_step_timer_flags_stragglers():
    t = StepTimer(ema_alpha=0.5, outlier_factor=2.0)
    for i in range(5):
        assert not t.record(i, 0.1)
    assert t.record(5, 0.5)
    assert t.outliers == [5]
    assert t.summary()["outliers"] == 1


def test_restartable_loop_retries_and_resumes(tmp_path):
    ckpt = TC.CheckpointManager(tmp_path, async_save=False)
    cfg = LoopConfig(total_steps=7, checkpoint_every=2, max_step_retries=2,
                     log_every=0)
    loop = RestartableLoop(ckpt, cfg, log=lambda s: None)
    fails = {"n": 0}

    def step_fn(state, step):
        if step == 3 and fails["n"] < 1:
            fails["n"] += 1
            raise RuntimeError("transient")
        return {"w": state["w"] + 1.0}

    out = loop.run({"w": torch.zeros(2)}, step_fn)
    assert float(out["w"][0]) == 7.0
    assert fails["n"] == 1
    loop2 = RestartableLoop(ckpt, cfg, log=lambda s: None)
    assert loop2.resume_step() == 7
    assert float(loop2.restore({"w": torch.zeros(2)})["w"][0]) == 7.0


def test_restartable_loop_raises_after_retries(tmp_path):
    ckpt = TC.CheckpointManager(tmp_path, async_save=False)
    cfg = LoopConfig(total_steps=3, checkpoint_every=0, max_step_retries=1,
                     log_every=0)
    loop = RestartableLoop(ckpt, cfg, log=lambda s: None)

    def bad(state, step):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        loop.run({"w": torch.zeros(1)}, bad)
