"""The port's MoE family (Mixtral-8x22B, DBRX-132B) against the JAX
package's, on the CPU.

The same numpy inputs (made from a seed) go through
``repro.models.moe.moe_mlp`` and the reference's routing lines, and through
``repro_torch.models.moe``'s ``route``, ``assign``, ``dispatch``,
``experts`` and ``combine``; then the smoke models of both configs, with
JAX's ``init_params`` carried across by ``convert.lm_params_from_numpy``,
through ``lm_forward``, ``lm_prefill`` and three ``lm_decode_step``s of
both packages (Mixtral's 40-token prompt overruns its 32-token window, so
its prefill fills the ring past the window and each decode step wraps it),
and through the port's ``ServingEngine`` against a greedy JAX loop.

Routing is discrete.  In f32 every route of every layer and step equals
JAX's bitwise (recorded from the reference's ``jax.lax.top_k`` through a
debug callback).  In bf16 the two packages round differently, and a
near-tie between two experts can flip, moving that token's hidden state
by O(1): the bf16 model checks force the port onto JAX's routes (the
weights recomputed from the port's own probabilities at those experts),
the replay ``chip_smoke.py`` runs on the card.

Tolerances: f32 rtol = atol = 1e-5 for layer outputs, rtol 1e-4 and atol
1e-4 · max|logit| for logits (``tests/test_torch_lm.py``: f32 matmuls
summed in another order); bf16 0.05 · max(max|ref|, 1), the tolerance
``tests/test_arch_smoke.py`` holds decode against forward to.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jfull
from repro.configs import get_smoke_config as jget
from repro.models import moe as JM
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.params import abstract_params as jabstract
from repro.models.params import init_params as jinit
from repro.models.params import param_count_actual as jcount
from repro.models.transformer import (lm_decode_step as jdecode,
                                      lm_forward as jforward,
                                      lm_prefill as jprefill)
from repro_torch.configs import get_config as tfull
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as TM
from repro_torch.models import params as TP
from repro_torch.models.config import MoEConfig
from repro_torch.models.transformer import (lm_decode_step, lm_forward,
                                            lm_prefill)
from repro_torch.serve import Request
from test_torch_lm_serving import RecordingEngine, replay_waves_in_jax
from test_torch_train import (remat_grads_are_bitwise,
                              three_train_steps_match_jax)

ARCHS = ("mixtral_8x22b", "dbrx_132b")
B, S, CACHE, STEPS = 2, 40, 48, 3


def _configs(arch, dtype, **over):
    over = dict(over, activation_dtype=dtype)
    return (dataclasses.replace(jget(arch), **over),
            dataclasses.replace(tget(arch), **over))


def _params(jcfg, tcfg, seed):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    return (jax.tree_util.tree_map(jnp.asarray, tree), tree,
            lm_params_from_numpy(tree, tcfg, device="cpu"))


def _close(out, ref, dtype, what, logits=False):
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        tol = (dict(rtol=1e-4, atol=1e-4 * scale) if logits
               else dict(rtol=1e-5, atol=1e-5))
        np.testing.assert_allclose(out, ref, err_msg=what, **tol)
    else:
        err = float(np.abs(out - ref).max())
        assert err < 0.05 * max(scale, 1.0), (what, err, scale)


def _jax_routing(p, x, cfg):
    """The reference's routing lines (``repro/models/moe.py:37-48``):
    (top_w, top_i, slot, ok)."""
    moe = cfg.moe
    b, s, _ = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = int(s * k * moe.capacity_factor / e) + 1
    logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_w, top_i = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat_e = top_i.reshape(b, s * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos, flat_e[..., None], axis=-1)[..., 0]
    ok = pos < cap
    slot = jnp.where(ok, flat_e * cap + pos, e * cap)
    return top_w, top_i, slot, ok


def _moe_case(rng, e, k, d=128, f=96, s=S, dtype="float32", shift=0.0):
    """A config with E experts of top k, its MoE weights and an input,
    as (JAX config, port config, numpy weights, numpy x)."""
    jcfg, tcfg = _configs("mixtral_8x22b", dtype, d_model=d, d_ff=f)
    jcfg = dataclasses.replace(jcfg, moe=JMoEConfig(num_experts=e, top_k=k))
    tcfg = dataclasses.replace(tcfg, moe=MoEConfig(num_experts=e, top_k=k))
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    w = {n: a.astype(np.float32) for n, a in w.items()}
    x = (rng.standard_normal((B, s, d)) + shift).astype(np.float32)
    return jcfg, tcfg, w, x


def _pair(w, x, dtype):
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    tw = {n: torch.from_numpy(a) for n, a in w.items()}
    return (jw, jnp.asarray(x, getattr(jnp, dtype)), tw,
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4)])
def test_route_and_assign_match_jax_bitwise(e, k):
    """f32: top-k ids, slots and drop masks bitwise; weights at 1e-6."""
    jcfg, tcfg, w, x = _moe_case(np.random.default_rng(e * 10 + k), e, k)
    jw, jx, tw, tx = _pair(w, x, "float32")
    top_w, top_i, slot, ok = _jax_routing(jw, jx, jcfg)
    t_w, t_i = TM.route(TM.router_probs(tw, tx), k)
    t_slot, t_ok = TM.assign(t_i, e, TM.capacity(tcfg, S))
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(top_i))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(ok))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(top_w), rtol=1e-6,
                               atol=1e-6)
    assert TM.capacity(tcfg, S) == int(S * k * 1.25 / e) + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,k", [(4, 2), (16, 4)])
def test_experts_fed_the_reference_routes_match_moe_mlp(e, k, dtype):
    """The port's assign, dispatch, experts and combine, fed the
    reference's top_i and top_w, against the reference's ``moe_mlp``."""
    jcfg, tcfg, w, x = _moe_case(np.random.default_rng(e + k), e, k,
                                 dtype=dtype)
    jw, jx, tw, tx = _pair(w, x, dtype)
    ref = JM.moe_mlp(jw, jx, jcfg)
    top_w, top_i, _, _ = _jax_routing(jw, jx, jcfg)
    t_i = torch.from_numpy(np.array(top_i)).long()
    t_w = torch.from_numpy(np.array(top_w))
    cap = TM.capacity(tcfg, S)
    slot, ok = TM.assign(t_i, e, cap)
    y = TM.experts(tw, TM.dispatch(tx, slot, k, e * cap), e, cap)
    out = TM.combine(y, slot, t_w, ok, k)
    assert out.dtype == tx.dtype
    _close(out, ref, dtype, "moe from the reference's routes")
    _close(TM.moe_mlp(tw, tx, tcfg), ref, dtype, "moe_mlp")


def test_forced_router_overflows_and_drops_the_same_assignments():
    """A router that sends every token to expert 0 first: it holds cap of
    the S assignments it gets, the rest are dropped (their tokens keep
    only their second expert's share), the same ones as the reference's."""
    e, k = 4, 2
    jcfg, tcfg, w, x = _moe_case(np.random.default_rng(1), e, k, shift=1.0)
    w["router"][:, 0] = 4.0 / np.sqrt(w["router"].shape[0])
    jw, jx, tw, tx = _pair(w, x, "float32")
    top_w, top_i, slot, ok = _jax_routing(jw, jx, jcfg)
    assert (np.asarray(top_i)[..., 0] == 0).all()
    t_w, t_i = TM.route(TM.router_probs(tw, tx), k)
    cap = TM.capacity(tcfg, S)
    t_slot, t_ok = TM.assign(t_i, e, cap)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(top_i))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(ok))
    # expert 0 keeps its first cap tokens, in token order
    first = t_ok.numpy().reshape(B, S, k)[..., 0]
    assert (first.sum(-1) == cap).all() and cap < S
    assert first[:, :cap].all() and not first[:, cap:].any()
    assert (t_slot.numpy()[~t_ok.numpy()] == e * cap).all()
    ref = JM.moe_mlp(jw, jx, jcfg)
    out = TM.moe_mlp(tw, tx, tcfg)
    _close(out, ref, "float32", "moe_mlp with drops")
    # a token whose both assignments are dropped gets exactly zero
    both = ~t_ok.numpy().reshape(B, S, k).any(-1)
    assert (out.numpy()[both] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_balance_loss_matches_jax(dtype):
    jcfg, tcfg, w, x = _moe_case(np.random.default_rng(3), 8, 2, dtype=dtype)
    jw, jx, tw, tx = _pair(w, x, dtype)
    ref = float(JM.moe_load_balance_loss(jw, jx, jcfg))
    out = TM.moe_load_balance_loss(tw, tx, tcfg)
    assert out.dtype == torch.float32 and out.shape == ()
    np.testing.assert_allclose(float(out), ref, rtol=1e-6)


@contextlib.contextmanager
def jax_routes(record):
    """Append the top-k ids of every reference ``moe_mlp`` call to
    ``record`` (in call order: each layer of each forward, prefill or
    decode step) while the block runs."""
    top_k = jax.lax.top_k

    def recording(x, k):
        w, i = top_k(x, k)
        jax.debug.callback(lambda ids: record.append(np.array(ids)), i,
                           ordered=True)
        return w, i

    jax.lax.top_k = recording
    try:
        yield
    finally:
        jax.effects_barrier()
        jax.lax.top_k = top_k


@contextlib.contextmanager
def port_routes(record, force):
    """Check (``force=False``) or force (``True``) every port ``route`` call
    against the next ids of ``record``; yields the list of each call's
    count of tokens whose experts differ from the record's."""
    route, calls, flips = TM.route, iter(record), []

    def checked(probs, k):
        w, i = route(probs, k)
        want = torch.from_numpy(next(calls)).long()
        flips.append(int((i != want).any(-1).sum()))
        if not force:
            return w, i
        w = probs.gather(-1, want)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), want

    TM.route = checked
    try:
        yield flips
    finally:
        TM.route = route
    assert next(calls, None) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_matches_jax(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jparams, _, tparams = _params(jcfg, tcfg, seed=len(arch))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    prompt = toks[:, :S]
    record = []
    with jax_routes(record):
        jfwd = jforward(jparams, jcfg, jnp.asarray(prompt))
        jlog, jcache = jprefill(jparams, jcfg, jnp.asarray(prompt),
                                cache_len=CACHE)
        jsteps = []
        for i in range(STEPS):
            lg, jcache = jdecode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, S + i:S + i + 1]),
                                 jnp.int32(S + i))
            jsteps.append((lg, jax.tree_util.tree_map(np.asarray, jcache)))
    assert len(record) == (2 + STEPS) * tcfg.num_layers

    force = dtype == "bfloat16"
    with port_routes(record, force) as flips:
        _close(lm_forward(tparams, tcfg, torch.from_numpy(prompt)), jfwd,
               dtype, "lm_forward", logits=True)
        tlog, tcache = lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                                  cache_len=CACHE)
        _close(tlog, jlog, dtype, "lm_prefill logits", logits=True)
        size = CACHE if tcfg.sliding_window is None else tcfg.sliding_window
        assert tcache["kv"]["k"].shape == (
            tcfg.num_layers, B, size, tcfg.num_kv_heads,
            tcfg.resolved_head_dim)
        for i, (lg, jc) in enumerate(jsteps):
            tlg, tcache = lm_decode_step(
                tparams, tcfg, tcache,
                torch.from_numpy(toks[:, S + i:S + i + 1]), S + i)
            assert tlg.shape == (B, 1, tcfg.vocab_size)
            _close(tlg, lg, dtype, f"decode step {i} logits", logits=True)
            for name in ("k", "v"):
                _close(tcache["kv"][name], jc["kv"][name], dtype,
                       f"decode step {i} cache {name}")
    if not force:
        assert flips == [0] * len(record)


@pytest.mark.parametrize("arch", ARCHS + ("mamba2_2_7b",))
def test_param_defs_match_jax(arch):
    """Leaf for leaf the reference's shapes and dtypes, full and smoke."""
    for jcfg, tcfg in ((jfull(arch), tfull(arch)), (jget(arch), tget(arch))):
        jtree = jabstract(jcfg)
        ttree = TP.param_shapes(tcfg)

        def same(j, t, path):
            if isinstance(t, dict):
                assert set(j) == set(t), path
                for key in t:
                    same(j[key], t[key], path + "/" + key)
            else:
                assert tuple(j.shape) == t[0], path
                assert str(j.dtype) == str(t[1]).replace("torch.", ""), path

        same(jtree, ttree, arch)
        assert TP.param_count_actual(tcfg) == jcount(jcfg)


def test_lm_params_from_numpy_takes_the_moe_tree():
    jcfg, tcfg = _configs("dbrx_132b", "float32")
    _, tree, params = _params(jcfg, tcfg, seed=2)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(params["blocks"]["mlp"][name].numpy(),
                                      tree["blocks"]["mlp"][name])
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["blocks"]["mlp"]["w_up"] = tree["blocks"]["mlp"]["w_up"][:, :-1]
    with pytest.raises(ValueError, match="w_up"):
        lm_params_from_numpy(bad, tcfg, device="cpu")
    del bad["blocks"]["mlp"]["router"]
    with pytest.raises(KeyError, match="router"):
        lm_params_from_numpy(bad, tcfg, device="cpu")


# (prompt length, max new tokens) per request; Mixtral's window is 32, so
# the longer prompts fill its ring past the window and decode wraps it
REQUESTS = [(35, 4), (20, 5), (38, 3), (12, 4), (33, 2)]
SLOTS, MAX_LEN = 2, 48


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serving_matches_a_jax_greedy_loop(arch):
    """f32: every served token equals JAX's argmax (no route can flip)."""
    jcfg, tcfg = _configs(arch, "float32")
    jparams, _, tparams = _params(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(9)
    reqs = [Request(prompt=rng.integers(0, jcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=m, id=i)
        for i, (n, m) in enumerate(REQUESTS)]
    engine = RecordingEngine(tcfg, tparams, batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    stats = engine.run(reqs)
    checked, agreed = replay_waves_in_jax(engine, reqs, jcfg, jparams,
                                          "float32", SLOTS, MAX_LEN)
    assert agreed == checked
    assert stats.tokens_out == sum(m for _, m in REQUESTS)


def test_launch_serve_runs_moe_and_training_raises(capsys, tmp_path):
    """The serving CLI serves the smoke MoE; the training CLI trains it
    (training raised before its port)."""
    stats = launch_serve.main(["--arch", "mixtral-8x22b", "--smoke",
                               "--device", "cpu", "--requests", "3",
                               "--prompt-len", "36", "--new-tokens", "3",
                               "--slots", "2", "--max-len", "48"])
    assert stats.tokens_out == 9
    assert "done: 3/3 requests, 9 tokens" in capsys.readouterr().out
    losses = launch_train.main(["--arch", "dbrx-132b", "--smoke", "--device",
                                "cpu", "--steps", "2", "--batch", "2",
                                "--seq", "16", "--ckpt-dir", str(tmp_path),
                                "--log-every", "0"])
    assert len(losses) == 2 and np.isfinite(losses).all()


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_steps_match_jax(arch, dtype):
    """Three train steps against JAX's jitted step, at the tolerances of
    ``tests/test_torch_train.py`` (Mixtral's 40 positions past its
    32-token window).  Each step calls the router once per layer forward
    and once per layer in remat's recompute, in reverse, in both packages;
    every port call is held to JAX's routes: bitwise in f32, forced in
    bf16 (the weights from the port's own probabilities).  In f32 at
    most 1 in 10^5 elements of a leaf may sit past 1e-3 of the summed
    learning rates, within 1e-2: Mixtral's ``w_gate[0, 0, 30, 73]``, whose
    gradient is 6.5e-7 of its leaf's largest (3.12e-8 in JAX, 2.95e-8 in
    the port: the leaf's f32 noise), lands 1.08e-3 of them apart."""
    jcfg, tcfg = _configs(arch, dtype)
    force = dtype == "bfloat16"
    record = []

    @contextlib.contextmanager
    def port():
        # JAX's first step (from init) has no port counterpart
        with port_routes(record[2 * tcfg.num_layers:], force) as flips:
            yield
        assert len(flips) == 3 * 2 * tcfg.num_layers
        if not force:
            assert flips == [0] * len(flips)

    three_train_steps_match_jax(jcfg, tcfg, dtype, seed=len(arch), seq=S,
                                jax_ctx=lambda: jax_routes(record),
                                port_ctx=port, outliers=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_remat_gradients_are_bitwise(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    remat_grads_are_bitwise(tcfg, _params(jcfg, tcfg, seed=2)[2], seq=S)


def test_moe_gradients_with_drops_match_jax():
    """f32 gradients of ``moe_mlp`` with respect to x and every weight,
    under the overflowing router of
    ``test_forced_router_overflows_and_drops_the_same_assignments``,
    against ``jax.vjp`` of the reference's, to rtol 1e-5 and atol 1e-5 of
    each gradient's largest element.  ``dispatch`` writes every
    dropped assignment into the one sink slot; ``experts`` never reads
    it and ``combine`` weights it by 0, so the sink's output and its
    gradient are zero and a dropped assignment sends its token no
    gradient."""
    e, k = 4, 2
    jcfg, tcfg, w, x = _moe_case(np.random.default_rng(1), e, k, shift=1.0)
    w["router"][:, 0] = 4.0 / np.sqrt(w["router"].shape[0])
    jw, jx, tw, tx = _pair(w, x, "float32")
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: JM.moe_mlp(p, x, jcfg), jw, jx)
    jgw, jgx = vjp(jnp.asarray(g))
    tw = {n: t.requires_grad_() for n, t in tw.items()}
    tx.requires_grad_()
    cap = TM.capacity(tcfg, S)
    top_w, top_i = TM.route(TM.router_probs(tw, tx), k)
    slot, ok = TM.assign(top_i, e, cap)
    assert (~ok).any() and (slot[~ok] == e * cap).all()
    buf = TM.dispatch(tx, slot, k, e * cap)
    buf.retain_grad()
    y = TM.experts(tw, buf, e, cap)
    assert (y[-1] == 0).all()
    out = TM.combine(y, slot, top_w, ok, k)
    out.backward(torch.from_numpy(g))
    assert (buf.grad[-1] == 0).all()
    # sums over up to B·cap products in another order: atol 1e-5 of the
    # gradient's largest element
    for what, got, ref in [("dx", tx.grad, jgx)] + [
            (f"d{n}", tw[n].grad, jgw[n]) for n in w]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=what)
