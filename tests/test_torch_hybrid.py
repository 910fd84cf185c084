"""The port's hybrid family (Zamba2-7B) against the JAX package's, on the
CPU.

A Mamba2 backbone with one shared attention + MLP block applied after
every ``hybrid_period``-th layer: the smoke config's 5 layers at period 2
are two applications of the one weight set and a tail of one layer.  The
same numpy inputs (made from a seed) go through the reference's
``transformer._shared_block_full`` and ``_hybrid_full`` and the port's
counterparts; then the smoke model, with JAX's ``init_params`` (the SSM's
and the shared block's constant leaves redrawn, so that they are
exercised) carried across by ``convert.lm_params_from_numpy``, through
``lm_forward``, ``lm_prefill`` (logits and every cache leaf: each layer's
conv and state, each application's K and V) and several
``lm_decode_step``s of both packages, and through the port's
``ServingEngine`` against a greedy JAX loop.

Tolerances: f32 rtol = atol = 1e-5 for layer outputs and caches, rtol
1e-4 and atol 1e-4 · max|logit| for logits (``tests/test_torch_lm.py``,
``tests/test_torch_mamba2.py``); bf16 0.05 · max(max|ref|, 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jfull
from repro.configs import get_smoke_config as jget
from repro.models import transformer as JT
from repro.models.params import abstract_params as jabstract
from repro.models.params import init_params as jinit
from repro.models.params import param_count_actual as jcount
from repro_torch.configs import get_config as tfull
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as TA
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serve import Request
from test_torch_lm_serving import RecordingEngine, replay_waves_in_jax
from test_torch_train import (remat_grads_are_bitwise,
                              three_train_steps_match_jax)

ARCH = "zamba2_7b"
B, S, CACHE, STEPS = 2, 40, 64, 4


def _configs(dtype):
    return (dataclasses.replace(jget(ARCH), activation_dtype=dtype),
            dataclasses.replace(tget(ARCH), activation_dtype=dtype))


def _params(jcfg, tcfg, seed):
    """JAX's init tree with the SSM's and the shared block's constant
    leaves redrawn, and the port's copy."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    ssm = tree["blocks"]["ssm"]
    draw = {"conv_b": (0.0, 0.1), "a_log": (0.0, 0.5), "d_skip": (1.0, 0.2),
            "dt_bias": (-1.0, 0.5), "norm": (1.0, 0.1)}
    for name, (mean, std) in draw.items():
        ssm[name] = (mean + std * rng.standard_normal(ssm[name].shape)
                     ).astype(np.float32)
    for name in ("norm0", "norm1"):
        shared = tree["shared"]
        shared[name] = (1 + 0.1 * rng.standard_normal(shared[name].shape)
                        ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_numpy(tree, tcfg, device="cpu"))


def _close(out, ref, dtype, what, logits=False):
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        tol = (dict(rtol=1e-4, atol=1e-4 * scale) if logits
               else dict(rtol=1e-5, atol=1e-5))
        np.testing.assert_allclose(out, ref, err_msg=what, **tol)
    else:
        err = float(np.abs(out - ref).max())
        assert err < 0.05 * max(scale, 1.0), (what, err, scale)


def _x(rng, s, d, dtype):
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_matches_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    jx, tx = _x(np.random.default_rng(2), S, tcfg.d_model, dtype)
    out = TT._shared_block_full(tparams["shared"], tx, tcfg)
    assert out.dtype == tx.dtype
    _close(out, JT._shared_block_full(jparams["shared"], jx, jcfg), dtype,
           "shared block")


class _Counted:
    """Counts the calls of one function of a module while it is patched."""

    def __init__(self, monkeypatch, module, name):
        self.calls, fn = 0, getattr(module, name)

        def call(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, call)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_grouping_matches_jax(dtype, monkeypatch):
    """5 layers at period 2: the shared block after layers 2 and 4 (two
    applications of the one weight set), layer 5 the tail; the embedded
    stack against the reference's ``_hybrid_full``."""
    jcfg, tcfg = _configs(dtype)
    assert (tcfg.num_layers, tcfg.hybrid_period) == (5, 2)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ref = JT._hybrid_full(jparams, jcfg, JT._embed(jparams, jcfg,
                                                   jnp.asarray(toks), None),
                          remat=False)
    shared = _Counted(monkeypatch, TT, "_shared_block_full")
    ssm = _Counted(monkeypatch, TT, "_ssm_block_full")
    x = TT._embed(tparams, tcfg, torch.from_numpy(toks))
    for l, lp in enumerate(TT._layers(tparams, tcfg)):
        x = TT._ssm_block_full(lp, x, tcfg)
        if TT._shared_after(tcfg, l):
            x = TT._shared_block_full(tparams["shared"], x, tcfg)
    assert (ssm.calls, shared.calls) == (5, 2)
    _close(x, ref, dtype, "hybrid stack")
    # lm_forward applies the shared block as often
    TT.lm_forward(tparams, tcfg, torch.from_numpy(toks))
    assert (ssm.calls, shared.calls) == (10, 4)
    assert [l for l in range(tcfg.num_layers)
            if TT._shared_after(tcfg, l)] == [1, 3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_lm_matches_jax(dtype, monkeypatch):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=5)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    prompt = toks[:, :S]
    _close(TT.lm_forward(tparams, tcfg, torch.from_numpy(toks)),
           JT.lm_forward(jparams, jcfg, jnp.asarray(toks)), dtype,
           "lm_forward", logits=True)
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(prompt),
                                 cache_len=CACHE)
    tlog, tcache = TT.lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                                 cache_len=CACHE)
    _close(tlog, jlog, dtype, "lm_prefill logits", logits=True)
    zero = TT.init_cache(tcfg, B, CACHE, dtype=getattr(torch, dtype))
    assert set(tcache) == set(zero) == {"ssm", "attn"}

    def leaves(c):
        return [(f"{k}/{n}", c[k][n]) for k in ("ssm", "attn")
                for n in sorted(c[k])]

    for (name, t), (_, z) in zip(leaves(tcache), leaves(zero)):
        assert t.shape == z.shape and t.dtype == z.dtype
    # the SSM's state in f32, each application's K/V in the activations'
    assert zero["attn"]["k"].shape == (2, B, CACHE, tcfg.num_kv_heads,
                                       tcfg.resolved_head_dim)
    assert tcache["ssm"]["ssm"].dtype == torch.float32
    assert tcache["attn"]["k"].dtype == getattr(torch, dtype)
    for name, t in leaves(tcache):
        k, n = name.split("/")
        _close(t, jcache[k][n], dtype, f"prefill {name}")
    decodes = _Counted(monkeypatch, TA, "gqa_decode")
    for i in range(STEPS):
        step = toks[:, S + i:S + i + 1]
        jlog, jcache = JT.lm_decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(step), jnp.int32(S + i))
        k_cache = tcache["attn"]["k"]
        tlog, tcache = TT.lm_decode_step(tparams, tcfg, tcache,
                                         torch.from_numpy(step), S + i)
        assert tcache["attn"]["k"] is k_cache  # updated in place
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        _close(tlog, jlog, dtype, f"decode step {i} logits", logits=True)
        for name, t in leaves(tcache):
            k, n = name.split("/")
            _close(t, jcache[k][n], dtype, f"decode step {i} {name}")
    assert decodes.calls == 2 * STEPS


REQUESTS = [(9, 5), (30, 3), (6, 6), (25, 6), (7, 4)]
SLOTS, MAX_LEN = 2, 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_serving_matches_a_jax_greedy_loop(dtype):
    """Left-padded waves, every token against JAX's greedy loop on the
    port's own tokens: equal to JAX's argmax in f32; the engine keeps the
    f32 leaves the reference reads in f32."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=7)
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, jcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=m, id=i)
        for i, (n, m) in enumerate(REQUESTS)]
    engine = RecordingEngine(tcfg, tparams, batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    assert engine.params["blocks"]["ssm"]["a_log"].dtype == torch.float32
    assert engine.params["shared"]["attn"]["wq"].dtype == getattr(torch,
                                                                  dtype)
    stats = engine.run(reqs)
    checked, agreed = replay_waves_in_jax(engine, reqs, jcfg, jparams, dtype,
                                          SLOTS, MAX_LEN)
    if dtype == "float32":
        assert agreed == checked
    assert stats.tokens_out == sum(m for _, m in REQUESTS)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_hybrid_param_defs_match_jax(which):
    """Leaf for leaf the reference's shapes and dtypes, the shared block
    unstacked."""
    jcfg, tcfg = (jfull(ARCH), tfull(ARCH)) if which == "full" else (
        jget(ARCH), tget(ARCH))
    jtree, ttree = jabstract(jcfg), TP.param_shapes(tcfg)

    def same(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            for key in t:
                same(j[key], t[key], path + "/" + key)
        else:
            assert tuple(j.shape) == t[0], path
            assert str(j.dtype) == str(t[1]).replace("torch.", ""), path

    same(jtree, ttree, ARCH)
    assert TP.param_count_actual(tcfg) == jcount(jcfg)
    d = tcfg.d_model
    assert ttree["shared"]["attn"]["wq"][0] == (d, d)
    assert ttree["shared"]["norm0"][0] == (d,)
    if which == "full":
        assert TP.param_count_actual(tcfg) == 6_751_130_832


def test_launch_serve_runs_the_hybrid_and_training_raises(capsys, tmp_path):
    """The serving CLI serves the smoke hybrid; the training CLI trains it
    (training raised before its port)."""
    stats = launch_serve.main(["--arch", "zamba2-7b", "--smoke",
                               "--device", "cpu", "--requests", "3",
                               "--prompt-len", "20", "--new-tokens", "3",
                               "--slots", "2", "--max-len", "32"])
    assert stats.tokens_out == 9
    assert "done: 3/3 requests, 9 tokens" in capsys.readouterr().out
    losses = launch_train.main(["--arch", "zamba2-7b", "--smoke", "--device",
                                "cpu", "--steps", "2", "--batch", "2",
                                "--seq", "24", "--ckpt-dir", str(tmp_path),
                                "--log-every", "0"])
    assert len(losses) == 2 and np.isfinite(losses).all()


# ------------------------------------------------------------- training
def _tree(jcfg, tcfg, seed):
    return jax.tree_util.tree_map(np.asarray, _params(jcfg, tcfg, seed)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_train_steps_match_jax(dtype):
    """Three train steps against JAX's jitted step, at the tolerances of
    ``tests/test_torch_train.py``: autograd through the SSM stack and the
    shared block's two applications (its gradient the sum over both),
    each under remat, over 40 positions (two SSM chunks of 32, the second
    padded)."""
    jcfg, tcfg = _configs(dtype)
    three_train_steps_match_jax(jcfg, tcfg, dtype, tree=_tree(jcfg, tcfg, 7),
                                seed=7, seq=40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_remat_gradients_are_bitwise(dtype, monkeypatch):
    """Remat and no remat give the same gradients, bit for bit; the shared
    block runs once per application forward and once more per application
    in remat's recompute."""
    jcfg, tcfg = _configs(dtype)
    shared = _Counted(monkeypatch, TT, "_shared_block_full")
    remat_grads_are_bitwise(tcfg, _params(jcfg, tcfg, seed=8)[1], seq=40)
    # remat: 2 applications + 2 recomputed; then 2 without remat
    assert shared.calls == 6
