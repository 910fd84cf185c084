"""The port's SSM family (Mamba2-2.7B) against the JAX package's, on the
CPU.

The same numpy inputs (made from a seed) go through
``repro.models.mamba2`` (``_segsum``, ``mamba2_full``, ``mamba2_decode``)
and the reference's ``transformer._mamba_final_state``, and through the
port's counterparts; then the smoke model, with JAX's ``init_params``
(the SSM's zero and one leaves redrawn, so that conv bias, dt bias, A and
D are exercised) carried across by ``convert.lm_params_from_numpy``,
through ``lm_forward``, ``lm_prefill`` and several ``lm_decode_step``s of
both packages, and through the port's ``ServingEngine`` against a greedy
JAX loop.  The port contracts the reference's multi-operand einsums
pairwise in a fixed order, so its f32 sums differ in order.

Tolerances: f32 rtol = atol = 1e-5 for layer outputs and states (the
scan's products are f32 in both), rtol 1e-4 and atol 1e-4 · max|logit|
for logits (``tests/test_torch_lm.py``); bf16 0.05 · max(max|ref|, 1).
``softplus`` differs between the libraries only past their thresholds
(jax's is exact, torch's returns x above 20), where the two agree to f32
rounding; the dt inputs here stay far below 20.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.models import mamba2 as JM2
from repro.models.params import init_params as jinit
from repro.models.transformer import (_mamba_final_state as jfinal,
                                      lm_decode_step as jdecode,
                                      lm_forward as jforward,
                                      lm_prefill as jprefill)
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2 as TM2
from repro_torch.models.transformer import (_mamba_final_state, init_cache,
                                            lm_decode_step, lm_forward,
                                            lm_prefill)
from repro_torch.serve import Request
from test_torch_lm_serving import RecordingEngine, replay_waves_in_jax
from test_torch_train import (remat_grads_are_bitwise,
                              three_train_steps_match_jax)

ARCH = "mamba2_2_7b"
B = 2


def _configs(dtype, **over):
    over = dict(over, activation_dtype=dtype)
    return (dataclasses.replace(jget(ARCH), **over),
            dataclasses.replace(tget(ARCH), **over))


def _tree(jcfg, seed):
    """JAX's init tree with the SSM's constant leaves redrawn."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    ssm = tree["blocks"]["ssm"]
    draw = {"conv_b": (0.0, 0.1), "a_log": (0.0, 0.5), "d_skip": (1.0, 0.2),
            "dt_bias": (-1.0, 0.5), "norm": (1.0, 0.1)}
    for name, (mean, std) in draw.items():
        ssm[name] = (mean + std * rng.standard_normal(ssm[name].shape)
                     ).astype(np.float32)
    return tree


def _params(jcfg, tcfg, seed):
    tree = _tree(jcfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_numpy(tree, tcfg, device="cpu"))


def _layer(jparams, tparams, l=0):
    return ({k: v[l] for k, v in jparams["blocks"]["ssm"].items()},
            {k: v[l] for k, v in tparams["blocks"]["ssm"].items()})


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


def _x(rng, s, d, dtype):
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 16)).astype(
        np.float32)
    ref = np.asarray(JM2._segsum(jnp.asarray(x)))
    out = TM2._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(out), np.isneginf(ref))
    assert np.isneginf(out[..., 0, 1]).all() and not np.isinf(
        np.diagonal(out, axis1=-2, axis2=-1)).any()
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 45, 20])
def test_mamba2_full_matches_jax(s, dtype):
    """S a chunk multiple (two chunks of 32), one chunk and a ragged
    tail, and shorter than a chunk."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    jp, tp = _layer(jparams, tparams, 1)
    jx, tx = _x(np.random.default_rng(s), s, tcfg.d_model, dtype)
    ref = JM2.mamba2_full(jp, jx, jcfg)
    out = TM2.mamba2_full(tp, tx, tcfg)
    assert out.dtype == tx.dtype
    _close(out, ref, dtype, "mamba2_full")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_state_and_decode_match_jax(dtype):
    """The state after 45 positions, then five recurrent steps from it."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=2)
    jp, tp = _layer(jparams, tparams, 2)
    rng = np.random.default_rng(3)
    jx, tx = _x(rng, 45, tcfg.d_model, dtype)
    jst = jfinal(jp, jx, jcfg)
    tst = _mamba_final_state(tp, tx, tcfg)
    for name in ("conv", "ssm"):
        assert tst[name].dtype == torch.float32
        _close(tst[name], jst[name], dtype, f"final state {name}")
    for i in range(5):
        jx, tx = _x(rng, 1, tcfg.d_model, dtype)
        ref, jst = JM2.mamba2_decode(jp, jx, jst, jcfg)
        out, tst = TM2.mamba2_decode(tp, tx, tst, tcfg)
        _close(out, ref, dtype, f"decode step {i}")
        for name in ("conv", "ssm"):
            _close(tst[name], jst[name], dtype, f"decode step {i} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_state_holds_no_view_of_the_sequence(dtype):
    """The cached conv tail is a copy: a view would keep each layer's whole
    (B, S, conv_dim) input alive until the prefill stacks its caches."""
    _, tcfg = _configs(dtype)
    _, tparams = _params(*_configs(dtype), seed=4)
    tp = {k: v[0] for k, v in tparams["blocks"]["ssm"].items()}
    _, tx = _x(np.random.default_rng(5), 45, tcfg.d_model, dtype)
    for name, t in _mamba_final_state(tp, tx, tcfg).items():
        assert t.dtype == torch.float32, name
        assert t.untyped_storage().nbytes() == t.numel() * 4, name


def test_decode_continues_the_chunked_scan():
    """The port alone: prefill of S tokens and one decode step give the
    last logits of a prefill of S + 1 (the check ``chip_smoke.py`` makes
    at full width), for S across a chunk boundary."""
    _, tcfg = _configs("float32")
    _, tparams = _params(*_configs("float32"), seed=5)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (B, 71)).astype(np.int32))
    full, _ = lm_prefill(tparams, tcfg, toks, cache_len=0)
    _, cache = lm_prefill(tparams, tcfg, toks[:, :70], cache_len=0)
    step, _ = lm_decode_step(tparams, tcfg, cache, toks[:, 70:], 70)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_lm_matches_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=7)
    s, steps = 40, 4
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, s + steps)).astype(np.int32)
    prompt = toks[:, :s]
    _close(lm_forward(tparams, tcfg, torch.from_numpy(prompt)),
           jforward(jparams, jcfg, jnp.asarray(prompt)), dtype,
           "lm_forward", logits=True)
    jlog, jcache = jprefill(jparams, jcfg, jnp.asarray(prompt), cache_len=64)
    tlog, tcache = lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                              cache_len=64)
    _close(tlog, jlog, dtype, "lm_prefill logits", logits=True)
    zero = init_cache(tcfg, B, 64)["ssm"]
    for name in ("conv", "ssm"):
        assert tcache["ssm"][name].shape == zero[name].shape
        assert tcache["ssm"][name].dtype == zero[name].dtype == torch.float32
        _close(tcache["ssm"][name], jcache["ssm"][name], dtype,
               f"prefill {name}")
    for i in range(steps):
        step = toks[:, s + i:s + i + 1]
        jlog, jcache = jdecode(jparams, jcfg, jcache, jnp.asarray(step),
                               jnp.int32(s + i))
        conv = tcache["ssm"]["conv"]
        tlog, tcache = lm_decode_step(tparams, tcfg, tcache,
                                      torch.from_numpy(step), s + i)
        assert tcache["ssm"]["conv"] is conv  # updated in place
        _close(tlog, jlog, dtype, f"decode step {i} logits", logits=True)
        for name in ("conv", "ssm"):
            _close(tcache["ssm"][name], jcache["ssm"][name], dtype,
                   f"decode step {i} {name}")


REQUESTS = [(9, 5), (40, 3), (6, 6), (33, 6), (7, 4)]
SLOTS, MAX_LEN = 2, 48


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_serving_matches_a_jax_greedy_loop(dtype):
    """Left-padded waves (the pad tokens run through the state, as in the
    reference), every token against JAX's greedy loop on the port's own
    tokens; the engine keeps the f32 leaves the reference reads in f32."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=10)
    rng = np.random.default_rng(11)
    reqs = [Request(prompt=rng.integers(0, jcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=m, id=i)
        for i, (n, m) in enumerate(REQUESTS)]
    engine = RecordingEngine(tcfg, tparams, batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    held = engine.params["blocks"]["ssm"]
    assert held["a_log"].dtype == torch.float32
    assert held["in_proj"].dtype == getattr(torch, dtype)
    stats = engine.run(reqs)
    checked, agreed = replay_waves_in_jax(engine, reqs, jcfg, jparams, dtype,
                                          SLOTS, MAX_LEN)
    if dtype == "float32":
        assert agreed == checked
    assert stats.tokens_out == sum(m for _, m in REQUESTS)


def test_launch_serve_runs_the_ssm_and_training_raises(capsys, tmp_path):
    """The serving CLI serves the smoke SSM; the training CLI trains it
    (training raised before its port)."""
    stats = launch_serve.main(["--arch", "mamba2-2.7b", "--smoke",
                               "--device", "cpu", "--requests", "3",
                               "--prompt-len", "40", "--new-tokens", "3",
                               "--slots", "2", "--max-len", "48"])
    assert stats.tokens_out == 9
    assert "done: 3/3 requests, 9 tokens" in capsys.readouterr().out
    losses = launch_train.main(["--arch", "mamba2-2.7b", "--smoke",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "40", "--ckpt-dir",
                                str(tmp_path), "--log-every", "0"])
    assert len(losses) == 2 and np.isfinite(losses).all()


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_train_steps_match_jax(dtype):
    """Three train steps against JAX's jitted step, at the tolerances of
    ``tests/test_torch_train.py``: autograd through the chunked scan
    (``_segsum``'s -inf mask, the conv, the gated output) over 40
    positions, two chunks of 32 with the second padded."""
    jcfg, tcfg = _configs(dtype)
    three_train_steps_match_jax(jcfg, tcfg, dtype, tree=_tree(jcfg, 3),
                                seed=3, seq=40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_remat_gradients_are_bitwise(dtype):
    jcfg, tcfg = _configs(dtype)
    remat_grads_are_bitwise(tcfg, _params(jcfg, tcfg, seed=4)[1], seq=40)
