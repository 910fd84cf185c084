"""The port's MLA family (MiniCPM3-4B) against the JAX package's, on the
CPU.

The same numpy inputs (made from a seed) go through the reference's
``repro.models.attention`` MLA functions (``_mla_project_q``,
``_mla_latent``, ``_mla_expand_kv``, ``mla_full``, ``mla_prefill``,
``mla_decode``) and the port's; then the smoke model (hd = qk_nope +
qk_rope = 24, vd = 16), with JAX's ``init_params`` (the two norms' scales
redrawn, so that they are exercised) carried across by
``convert.lm_params_from_numpy``, through ``lm_forward``, ``lm_prefill``
and several ``lm_decode_step``s of both packages, and through the port's
``ServingEngine`` against a greedy JAX loop.

Both packages keep the MLA cache (latent and rope key) in bf16 whatever the
activation dtype, and the naive decode expands K and V from that cache, so
an f32 model rounds its latent through bf16 in both.

Tolerances: f32 rtol = atol = 1e-5 for layer outputs, rtol 1e-4 and atol
1e-4 · max|logit| for logits (``tests/test_torch_lm.py``); bf16
0.05 · max(max|ref|, 1), caches too.  An f32 model's bf16 caches: their
f32 sources agree to 1e-5 and round to bf16 alike, but one that straddles
a rounding boundary lands one bf16 step (at most 2^-7 of its value) apart;
so such a cache is held to rtol 2^-7 with at most 1% of its elements not
bitwise equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jfull
from repro.configs import get_smoke_config as jget
from repro.models import attention as JA
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
from repro_torch.models import attention as TA
from repro_torch.models import params as TP
from repro_torch.models.transformer import (init_cache, lm_decode_step,
                                            lm_forward, lm_prefill)
from repro_torch.serve import Request
from test_torch_lm_serving import RecordingEngine, replay_waves_in_jax
from test_torch_train import (remat_grads_are_bitwise,
                              three_train_steps_match_jax)

ARCH = "minicpm3_4b"
B, S, CACHE, STEPS = 2, 24, 40, 3
BF16_STEP = 2.0 ** -7


def _configs(dtype):
    return (dataclasses.replace(jget(ARCH), activation_dtype=dtype),
            dataclasses.replace(tget(ARCH), activation_dtype=dtype))


def _params(jcfg, tcfg, seed):
    """JAX's init tree with the norms' scales redrawn, and the port's
    copy."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["attn"]
    for name in ("q_norm", "kv_norm"):
        attn[name] = (1 + 0.1 * rng.standard_normal(attn[name].shape)
                      ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_numpy(tree, tcfg, device="cpu"))


def _layer(jparams, tparams, l):
    return ({k: v[l] for k, v in jparams["blocks"]["attn"].items()},
            {k: v[l] for k, v in tparams["blocks"]["attn"].items()})


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


def _close_cache(out, ref, dtype, what):
    """A bf16 cache leaf: in a bf16 model as its activations; in an f32
    one within one bf16 step, and bitwise but for at most 1% of its
    elements."""
    assert out.dtype == torch.bfloat16, what
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "bfloat16":
        return _close(out, ref, dtype, what)
    out = out.float().numpy()
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol=BF16_STEP, atol=1e-5,
                               err_msg=what)
    assert np.mean(out != ref) <= 0.01, what


def _x(rng, s, d, dtype):
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_pieces_match_jax(dtype):
    """The q projection, the latent and rope key, the K/V expansion (of
    one latent fed to both) and the full attention."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    jp, tp = _layer(jparams, tparams, 1)
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, S, tcfg.d_model, dtype)
    for name, ref, out in (
            ("q", JA._mla_project_q(jp, jx, jcfg),
             TA._mla_project_q(tp, tx, tcfg)),
            ("latent", JA._mla_latent(jp, jx, jcfg),
             TA._mla_latent(tp, tx, tcfg))):
        for i, (r, o) in enumerate(zip(ref, out)):
            assert o.dtype == tx.dtype
            _close(o, r, dtype, f"{name}[{i}]")
    jl, tl = _x(rng, S, tcfg.mla.kv_lora_rank, dtype)
    for i, (r, o) in enumerate(zip(JA._mla_expand_kv(jp, jl, jcfg),
                                   TA._mla_expand_kv(tp, tl, tcfg))):
        _close(o, r, dtype, f"expand_kv[{i}]")
    out = TA.mla_full(tp, tx, tcfg)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, JA.mla_full(jp, jx, jcfg), dtype, "mla_full")
    _close(TA.mla_full(tp, tx, tcfg, causal=False),
           JA.mla_full(jp, jx, jcfg, causal=False), dtype,
           "mla_full, not causal")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_decode_match_jax(dtype):
    """The prefill's output and bf16 cache, then decode steps, the last
    two past the cache's end (their slot clamps to the last one, as
    ``dynamic_update_slice`` does)."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    jp, tp = _layer(jparams, tparams, 2)
    rng = np.random.default_rng(4)
    jx, tx = _x(rng, S, tcfg.d_model, dtype)
    size = S + 1
    ref, jc = JA.mla_prefill(jp, jx, jcfg, size)
    out, tc = TA.mla_prefill(tp, tx, tcfg, size)
    _close(out, ref, dtype, "mla_prefill")
    zero = TA.mla_init_cache(tcfg, B, size)
    for name in ("latent", "k_rope"):
        assert tc[name].shape == zero[name].shape
        assert tc[name].dtype == zero[name].dtype == torch.bfloat16
        _close_cache(tc[name], jc[name], dtype, f"prefill {name}")
    for i in range(STEPS):
        jx, tx = _x(rng, 1, tcfg.d_model, dtype)
        latent = tc["latent"]
        ref, jc = JA.mla_decode(jp, jx, jc, jnp.int32(S + i), jcfg)
        out, tc = TA.mla_decode(tp, tx, tc, torch.tensor(S + i,
                                                         dtype=torch.int32),
                                tcfg)
        assert tc["latent"] is latent  # updated in place
        assert out.dtype == tx.dtype
        _close(out, ref, dtype, f"decode step {i}")
        for name in ("latent", "k_rope"):
            _close_cache(tc[name], jc[name], dtype,
                         f"decode step {i} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_lm_matches_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=5)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    prompt = toks[:, :S]
    _close(lm_forward(tparams, tcfg, torch.from_numpy(toks)),
           jforward(jparams, jcfg, jnp.asarray(toks)), dtype, "lm_forward",
           logits=True)
    jlog, jcache = jprefill(jparams, jcfg, jnp.asarray(prompt),
                            cache_len=CACHE)
    tlog, tcache = lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                              cache_len=CACHE)
    _close(tlog, jlog, dtype, "lm_prefill logits", logits=True)
    zero = init_cache(tcfg, B, CACHE)
    assert set(tcache) == set(zero) == {"mla"}
    for name in ("latent", "k_rope"):
        assert tcache["mla"][name].shape == zero["mla"][name].shape
        _close_cache(tcache["mla"][name], jcache["mla"][name], dtype,
                     f"prefill {name}")
    for i in range(STEPS):
        step = toks[:, S + i:S + i + 1]
        jlog, jcache = jdecode(jparams, jcfg, jcache, jnp.asarray(step),
                               jnp.int32(S + i))
        tlog, tcache = lm_decode_step(tparams, tcfg, tcache,
                                      torch.from_numpy(step), S + i)
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        _close(tlog, jlog, dtype, f"decode step {i} logits", logits=True)
        for name in ("latent", "k_rope"):
            _close_cache(tcache["mla"][name], jcache["mla"][name], dtype,
                         f"decode step {i} {name}")


REQUESTS = [(9, 5), (20, 3), (6, 6), (17, 6), (7, 4)]
SLOTS, MAX_LEN = 2, 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_serving_matches_a_jax_greedy_loop(dtype):
    """Every served token against JAX's greedy loop on the port's own
    tokens: equal to JAX's argmax in f32."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=7)
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, jcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=m, id=i)
        for i, (n, m) in enumerate(REQUESTS)]
    engine = RecordingEngine(tcfg, tparams, batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    stats = engine.run(reqs)
    checked, agreed = replay_waves_in_jax(engine, reqs, jcfg, jparams, dtype,
                                          SLOTS, MAX_LEN)
    if dtype == "float32":
        assert agreed == checked
    assert stats.tokens_out == sum(m for _, m in REQUESTS)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_mla_param_defs_match_jax(which):
    """Leaf for leaf the reference's shapes and dtypes; the attention's
    dims are the MLA ranks, never ``resolved_head_dim``."""
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
    if which == "full":
        assert TP.param_count_actual(tcfg) == 4_261_902_848
        m = tcfg.mla
        assert ttree["blocks"]["attn"]["q_b"][0] == (
            62, 768, 40 * (m.qk_nope_head_dim + m.qk_rope_head_dim))


def test_launch_serve_runs_mla_and_training_raises(capsys, tmp_path):
    """The serving CLI serves the smoke MLA model; the training CLI trains
    it (training raised before its port)."""
    stats = launch_serve.main(["--arch", "minicpm3-4b", "--smoke",
                               "--device", "cpu", "--requests", "3",
                               "--prompt-len", "12", "--new-tokens", "3",
                               "--slots", "2", "--max-len", "24"])
    assert stats.tokens_out == 9
    assert "done: 3/3 requests, 9 tokens" in capsys.readouterr().out
    losses = launch_train.main(["--arch", "minicpm3-4b", "--smoke",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "24", "--ckpt-dir",
                                str(tmp_path), "--log-every", "0"])
    assert len(losses) == 2 and np.isfinite(losses).all()


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_train_steps_match_jax(dtype):
    """Three train steps against JAX's jitted step, at the tolerances of
    ``tests/test_torch_train.py``: autograd through ``mla_full`` (the
    latent, the rope key broadcast to every head) and the flash
    attention's plain forward and backward at hd 24, vd 16."""
    jcfg, tcfg = _configs(dtype)
    tree = jax.tree_util.tree_map(np.asarray, _params(jcfg, tcfg, 9)[0])
    three_train_steps_match_jax(jcfg, tcfg, dtype, tree=tree, seed=9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_remat_gradients_are_bitwise(dtype):
    jcfg, tcfg = _configs(dtype)
    remat_grads_are_bitwise(tcfg, _params(jcfg, tcfg, seed=10)[1])
