"""The port's encoder-decoder family (SeamlessM4T-large-v2) against the JAX
package's, on the CPU.

The same numpy inputs (token ids and 0.02 · N(0, 1) frame embeddings, made
from a seed) go through the reference's ``repro.models.transformer``
(``encode``, ``_cross_attend``, ``lm_forward``, ``lm_prefill``,
``lm_decode_step``) and the port's, on the smoke config (2 encoder + 2
decoder layers, d_model 96, 4/4 heads of 24), with JAX's ``init_params``
(the norms' scales redrawn, so that they are exercised) carried across by
``convert.lm_params_from_numpy``; then three donated train steps against
JAX's jitted step, remat, the prefill and serve step factories in a greedy
lockstep loop, and the serving engine's refusal.

The encoder attends without a mask (Sq = Skv = S_enc); cross attention
attends from the S_text decoder positions over the S_enc encoder ones
(Sq ≠ Skv, no mask), which the flash kernels' plain versions compute on
the CPU.  S_enc = 50 is not a multiple of the smoke config's 64-key tile.

Tolerances: f32 rtol = atol = 1e-4 for encode and cross attention, rtol
1e-4 and atol 1e-4 · max|ref| for logits and self caches
(``tests/test_torch_lm.py``); bf16 0.05 · max(max|ref|, 1).  The cross
caches are bf16 in both packages whatever the activation dtype: in an f32
model their f32 sources agree to 1e-5 and round alike but for those that
straddle a rounding boundary, so they are held to one bf16 step with at
most 1% of elements not bitwise (``tests/test_torch_mla.py``'s bf16
caches).
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
from repro.train.step import make_prefill_step as jmake_prefill_step
from repro.train.step import make_serve_step as jmake_serve_step
from repro_torch.configs import get_config as tfull
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serve import ServingEngine
from repro_torch.train.step import make_prefill_step, make_serve_step
from test_torch_mla import _close, _close_cache
from test_torch_train import (remat_grads_are_bitwise,
                              three_train_steps_match_jax)

ARCH = "seamless_m4t_large_v2"
B, S, S_ENC, CACHE, STEPS = 2, 20, 50, 32, 2


def _configs(dtype):
    return (dataclasses.replace(jget(ARCH), activation_dtype=dtype),
            dataclasses.replace(tget(ARCH), activation_dtype=dtype))


def _params(jcfg, tcfg, seed):
    """JAX's init tree with every norm's scale redrawn, and the port's
    copy."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for stack, names in (("encoder", ("norm0", "norm1")),
                         ("blocks", ("norm0", "norm1", "norm2"))):
        for name in names:
            a = tree[stack][name]
            tree[stack][name] = (1 + 0.1 * rng.standard_normal(a.shape)
                                 ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_numpy(tree, tcfg, device="cpu"))


def _frames(rng, b, d, n=S_ENC):
    return (0.02 * rng.standard_normal((b, n, d))).astype(np.float32)


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_attention_match_jax(dtype):
    """The encoder alone, then one decoder layer's cross attention alone
    (its keys and values projected from that encoder output), at Sq = S
    over Skv = S_enc."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(2)
    frames = _frames(rng, B, tcfg.d_model)
    jmem = JT.encode(jparams, jcfg, jnp.asarray(frames))
    tmem = TT.encode(tparams, tcfg, torch.from_numpy(frames))
    assert tmem.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else None

    def close(out, ref, what):
        if tol is None:
            return _close(out, ref, dtype, what)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol, err_msg=what)

    close(tmem, jmem, "encode")
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    for l in range(tcfg.num_layers):
        jp = {k: v[l] for k, v in jparams["blocks"]["cross"].items()}
        tp = {k: v[l] for k, v in tparams["blocks"]["cross"].items()}
        # the same memory into both: the encoder's, as JAX computed it
        mem = np.asarray(jmem, np.float32)
        jm, tm = _pair(mem, dtype)
        ref = JT._cross_attend(jp, jx, jm, jcfg)
        out = TT._cross_attend(tp, tx, *TT._cross_kv(tp, tm, tcfg), tcfg)
        assert out.shape == tx.shape and out.dtype == tx.dtype
        close(out, ref, f"cross attention, layer {l}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_lm_matches_jax(dtype):
    """``lm_forward``; ``lm_prefill``'s logits, self caches and bf16 cross
    caches; two ``lm_decode_step``s at pos = S + i, which leave the cross
    cache as it is."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    frames = _frames(rng, B, tcfg.d_model)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    prompt = toks[:, :S]
    _close(TT.lm_forward(tparams, tcfg, torch.from_numpy(toks),
                         encoder_embeds=tf),
           JT.lm_forward(jparams, jcfg, jnp.asarray(toks),
                         encoder_embeds=jf), dtype, "lm_forward",
           logits=True)
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(prompt),
                                 cache_len=CACHE, encoder_embeds=jf)
    tlog, tcache = TT.lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                                 cache_len=CACHE, encoder_embeds=tf)
    _close(tlog, jlog, dtype, "lm_prefill logits", logits=True)
    zero = TT.init_cache(tcfg, B, CACHE, enc_len=S_ENC)
    assert set(tcache) == set(zero) == {"self", "cross"}
    for name in ("k", "v"):
        want = (tcfg.num_layers, B, S_ENC, tcfg.num_kv_heads,
                tcfg.resolved_head_dim)
        assert tuple(tcache["cross"][name].shape) == want
        assert tcache["self"][name].shape == zero["self"][name].shape
        assert tcache["self"][name].dtype == getattr(torch, dtype)
        _close(tcache["self"][name], jcache["self"][name], dtype,
               f"prefill self {name}", logits=True)
        _close_cache(tcache["cross"][name], jcache["cross"][name], dtype,
                     f"prefill cross {name}")
    cross = {k: t.clone() for k, t in tcache["cross"].items()}
    for i in range(STEPS):
        step = toks[:, S + i:S + i + 1]
        jlog, jcache = JT.lm_decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(step), jnp.int32(S + i))
        tlog, tcache = TT.lm_decode_step(tparams, tcfg, tcache,
                                         torch.from_numpy(step), S + i)
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        _close(tlog, jlog, dtype, f"decode step {i} logits", logits=True)
        for name in ("k", "v"):
            _close(tcache["self"][name], jcache["self"][name], dtype,
                   f"decode step {i} self {name}", logits=True)
            assert torch.equal(tcache["cross"][name], cross[name])


def test_encdec_serve_steps_match_a_jax_greedy_loop():
    """The way to serve an encoder-decoder: ``make_prefill_step`` on the
    tokens and frames, then ``make_serve_step`` in lockstep at pos = S + i,
    greedy, in f32: the port's tokens are JAX's argmax."""
    jcfg, tcfg = _configs("float32")
    jparams, tparams = _params(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(rng, B, tcfg.d_model)
    jprefill = jmake_prefill_step(jcfg, cache_len=CACHE)
    jserve = jmake_serve_step(jcfg)
    tprefill = make_prefill_step(tcfg, cache_len=CACHE)
    tserve = make_serve_step(tcfg)
    jlog, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(frames)})
    tlog, tcache = tprefill(tparams, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)})
    for i in range(4):
        assert tlog.shape == (B, tcfg.vocab_size)
        _close(tlog, jlog, "float32", f"step {i}", logits=True)
        cur = tlog.argmax(-1).to(torch.int32)
        assert np.array_equal(cur.numpy(), np.asarray(jlog).argmax(-1))
        jlog, jcache = jserve(jparams, jcache, jnp.asarray(cur.numpy())[:, None],
                              jnp.int32(S + i))
        tlog, tcache = tserve(tparams, tcache, cur[:, None], S + i)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_encdec_param_defs_match_jax(which):
    """Leaf for leaf the reference's shapes and dtypes (the encoder stack,
    its final norm, the decoder's cross attention without biases and its
    three norms), and the parameter count."""
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
    assert set(ttree["blocks"]) == {"attn", "cross", "mlp", "norm0",
                                    "norm1", "norm2"}
    assert TP.param_count_actual(tcfg) == jcount(jcfg)
    if which == "full":
        assert TP.param_count_actual(tcfg) == 2_034_784_256
        assert ttree["encoder"]["attn"]["wq"][0] == (24, 1024, 1024)
        assert TT.attention_calls(tcfg) == 72
        assert TT.attention_calls(tcfg, decode=True) == 48


def test_serving_engine_refuses_an_encoder_decoder():
    """As the reference's engine, the port's passes no frames to the
    prefill; it refuses an encoder-decoder at construction and names the
    step factories that serve one."""
    _, tcfg = _configs("float32")
    with pytest.raises(ValueError, match="make_prefill_step.*make_serve_step"):
        ServingEngine(tcfg, {}, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        TT.lm_forward({"embed": {"tok": torch.zeros(tcfg.vocab_size,
                                                   tcfg.d_model)}},
                      tcfg, torch.zeros(1, 4, dtype=torch.int32))


# ------------------------------------------------------------- training
def _frame_extras(d):
    return lambda step: {"frames": _frames(np.random.default_rng(100 + step),
                                           2, d)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_train_steps_match_jax(dtype):
    """Three train steps against JAX's jitted step, at the tolerances of
    ``tests/test_torch_train.py``: the encoder's gradients arrive only
    through cross attention's dk and dv."""
    jcfg, tcfg = _configs(dtype)
    tree = jax.tree_util.tree_map(np.asarray, _params(jcfg, tcfg, 7)[0])
    three_train_steps_match_jax(jcfg, tcfg, dtype, tree=tree, seed=7,
                                extras=_frame_extras(tcfg.d_model))


def test_encdec_remat_gradients_are_bitwise():
    jcfg, tcfg = _configs("float32")
    remat_grads_are_bitwise(tcfg, _params(jcfg, tcfg, seed=8)[1],
                            extras=_frame_extras(tcfg.d_model))
