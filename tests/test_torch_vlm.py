"""The port's vision-frontend family (InternVL2-2B) against the JAX
package's, on the CPU.

The frontend is a stub in both packages: P precomputed patch embeddings
(0.02 · N(0, 1), made from a seed with numpy) are put before the token
embeddings.  The same inputs go through the reference's
``repro.models.transformer`` (``lm_forward``, ``lm_prefill``,
``lm_decode_step`` with ``prefix_embeds``) and the port's, on the smoke
config (3 layers, d_model 128, 8/4 heads of 16, P = 16), with JAX's
``init_params`` (the norms' scales redrawn) carried across by
``convert.lm_params_from_numpy``; then three donated train steps against
JAX's jitted step, whose loss covers the text positions only, remat, the
prefill step factory with the patch embeddings, and the serving engine,
which serves the model text-only as the reference's engine does.

Tolerances: f32 rtol 1e-4 and atol 1e-4 · max|ref| for logits and caches
(``tests/test_torch_lm.py``), bf16 0.05 · max(max|ref|, 1).
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
from repro.train.step import make_eval_step as jmake_eval_step
from repro.train.step import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_config as tfull
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serve import Request
from repro_torch.train.step import make_eval_step, make_prefill_step
from test_torch_lm_serving import RecordingEngine, replay_waves_in_jax
from test_torch_mla import _close
from test_torch_train import (remat_grads_are_bitwise,
                              three_train_steps_match_jax)

ARCH = "internvl2_2b"
B, S, CACHE, STEPS = 2, 20, 48, 2


def _configs(dtype):
    return (dataclasses.replace(jget(ARCH), activation_dtype=dtype),
            dataclasses.replace(tget(ARCH), activation_dtype=dtype))


def _params(jcfg, tcfg, seed):
    """JAX's init tree with the norms' scales redrawn, and the port's
    copy."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("norm0", "norm1"):
        a = tree["blocks"][name]
        tree["blocks"][name] = (1 + 0.1 * rng.standard_normal(a.shape)
                                ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_numpy(tree, tcfg, device="cpu"))


def _patches(rng, b, cfg):
    return (0.02 * rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_lm_matches_jax(dtype):
    """``lm_forward`` over P + S positions; ``lm_prefill``'s logits and
    caches, whose first P slots hold the patches' keys and values; two
    ``lm_decode_step``s at pos = P + S + i."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(2)
    p = tcfg.frontend_len
    toks = rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    patches = _patches(rng, B, tcfg)
    jpe, tpe = jnp.asarray(patches), torch.from_numpy(patches)
    out = TT.lm_forward(tparams, tcfg, torch.from_numpy(toks),
                        prefix_embeds=tpe)
    assert out.shape == (B, p + S + STEPS, tcfg.vocab_size)
    _close(out, JT.lm_forward(jparams, jcfg, jnp.asarray(toks),
                              prefix_embeds=jpe), dtype, "lm_forward",
           logits=True)
    prompt = toks[:, :S]
    jlog, jcache = JT.lm_prefill(jparams, jcfg, jnp.asarray(prompt),
                                 cache_len=CACHE, prefix_embeds=jpe)
    tlog, tcache = TT.lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                                 cache_len=CACHE, prefix_embeds=tpe)
    _close(tlog, jlog, dtype, "lm_prefill logits", logits=True)
    assert set(tcache) == {"kv"}
    for name in ("k", "v"):
        assert tuple(tcache["kv"][name].shape) == (
            tcfg.num_layers, B, CACHE, tcfg.num_kv_heads,
            tcfg.resolved_head_dim)
        assert bool(tcache["kv"][name][:, :, :p + S].abs().sum(-1).gt(0)
                    .all())
        _close(tcache["kv"][name], jcache["kv"][name], dtype,
               f"prefill cache {name}", logits=True)
    for i in range(STEPS):
        step = toks[:, S + i:S + i + 1]
        jlog, jcache = JT.lm_decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(step),
                                         jnp.int32(p + S + i))
        tlog, tcache = TT.lm_decode_step(tparams, tcfg, tcache,
                                         torch.from_numpy(step), p + S + i)
        _close(tlog, jlog, dtype, f"decode step {i} logits", logits=True)
        for name in ("k", "v"):
            _close(tcache["kv"][name], jcache["kv"][name], dtype,
                   f"decode step {i} cache {name}", logits=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_and_eval_steps_match_jax(dtype):
    """The step factories with ``patch_embeds`` in the batch: the prefill's
    next-token logits, and the eval loss over the text positions only."""
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": labels,
             "patch_embeds": _patches(rng, B, tcfg)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlog, _ = jmake_prefill_step(jcfg, cache_len=CACHE)(jparams, jb)
    tlog, cache = make_prefill_step(tcfg, cache_len=CACHE)(tparams, tb)
    assert tlog.shape == (B, tcfg.vocab_size)
    _close(tlog, jlog, dtype, "prefill step", logits=True)
    jm = jmake_eval_step(jcfg)(jparams, jb)
    tm = make_eval_step(tcfg)(tparams, tb)
    rtol = 1e-5 if dtype == "float32" else 0.05
    for name in ("loss", "accuracy"):
        assert tm[name].item() == pytest.approx(float(jm[name]), rel=rtol,
                                                abs=1e-6), name


REQUESTS = [(9, 4), (14, 3), (6, 5)]
SLOTS, MAX_LEN = 2, 28


def test_serving_engine_serves_the_text_backbone():
    """The engine passes no patch embeddings, as the reference's: it serves
    the vision model as a text-only dense model, token for token JAX's
    greedy loop (f32)."""
    jcfg, tcfg = _configs("float32")
    jparams, tparams = _params(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    reqs = [Request(prompt=rng.integers(0, jcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=m, id=i)
        for i, (n, m) in enumerate(REQUESTS)]
    engine = RecordingEngine(tcfg, tparams, batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    stats = engine.run(reqs)
    checked, agreed = replay_waves_in_jax(engine, reqs, jcfg, jparams,
                                          "float32", SLOTS, MAX_LEN)
    assert agreed == checked > 0
    assert stats.tokens_out == sum(m for _, m in REQUESTS)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_vlm_param_defs_match_jax(which):
    """Leaf for leaf the reference's shapes and dtypes (the text backbone's:
    the frontend stub has no parameters), and the parameter count."""
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
        assert TP.param_count_actual(tcfg) == 1_889_146_880
        assert ttree["blocks"]["attn"]["wk"][0] == (24, 2048, 8 * 128)
        assert TT.attention_calls(tcfg) == 24


# ------------------------------------------------------------- training
def _patch_extras(cfg):
    return lambda step: {"patch_embeds": _patches(
        np.random.default_rng(200 + step), 2, cfg)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_train_steps_match_jax(dtype):
    """Three train steps against JAX's jitted step, at the tolerances of
    ``tests/test_torch_train.py``, the loss over the text positions."""
    jcfg, tcfg = _configs(dtype)
    tree = jax.tree_util.tree_map(np.asarray, _params(jcfg, tcfg, 7)[0])
    three_train_steps_match_jax(jcfg, tcfg, dtype, tree=tree, seed=7,
                                extras=_patch_extras(tcfg))


def test_vlm_remat_gradients_are_bitwise():
    jcfg, tcfg = _configs("float32")
    remat_grads_are_bitwise(tcfg, _params(jcfg, tcfg, seed=8)[1],
                            extras=_patch_extras(tcfg))
