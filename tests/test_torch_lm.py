"""The port's dense LM against the JAX package's, on the CPU.

JAX's ``init_params`` makes the weights (the zero-initialised QKV biases
are overwritten with random values, so the bias path is exercised) and
``convert.lm_params_from_numpy`` carries them across byte for byte.  The
same token ids (numpy, from a seed) then go through ``lm_forward``,
``lm_prefill`` (logits and caches) and two ``lm_decode_step``s of both
packages, on the Qwen2-0.5B and Yi-9B smoke configs and on a dense config
with a 16-token sliding window that decodes past its window.

Tolerances: with ``activation_dtype="float32"`` rtol 1e-4 and atol 1e-4 ·
max|logit| (f32 matmuls summed in another order by XLA and by PyTorch);
in the default bf16, 0.05 · max(max|logit|, 1), the tolerance
``tests/test_arch_smoke.py`` holds decode against forward to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.models.params import init_params as jinit
from repro.models.transformer import (lm_decode_step as jdecode,
                                      lm_forward as jforward,
                                      lm_prefill as jprefill)
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro.models import layers as JL
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models.transformer import (lm_decode_step, lm_forward,
                                            lm_prefill)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import loss_and_grads

B, S, CACHE = 2, 24, 40
CASES = {
    "qwen2": ("qwen2_0_5b", {}),
    "yi": ("yi_9b", {}),
    # MQA (8 query heads on 1 KV head) and the ungated GELU MLP
    "granite": ("granite_34b", {}),
    "qwen2-window16": ("qwen2_0_5b", {"sliding_window": 16}),
}


def _configs(arch, dtype, **over):
    over = dict(over, activation_dtype=dtype)
    return (dataclasses.replace(jget(arch), **over),
            dataclasses.replace(tget(arch), **over))


def _params(jcfg, tcfg, seed):
    """JAX's init tree with random QKV biases, and the port's copy."""
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(seed),
                                                    jcfg))
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)
                          ).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, lm_params_from_numpy(tree, tcfg, device="cpu")


def _close(out, ref, dtype, what, scale=None):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    scale = float(np.abs(ref).max()) if scale is None else scale
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=what)
    else:
        err = float(np.abs(out - ref).max())
        assert err < 0.05 * max(scale, 1.0), (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_matches_jax(case, dtype):
    arch, over = CASES[case]
    jcfg, tcfg = _configs(arch, dtype, **over)
    jparams, tparams = _params(jcfg, tcfg, seed=len(case))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 2)).astype(np.int32)
    prompt = toks[:, :S]

    ref = jforward(jparams, jcfg, jnp.asarray(toks))
    out = lm_forward(tparams, tcfg, torch.from_numpy(toks))
    _close(out, ref, dtype, "lm_forward")

    jlog, jcache = jprefill(jparams, jcfg, jnp.asarray(prompt),
                            cache_len=CACHE)
    tlog, tcache = lm_prefill(tparams, tcfg, torch.from_numpy(prompt),
                              cache_len=CACHE)
    _close(tlog, jlog, dtype, "lm_prefill logits")
    size = CACHE if tcfg.sliding_window is None else tcfg.sliding_window
    for name in ("k", "v"):
        assert tcache["kv"][name].shape == (
            tcfg.num_layers, B, size, tcfg.num_kv_heads,
            tcfg.resolved_head_dim)
        _close(tcache["kv"][name], jcache["kv"][name], dtype,
               f"prefill cache {name}")

    for i in range(2):
        step = toks[:, S + i:S + i + 1]
        jlog, jcache = jdecode(jparams, jcfg, jcache, jnp.asarray(step),
                               jnp.int32(S + i))
        tlog, tcache = lm_decode_step(tparams, tcfg, tcache,
                                      torch.from_numpy(step), S + i)
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        _close(tlog, jlog, dtype, f"decode step {i} logits")
        for name in ("k", "v"):
            _close(tcache["kv"][name], jcache["kv"][name], dtype,
                   f"decode step {i} cache {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_primitives_match_jax(dtype):
    """Norms, RoPE and both MLPs on the same inputs, rounded as the
    reference rounds them: f32 rtol = atol = 1e-5; bf16 rtol = atol = 0.05
    (the MLPs round three bf16 intermediates in series, each 2^-9
    relative, and their outputs reach |5|, where a bf16 ulp is 0.03)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    w = [(0.2 * rng.standard_normal(shape)).astype(np.float32)
         for shape in ((64, 96), (64, 96), (96, 64))]
    scale, bias = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32), \
        (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0.05, atol=0.05)
    pos = np.arange(5, dtype=np.int32)[None]
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 64, 1e6)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 64, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    pairs = [
        (JL.rms_norm(jx, jnp.asarray(scale)),
         TL.rms_norm(tx, torch.from_numpy(scale))),
        (JL.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias)),
         TL.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))),
        (JL.apply_rope(jx, jc, js), TL.apply_rope(tx, tc, ts)),
        (JL.swiglu(jx[:, :, 0], *map(jnp.asarray, w)),
         TL.swiglu(tx[:, :, 0], *map(torch.from_numpy, w))),
        (JL.gelu_mlp(jx[:, :, 0], jnp.asarray(w[0]), jnp.asarray(w[2])),
         TL.gelu_mlp(tx[:, :, 0], torch.from_numpy(w[0]),
                     torch.from_numpy(w[2]))),
    ]
    for i, (ref, out) in enumerate(pairs):
        assert out.dtype == tx.dtype, i
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), err_msg=str(i),
                                   **tol)


def test_decode_past_the_window_matches_forward():
    """A 16-token ring decoding 6 tokens past its window agrees with the
    full forward, whose attention applies the window."""
    jcfg, tcfg = _configs("qwen2_0_5b", "float32", sliding_window=16)
    _, tparams = _params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (B, 22)).astype(np.int32))
    full = lm_forward(tparams, tcfg, toks)
    _, cache = lm_prefill(tparams, tcfg, toks[:, :16], cache_len=64)
    for p in range(16, 22):
        lg, cache = lm_decode_step(tparams, tcfg, cache, toks[:, p:p + 1],
                                   torch.tensor(p, dtype=torch.int32))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, p].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_params_tree_and_init():
    tcfg = tget("qwen2_0_5b")
    params = TP.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = TP.param_shapes(tcfg)
    flat = lambda t: {k: (flat(v) if isinstance(v, dict) else v)
                      for k, v in t.items()}
    assert flat(params).keys() == shapes.keys()
    assert tuple(params["blocks"]["attn"]["wq"].shape) == \
        shapes["blocks"]["attn"]["wq"][0]
    assert torch.count_nonzero(params["blocks"]["attn"]["bq"]) == 0
    assert torch.equal(params["final_norm"], torch.ones(tcfg.d_model))
    std = float(params["embed"]["tok"].std())
    assert 0.018 < std < 0.022
    n = sum(int(np.prod(s)) for s, _ in jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == TP.param_count_actual(tcfg)
    from repro.configs import get_config as jfull
    from repro.models.params import param_count_actual as jcount
    from repro_torch.configs import get_config as tfull
    for arch in ("qwen2_0_5b", "yi_9b", "granite_34b",
                 "seamless_m4t_large_v2", "internvl2_2b"):
        assert TP.param_count_actual(tfull(arch)) == jcount(jfull(arch))
    # the same seed gives the same weights
    again = TP.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["blocks"]["mlp"]["w_up"],
                       params["blocks"]["mlp"]["w_up"])


@pytest.mark.parametrize("arch,family", [
    ("minicpm3_4b", "MLA"), ("zamba2_7b", "hybrid"),
])
def test_training_mla_and_hybrid_raises(arch, family):
    """Both families are built, served and trained (training raised until
    the flash backward was built at their head dims): ``loss_and_grads``
    gives a finite loss and a finite, nonzero gradient for every leaf."""
    cfg = tget(arch)
    assert TP.param_count_actual(cfg) > 0
    params = TP.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    loss, _, grads = loss_and_grads(params, cfg, {"tokens": tokens,
                                                  "labels": tokens})
    assert bool(torch.isfinite(loss))
    for g, p in zip(tree_leaves(grads), tree_leaves(params), strict=True):
        assert g.shape == p.shape, family
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0), (
            family, g.shape)


def test_lm_params_from_numpy_checks_the_tree():
    jcfg, tcfg = _configs("qwen2_0_5b", "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                    jcfg))
    params = lm_params_from_numpy(tree, tcfg, device="cpu")
    got = params["blocks"]["mlp"]["w_gate"]
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), tree["blocks"]["mlp"]["w_gate"])
    bad = dict(tree, lm_head=tree["final_norm"])
    with pytest.raises(KeyError, match="lm_head"):
        lm_params_from_numpy(bad, tcfg, device="cpu")
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(bad, tcfg, device="cpu")
