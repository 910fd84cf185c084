"""The port's flash attention gradients against the JAX package's, on the
CPU.

``repro_torch.models.layers.blocked_attention`` with q, k, v requiring
grad goes through ``FlashAttention`` (on CPU tensors: the plain forward
with its log-sum-exp, then ``flash_attention_bwd_plain``); the reference
is ``jax.vjp`` of ``repro.models.layers.blocked_attention`` at static
offsets, its ``custom_vjp`` flash path.  The same numpy inputs and output
cotangent (from a seed) go through both, at the same tiles.

Tolerances: in f32, rtol = atol = 1e-5 (the same f32 sums in another
order); in bf16, 0.05 · max(max|ref|, 1), the bf16 tolerance of
``tests/test_torch_lm.py`` (inputs, output and gradients each rounded to
bf16 at the same places, the sums in f32 in another order).  One tiny
case runs ``torch.autograd.gradcheck`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention.kernel import (
    FlashAttention, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.models import layers as TL

#: B, S, H, KV, hd, vd, causal, window, q_block, kv_block
CASES = {
    "causal-g3-hd16": (2, 48, 6, 2, 16, 16, True, None, 16, 32),
    "causal-g3-hd32": (1, 64, 6, 2, 32, 32, True, None, 32, 16),
    "window-g3": (1, 64, 6, 2, 32, 32, True, 20, 16, 32),
    "ragged-g1": (2, 37, 4, 4, 16, 32, True, None, 16, 16),
    "ragged-window-g1": (1, 45, 2, 2, 32, 16, True, 9, 16, 16),
    "not-causal-g3": (1, 40, 3, 1, 32, 16, False, None, 16, 32),
    "ragged-window-g3-hd16": (2, 29, 3, 1, 16, 16, True, 7, 8, 16),
    # the hybrid's (Zamba2-7B) and MLA's (MiniCPM3-4B, its smoke config)
    # head dims
    "hybrid-hd112-g1": (1, 40, 2, 2, 112, 112, True, None, 16, 32),
    "mla-hd96-vd64-g1-window": (2, 37, 2, 2, 96, 64, True, 11, 16, 16),
    "mla-smoke-hd24-vd16": (2, 45, 4, 2, 24, 16, True, None, 16, 16),
}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 0.05


def _inputs(case, seed):
    b, s, h, kv, hd, vd = CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, vd)).astype(np.float32)
    dout = rng.standard_normal((b, s, h, vd)).astype(np.float32)
    return q, k, v, dout


def _opts(case):
    causal, window, q_block, kv_block = CASES[case][6:]
    return dict(causal=causal, window=window, q_block=q_block,
                kv_block=kv_block)


def _jax_grads(arrays, case, dtype):
    q, k, v, dout = (jnp.asarray(a, dtype) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: JL.blocked_attention(
        q, k, v, **_opts(case)), q, k, v)
    return (out, *vjp(dout))


def _torch_grads(arrays, case, dtype):
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = TL.blocked_attention(q, k, v, **_opts(case))
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def _close(out, ref, dtype, what):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, err_msg=what, **F32_TOL)
    else:
        err = float(np.abs(out - ref).max())
        scale = max(float(np.abs(ref).max()), 1.0)
        assert err <= BF16_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_gradients_match_jax_vjp(case, dtype):
    arrays = _inputs(case, seed=sorted(CASES).index(case))
    ref = _jax_grads(arrays, case, getattr(jnp, dtype))
    got = _torch_grads(arrays, case, getattr(torch, dtype))
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert g.dtype == getattr(torch, dtype), name
        _close(g, r, dtype, f"{case} {name}")


def test_flash_gradcheck_f64():
    """The plain forward and backward in f64 against finite differences."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((1, 7, 2, 16), (1, 7, 1, 16), (1, 7, 1, 16)))
    fn = lambda q, k, v: FlashAttention.apply(q, k, v, True, 4, None, 4, 4)
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_lse_is_the_masked_logsumexp(case):
    """The plain forward's residuals in f64: the output equals the plain
    output, and lse the log-sum-exp of the scaled, masked scores of each
    row (every row here sees at least one key)."""
    b, s, h, kv, hd, vd, causal, window = CASES[case][:8]
    q, k, v, _ = (torch.from_numpy(a).double()
                  for a in _inputs(case, seed=3))
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    assert out.dtype == lse.dtype == torch.float64
    assert lse.shape == (b, h, s)
    torch.testing.assert_close(out, flash_attention_plain(
        q, k, v, **_opts(case)), rtol=1e-12, atol=1e-12)
    g = h // kv
    scores = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5,
                          k.repeat_interleave(g, dim=2))
    i = torch.arange(s)
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    want = torch.logsumexp(scores.masked_fill(~mask, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-12, atol=1e-12)


def test_bwd_wrapper_takes_the_plain_version_on_cpu_and_checks_shapes():
    case = "window-g3"
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(case, seed=5))
    out, lse = flash_attention(q, k, v, return_lse=True, **_opts(case))
    got = flash_attention_bwd(q, k, v, out, lse, dout, **_opts(case))
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **_opts(case))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :, 1:], dout,
                            **_opts(case))
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, dout[..., 1:],
                            **_opts(case))


def test_no_grad_call_keeps_the_inference_path(monkeypatch):
    """Without autograd recording, blocked_attention takes the forward
    alone (no log-sum-exp, no autograd function)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs("causal-g3-hd16", 1))
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return flash_attention_plain(*args, **kwargs)

    monkeypatch.setattr(TL, "flash_attention_differentiable", counted)
    TL.blocked_attention(q, k, v)
    q.requires_grad_(True)
    with torch.no_grad():
        TL.blocked_attention(q, k, v)
    assert not calls
    TL.blocked_attention(q, k, v)
    assert calls == [1]
