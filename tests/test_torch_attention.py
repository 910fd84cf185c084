"""The port's attention functions against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through
- the Pallas kernels in interpret mode (``repro.kernels.flash_attention``,
  ``repro.kernels.decode_attention``) and the model's jnp attention
  (``repro.models.layers.blocked_attention`` / ``decode_attention``), and
- the port's wrappers (``repro_torch.kernels.*.kernel``), which on CPU
  tensors run the kernels' plain versions, and the port's model layers.

The sweep is ``tests/test_kernels.py``'s.  Tolerances are that file's: f32
rtol = atol = 1e-5 (the tiles' sums are taken in another order), bf16
2e-2 (one bf16 rounding of outputs of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_kernel
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.models import layers as JL
from repro_torch.kernels.decode_attention.kernel import (
    CLUSTER, ROWS_PER_BLOCK, decode_attention, decode_attention_plain,
    launch_grid)
from repro_torch.kernels.flash_attention.kernel import (
    Offsets, flash_attention, flash_attention_dynamic,
    flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import blocked_attention_ref
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

FLASH_SWEEP = [
    # B, S, H, KV, hd, vd, causal, window, dtype
    (2, 256, 8, 2, 64, 64, True, None, "float32"),
    (1, 192, 4, 4, 32, 32, True, 64, "float32"),     # MHA + window
    (2, 128, 6, 2, 32, 16, False, None, "bfloat16"),  # vd != hd
    (1, 128, 16, 1, 64, 64, True, None, "bfloat16"),  # MQA, G = 16
    (3, 64, 4, 2, 128, 128, True, None, "float32"),   # 128-dim heads
    (2, 100, 14, 2, 64, 64, True, 24, "float32"),     # Qwen2, window, pad
]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array (bf16: both round the
    f32 values to nearest even)."""
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


@pytest.mark.parametrize("b,s,h,kv,hd,vd,causal,window,dtype", FLASH_SWEEP)
def test_flash_attention_matches_pallas_and_model_path(b, s, h, kv, hd, vd,
                                                       causal, window, dtype):
    rng = np.random.default_rng(s * 31 + h)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, shape), dtype)
        for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, vd)))
    pallas = jflash(jq, jk, jv, causal=causal, window=window, q_block=64,
                    kv_block=64, interpret=True)
    model = JL.blocked_attention(jq, jk, jv, causal=causal, window=window,
                                 q_block=64, kv_block=64)
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          q_block=64, kv_block=64)
    layer = TL.blocked_attention(tq, tk, tv, causal=causal, window=window,
                                 q_block=64, kv_block=64)
    assert out.dtype == tq.dtype and out.shape == (b, s, h, vd)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(model), **_tol(dtype))
    assert torch.equal(layer, out)
    # the kernel's tiles are its own: the plain version's tiling must not
    # change the answer beyond rounding
    other = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                  q_block=32, kv_block=128)
    np.testing.assert_allclose(_np(other), _np(out), **_tol(dtype))


#: the hybrid's and MLA's (hd, vd): Zamba2-7B, MiniCPM3-4B, its smoke config
MODEL_HEAD_DIMS = [(112, 112), (96, 64), (24, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,vd", MODEL_HEAD_DIMS)
def test_model_head_dims_match_the_model_path(hd, vd, dtype):
    """Both plain versions at the model families' head dims against the
    reference's ``blocked_attention`` (with MLA's explicit scale) and
    ``decode_attention``, at G = 1 as both families have it."""
    b, s, h, clen = 2, 96, 4, 70
    rng = np.random.default_rng(hd + vd)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, shape), dtype)
        for shape in ((b, s, h, hd), (b, s, h, hd), (b, s, h, vd)))
    scale = hd ** -0.5
    model = JL.blocked_attention(jq, jk, jv, causal=True,
                                 softmax_scale=scale, q_block=32,
                                 kv_block=64)
    out = TL.blocked_attention(tq, tk, tv, causal=True, softmax_scale=scale,
                               q_block=32, kv_block=64)
    assert out.dtype == tq.dtype and out.shape == (b, s, h, vd)
    np.testing.assert_allclose(_np(out), _np(model), **_tol(dtype))
    jq1, tq1 = jq[:, -1:], tq[:, -1:].contiguous()
    model = JL.decode_attention(jq1, jk, jv, cache_len=jnp.int32(clen))
    out = TL.decode_attention(tq1, tk, tv, cache_len=torch.tensor(
        clen, dtype=torch.int32))
    assert out.dtype == tq.dtype and out.shape == (b, 1, h, vd)
    np.testing.assert_allclose(_np(out), _np(model), **_tol(dtype))


def test_flash_attention_exact_softmax_oracle():
    """Against an unblocked full softmax in f64."""
    b, s, h, kv, hd = 1, 96, 4, 2, 32
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, (b, s, n, hd)) for n in (h, kv, kv))
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd).astype(np.float64)
    scores = np.einsum("bqkgd,bckd->bkgqc", qg, k) * hd ** -0.5
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bkgqc,bckd->bqkgd", p, v).reshape(b, s, h, hd)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          q_block=32, kv_block=32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    out64 = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  q_block=32, kv_block=32,
                                  dtype=torch.float64)
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out64.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b,s,h,kv,hd,clen,dtype", [
    (2, 256, 8, 2, 64, 200, "float32"),
    (1, 512, 16, 1, 64, 512, "bfloat16"),   # MQA, full cache
    (4, 128, 4, 4, 32, 77, "float32"),      # partial cache
    (8, 160, 14, 2, 64, 130, "bfloat16"),   # Qwen2 group, partial cache
    (2, 64, 4, 2, 16, 1000, "float32"),     # cache_len past S: clamped
])
def test_decode_attention_matches_pallas_and_model_path(b, s, h, kv, hd, clen,
                                                        dtype):
    rng = np.random.default_rng(7 + s)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, shape), dtype)
        for shape in ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    pallas = decode_attention_kernel(jq, jk, jv, jnp.int32(clen),
                                     interpret=True)
    model = JL.decode_attention(jq, jk, jv, cache_len=jnp.int32(clen))
    tlen = torch.tensor(clen, dtype=torch.int32)
    out = decode_attention(tq, tk, tv, tlen)
    layer = TL.decode_attention(tq, tk, tv, cache_len=tlen)
    assert out.dtype == tq.dtype and out.shape == (b, 1, h, hd)
    # the port scales q in its own dtype, as layers.decode_attention; the
    # Pallas kernel widens it first (one bf16 rounding of scale * q apart)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(layer), _np(model), **_tol(dtype))
    assert torch.equal(layer, out)
    assert torch.equal(decode_attention(tq, tk, tv, clen), out)


def test_decode_attention_ignores_slots_past_cache_len():
    b, s, h, kv, hd = 1, 128, 4, 2, 32
    rng = np.random.default_rng(9)
    q, kc, vc = (torch.from_numpy(_normal(rng, shape))
                 for shape in ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    out1 = decode_attention(q, kc, vc, 50)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 50:] = 99.0
    vc2[:, 50:] = -99.0
    out2 = decode_attention(q, kc2, vc2, 50)
    assert torch.equal(out1, out2)
    # and equal to attention over the first 50 slots alone
    out3 = decode_attention(q, kc[:, :50].contiguous(),
                            vc[:, :50].contiguous(), 50)
    np.testing.assert_allclose(out1.numpy(), out3.numpy(), **F32_TOL)


def test_plain_decode_is_the_flash_plain_on_the_last_row():
    """One query at position n-1 over n keys, causally, is decode over a
    cache of n slots: the two plain versions agree."""
    b, n, h, kv, hd = 2, 70, 6, 2, 32
    rng = np.random.default_rng(11)
    k = torch.from_numpy(_normal(rng, (b, n, kv, hd)))
    v = torch.from_numpy(_normal(rng, (b, n, kv, hd)))
    q = torch.from_numpy(_normal(rng, (b, n, h, hd)))
    full = flash_attention_plain(q, k, v, causal=True, q_block=16,
                                 kv_block=32)
    last = decode_attention_plain(q[:, -1:].contiguous(), k, v, n)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), **F32_TOL)


def test_shape_and_option_checks():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="groups"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match=r"\(B, 1, H, hd\)"):
        decode_attention(q, q, q, 4)
    # a dynamic offset takes the dynamic path: the call runs
    out = TL.blocked_attention(q, q, q, q_offset=3)
    assert out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError, match="device"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("b,h,kv,want", [
    # Qwen2 decode: 16 clusters of 8 CTAs
    (8, 14, 2, (8, 2, 8)),
    # one head, one sequence: one cluster
    (1, 1, 1, (8, 1, 1)),
    # MHA: a group of one head per KV head
    (2, 4, 4, (8, 4, 2)),
    # a group of exactly ROWS_PER_BLOCK heads is one row chunk, one more
    # head takes a second
    (3, 16, 2, (8, 2, 3)),
    (3, 18, 2, (8, 4, 3)),
    # MQA with G = 16: two row chunks
    (1, 16, 1, (8, 2, 1)),
    # the largest grid the wrapper takes in y and z
    (65535, 8 * 65535, 65535, (8, 65535, 65535)),
])
def test_decode_launch_plan(b, h, kv, want):
    grid = launch_grid(b, h, kv)
    assert grid == want
    assert grid[0] == CLUSTER
    # the row chunks of each KV head cover its group, and none is empty
    chunks, g = grid[1] // kv, h // kv
    assert grid[1] == kv * chunks
    assert (chunks - 1) * ROWS_PER_BLOCK < g <= chunks * ROWS_PER_BLOCK


# ----------------------------------------------------- dynamic offsets
#: B, Sq, Skv, H, KV, hd, causal, window, (q_offset, kv_offset,
#: kv_valid_len), q_block, kv_block: Skv a multiple of kv_block, so the
#: reference's padding fault (below) stays out of the comparison; every
#: query row sees a key
DYNAMIC = {
    "decode-like-g2": (2, 16, 128, 4, 2, 16, True, None, (200, 100, None),
                       8, 64),
    "valid-len-window": (1, 24, 128, 4, 2, 16, True, 50, (200, 100, 180),
                         8, 32),
    "not-causal-valid": (2, 12, 128, 4, 4, 16, False, None, (0, 64, 150),
                         4, 64),
    "mqa-g8": (1, 24, 64, 8, 1, 32, True, None, (37, 5, None), 8, 32),
}


def _dynamic_inputs(case, dtype, seed=7):
    b, sq, skv, h, kv, hd = DYNAMIC[case][:6]
    rng = np.random.default_rng(seed)
    return [_pair(_normal(rng, shape), dtype)
            for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


def _offsets(case):
    """The reference's offsets as int32 arrays; the port's as 0-d int32
    tensors, but for one case's q_offset, a Python int."""
    q_off, kv_off, valid = DYNAMIC[case][8]
    j = {"q_offset": jnp.int32(q_off), "kv_offset": jnp.int32(kv_off),
         "kv_valid_len": None if valid is None else jnp.int32(valid)}
    t = lambda x: torch.tensor(x, dtype=torch.int32)
    port = {"q_offset": q_off if case == "mqa-g8" else t(q_off),
            "kv_offset": t(kv_off),
            "kv_valid_len": None if valid is None else t(valid)}
    return j, port


def _dynamic_opts(case):
    causal, window, _, q_block, kv_block = DYNAMIC[case][6:]
    return dict(causal=causal, window=window, q_block=q_block,
                kv_block=kv_block)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DYNAMIC))
def test_dynamic_offsets_match_the_reference(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _dynamic_inputs(case, dtype)
    joff, toff = _offsets(case)
    opts = _dynamic_opts(case)
    want = JL.blocked_attention(jq, jk, jv, **joff, **opts)
    got = TL.blocked_attention(tq, tk, tv, **toff, **opts)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    # the plain version of the dynamic path, at the call's tiles and at
    # others; the wrapper's f32 output and lse
    ref = blocked_attention_ref(tq, tk, tv, **toff, **opts)
    assert torch.equal(ref, got)
    other = blocked_attention_ref(tq, tk, tv, **toff,
                                  **{**opts, "q_block": 16, "kv_block": 16})
    np.testing.assert_allclose(_np(other), _np(got), **_tol(dtype))
    out, lse = flash_attention_dynamic(tq, tk, tv, Offsets(**toff), **opts)
    assert out.dtype == torch.float32 and lse.shape == (
        tq.shape[0], tq.shape[2], tq.shape[1])
    assert torch.equal(out.to(tq.dtype), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DYNAMIC))
def test_dynamic_offsets_gradients_match_jax_vjp(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _dynamic_inputs(case, dtype, seed=11)
    dout = _normal(np.random.default_rng(12), tuple(tq.shape))
    jdout, tdout = _pair(dout, dtype)
    joff, toff = _offsets(case)
    opts = _dynamic_opts(case)
    _, vjp = jax.vjp(lambda q, k, v: JL.blocked_attention(
        q, k, v, **joff, **opts), jq, jk, jv)
    want = vjp(jdout)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    TL.blocked_attention(*ts, **toff, **opts).backward(tdout)
    for name, t, w in zip("qkv", ts, want):
        assert t.grad.dtype == t.dtype, name
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        tol = (dict(rtol=1e-5, atol=1e-5 * scale) if dtype == "float32"
               else dict(rtol=0.0, atol=0.05 * scale))
        np.testing.assert_allclose(_np(t.grad), _np(w), **tol,
                                   err_msg=f"d{name}")


def test_dynamic_offsets_pin_the_reference_padding_fault():
    # Skv = 100, no multiple of kv_block = 64, at kv_offset 150: the
    # reference's padding mask compares Skv against absolute positions
    # and drops the last 150 real keys as well; the port masks only the
    # padding and agrees with a naive softmax over the 100 keys
    b, sq, skv, h, kv, hd = 1, 8, 100, 4, 2, 16
    q_off, kv_off = 200, 150
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, s) for s in ((b, sq, h, hd), (b, skv, kv, hd),
                                          (b, skv, kv, hd)))
    g = h // kv
    s = np.einsum("bqkgd,bckd->bkgqc",
                  q.reshape(b, sq, kv, g, hd).astype(np.float64), k) / 4.0
    ok = (kv_off + np.arange(skv))[None, :] <= (q_off + np.arange(sq))[:, None]
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    naive = np.einsum("bkgqc,bckd->bqkgd", p, v).reshape(b, sq, h, hd)
    opts = dict(causal=True, q_block=8, kv_block=64)
    got = TL.blocked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_offset=torch.tensor(q_off, dtype=torch.int32),
        kv_offset=torch.tensor(kv_off, dtype=torch.int32), **opts)
    np.testing.assert_allclose(got.numpy(), naive, rtol=1e-5, atol=1e-5)
    want = JL.blocked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                q_offset=jnp.int32(q_off),
                                kv_offset=jnp.int32(kv_off), **opts)
    assert np.abs(np.asarray(want) - naive).max() > 0.5


def test_dynamic_row_that_sees_no_key_is_zero():
    # kv_valid_len = 0 masks every key: the output and every gradient are 0
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 8, 2, 16))).requires_grad_()
               for _ in range(3))
    out = TL.blocked_attention(q, k, v, kv_offset=torch.tensor(
        0, dtype=torch.int32), kv_valid_len=torch.tensor(0, dtype=torch.int32),
        q_block=4, kv_block=4)
    assert not out.any()
    out.sum().backward()
    assert not any(t.grad.any() for t in (q, k, v))
