"""The attention kernels against their plain versions.

The plain versions' semantics are pinned on the CPU against a per-row
numpy softmax in f64; each CUDA kernel is held against its plain version
in f64 on the card (the flash kernel's and the decode kernel's f32 entries
compute on the CUDA cores, their bf16 entries on the tensor cores, with P
in two bf16 terms).  The flash backward kernel (f32 on the CUDA cores,
bf16 on the tensor cores with dS and dO in three bf16 terms, P in two)
is held against its plain version in f64 on the forward's own residuals:
gradients at rtol 1e-5 in f32 and 5e-3 in bf16 (each gradient rounded
once), atol 1e-5 of each gradient's largest element (f32
sums over up to thousands of rows); the forward's log-sum-exp at 1e-5 and
its f32 output at the f32 tolerance (2e-5 from the bf16 entry, whose P
enters P.V as two bf16 terms).
Tolerances: f32 outputs rtol = atol = 1e-5 (sums of
up to 4096 f32 terms in another order); bf16 outputs against f64 rtol 5e-3
(the output's one round-to-nearest, at most 2^-8 = 3.9e-3 of its value)
and atol 1e-5 (the f32 sums), and two bf16 results against each other
rtol 1e-2 (one bf16 step, 2^-7, apart at most).  This file
imports neither JAX nor the JAX package, so the card's tests run where JAX
is not installed:

    python -m pytest --noconftest -q tests/test_torch_attention_kernel.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIM_PAIRS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_plain)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-3, atol=1e-5)
BF16_PAIR_TOL = dict(rtol=1e-2, atol=1e-5)

FLASH_SHAPES = {
    # B, Sq, H, KV, hd, vd, causal, window
    "gqa": (2, 256, 8, 2, 64, 64, True, None),
    "mha-window": (1, 192, 4, 4, 32, 32, True, 64),
    "vd-ne-hd": (2, 128, 6, 2, 32, 16, False, None),
    "mqa": (1, 128, 16, 1, 64, 64, True, None),
    "hd128": (3, 64, 4, 2, 128, 128, True, None),
    "hd16": (2, 40, 4, 2, 16, 16, True, None),
    "qwen2-padded": (2, 1000, 14, 2, 64, 64, True, None),
    "qwen2-window": (1, 777, 14, 2, 64, 64, True, 100),
    "window-not-causal": (1, 300, 6, 3, 32, 64, False, 50),
    # the hybrid (Zamba2-7B) and MLA (MiniCPM3-4B, its smoke config) shapes
    "zamba2-hd112": (1, 300, 4, 4, 112, 112, True, None),
    "minicpm3-hd96-vd64": (2, 257, 5, 5, 96, 64, True, None),
    "mla-smoke-hd24-vd16": (2, 70, 4, 4, 24, 16, True, None),
    # the bf16 kernel's tile edges: rows (position, group head) that are
    # no multiple of its 128-row block at G = 7, 6 and 48, and hd 112 and
    # (96, 64) with windows that cross its 64-key tiles
    "g7-rows-700": (1, 100, 14, 2, 64, 64, True, None),
    "g6-hd128-rows-900": (2, 150, 12, 2, 128, 128, True, None),
    "g48-mqa-hd128-rows-3696": (1, 77, 48, 1, 128, 128, True, None),
    "zamba2-hd112-window-100": (1, 400, 4, 4, 112, 112, True, 100),
    "minicpm3-hd96-vd64-window-70": (2, 300, 5, 5, 96, 64, True, 70),
}

#: flash cases whose keys are not the queries (an encoder-decoder's cross
#: attention): B, Sq, H, KV, hd, vd, causal, window, Skv; more keys than
#: queries and fewer, one query, Seamless's 1,500 frames (no tile
#: multiple), and a causal mask over keys past the last query
FLASH_CROSS_CASES = {
    "sq-100-skv-211": (1, 100, 6, 2, 64, 32, False, None, 211),
    "sq-1-skv-77": (2, 1, 14, 2, 64, 64, False, None, 77),
    "seamless-sq-64-skv-1500": (2, 64, 16, 16, 64, 64, False, None, 1500),
    "sq-300-skv-130-hd112": (1, 300, 4, 4, 112, 112, False, None, 130),
    "causal-sq-70-skv-200": (1, 70, 8, 4, 128, 128, True, None, 200),
    # Skv one past a multiple of the bf16 kernel's 64-key tile, and one
    # query at G = 6, hd 128
    "sq-50-skv-129": (1, 50, 8, 2, 64, 64, False, None, 129),
    "sq-1-skv-200-g6-hd128": (2, 1, 12, 2, 128, 128, False, None, 200),
}

#: cases of the bf16 (tensor-core) flash kernel: B, Sq, H, KV, hd, vd,
#: causal, window, scale (None: hd^-0.5)
FLASH_BF16_CASES = {
    **{f"hd{hd}-vd{vd}": (1, 130, 4, 2, hd, vd, True, None, None)
       for hd, vd in HEAD_DIM_PAIRS},
    "g1": (2, 257, 4, 4, 64, 64, True, None, None),
    "hd112-g1-window": (1, 700, 4, 4, 112, 112, True, 256, None),
    "hd96-vd64-not-causal": (1, 333, 6, 6, 96, 64, False, None, None),
    "hd24-vd16-scale-0.3": (2, 99, 4, 4, 24, 16, True, None, 0.3),
    "g7": (1, 300, 14, 2, 64, 64, True, None, None),
    "g16": (1, 200, 16, 1, 64, 64, True, None, None),
    "not-causal": (2, 333, 14, 2, 64, 64, False, None, None),
    "window-512": (1, 1500, 14, 2, 64, 64, True, 512, None),
    "sq-3001": (1, 3001, 14, 2, 64, 64, True, None, None),
    "scale-0.3": (1, 300, 14, 2, 64, 64, True, None, 0.3),
}

#: cases of the one-launch decode kernel: B, S, H, KV, hd, vd, cache_len.
#: The valid length at and beside its 32-slot chunks, the Qwen2 midpoint
#: and a full cache; G of 1, 7 and 16; every head dim pair
DECODE_CASES = {
    **{f"cache-len-{n}": (2, 4096, 14, 2, 64, 64, n)
       for n in (1, 127, 128, 129, 2100, 2560, 2561, 4096)},
    "g1": (2, 600, 4, 4, 64, 64, 555),
    "g7": (3, 600, 14, 2, 64, 64, 600),
    "g16": (2, 600, 16, 1, 64, 64, 333),
    **{f"hd{hd}-vd{vd}": (2, 300, 4, 2, hd, vd, 257)
       for hd, vd in HEAD_DIM_PAIRS},
    # the hybrid and MLA decode shapes at G = 1, past several chunks
    "zamba2-hd112-g1": (4, 700, 8, 8, 112, 112, 650),
    "minicpm3-hd96-vd64-g1": (4, 700, 8, 8, 96, 64, 333),
    "mla-smoke-hd24-vd16-g1": (2, 300, 4, 4, 24, 16, 129),
}

#: cases of the flash backward kernel: B, S, H, KV, hd, vd, causal, window
#: and, where the keys are not the queries, Skv
FLASH_BWD_CASES = {
    **{f"hd{hd}-vd{vd}": (1, 130, 4, 2, hd, vd, True, None)
       for hd, vd in HEAD_DIM_PAIRS},
    "g1": (2, 257, 4, 4, 64, 64, True, None),
    # the hybrid and MLA families' training heads (G = 1)
    "zamba2-hd112-g1-window": (2, 300, 4, 4, 112, 112, True, 64),
    "minicpm3-hd96-vd64-g1": (2, 257, 5, 5, 96, 64, True, None),
    "mla-smoke-hd24-vd16-window": (2, 70, 4, 4, 24, 16, True, 9),
    "g7": (1, 300, 14, 2, 64, 64, True, None),
    "g16": (1, 200, 16, 1, 64, 64, True, None),
    "not-causal": (2, 333, 14, 2, 64, 64, False, None),
    "window-100": (1, 777, 14, 2, 64, 64, True, 100),
    "window-not-causal": (1, 300, 6, 3, 32, 64, False, 50),
    "s-1999": (1, 1999, 14, 2, 64, 64, True, None),
    # the edges of the tensor-core passes' tiles (64 rows or keys a block,
    # 16 a warp): Mixtral's heads with a window shorter than a tile,
    # lengths no multiple of 16 (one query: over 77 keys, not causal, as a
    # causal row over one key has dq = dk = 0, which no limit relative to
    # max |ref| holds), 63 rows in one 64-row tile, and keys that are not
    # the queries (encoder-decoder attention)
    "mixtral-hd128-g6-window-40": (1, 300, 12, 2, 128, 128, True, 40),
    "sq-1-skv-77-not-causal": (2, 1, 14, 2, 64, 64, False, None, 77),
    "s-17-hd96-vd64": (2, 17, 5, 5, 96, 64, True, None),
    "s-65-hd112": (1, 65, 12, 2, 112, 112, True, None),
    "g7-s9": (1, 9, 14, 2, 64, 64, True, None),
    "not-causal-skv-211-sq-100": (1, 100, 6, 2, 64, 32, False, None, 211),
    "seamless-cross-g1-sq-64-skv-1500": (1, 64, 16, 16, 64, 64, False, None,
                                         1500),
    # MQA at Granite-34B's heads (48/1, hd 128), where every key's dk and dv
    # sum 48 x Sq rows: the static entry's long reductions
    "granite-mqa-sq-1024-skv-4160-not-causal": (1, 1024, 48, 1, 128, 128,
                                                False, None, 4160),
    "granite-mqa-s-1024-causal": (1, 1024, 48, 1, 128, 128, True, None),
}

DECODE_SHAPES = {
    # B, S, H, KV, hd, vd, cache_len
    "qwen2-partial": (8, 1000, 14, 2, 64, 64, 613),
    "qwen2-full": (4, 1024, 14, 2, 64, 64, 1024),
    "mqa": (1, 512, 16, 1, 64, 64, 512),
    "mha-short": (4, 128, 4, 4, 32, 32, 77),
    "vd-ne-hd": (2, 300, 8, 2, 128, 16, 299),
    "one-slot": (3, 256, 6, 2, 16, 32, 1),
    "past-s": (2, 200, 6, 2, 32, 32, 5000),
    "zamba2-hd112": (4, 520, 4, 4, 112, 112, 517),
    "minicpm3-hd96-vd64": (4, 520, 5, 5, 96, 64, 260),
    "mla-smoke-hd24-vd16": (2, 64, 4, 4, 24, 16, 33),
}


def _inputs(shape, seed, *, decode=False, skv=None):
    rng = np.random.default_rng(seed)
    if decode:
        b, s, h, kv, hd, vd, _ = shape
        dims = ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, vd))
    else:
        b, s, h, kv, hd, vd = shape[:6]
        skv = s if skv is None else skv
        dims = ((b, s, h, hd), (b, skv, kv, hd), (b, skv, kv, vd))
    return [torch.from_numpy(rng.standard_normal(d).astype(np.float32))
            for d in dims]


def _softmax_rows(q, k, v, allowed, scale):
    """out[b, i, h] in f64 from a per-row softmax over the allowed keys
    (``allowed(i)`` -> a boolean row over the keys)."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    b, sq, h, _ = q.shape
    g = h // k.shape[2]
    out = np.zeros((b, sq, h, v.shape[-1]))
    for i in range(sq):
        ok = allowed(i)
        for hh in range(h):
            s = (k[:, :, hh // g] @ q[:, i, hh][..., None])[..., 0] * scale
            s = np.where(ok[None], s, -np.inf)
            p = np.exp(s - s.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            out[:, i, hh] = np.einsum("bs,bsd->bd", p, v[:, :, hh // g])
    return out


@pytest.mark.parametrize("name", ["gqa", "mha-window", "vd-ne-hd",
                                  "window-not-causal"])
def test_flash_plain_version_matches_a_row_softmax(name):
    b, s, h, kv, hd, vd, causal, window = FLASH_SHAPES[name]
    q, k, v = _inputs(FLASH_SHAPES[name], 1)
    keys = np.arange(s)

    def allowed(i):
        ok = np.ones(s, bool)
        if causal:
            ok &= keys <= i
        if window is not None:
            ok &= keys > i - window
        return ok

    want = _softmax_rows(q, k, v, allowed, hd ** -0.5)
    got64 = flash_attention_plain(q, k, v, causal=causal, window=window,
                                  q_block=64, kv_block=96,
                                  dtype=torch.float64)
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-10, atol=1e-10)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-partial", "vd-ne-hd", "past-s",
                                  "mha-short"])
def test_decode_plain_version_matches_a_row_softmax(name, dtype):
    """q is scaled in its own dtype and then widened, the model's order,
    so the f64 reference rounds ``scale * q`` to q's dtype too (at hd 128
    and 32 the scale is no power of two and the rounding matters in
    bf16)."""
    b, s, h, kv, hd, vd, clen = DECODE_SHAPES[name]
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt)
               for t in _inputs(DECODE_SHAPES[name], 2, decode=True))
    ok = np.arange(s) < min(clen, s)
    want = _softmax_rows((q * hd ** -0.5).double(), k.double(), v.double(),
                         lambda i: ok, 1.0)
    got64 = decode_attention_plain(q, k, v, clen, dtype=torch.float64)
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-10, atol=1e-10)
    got = decode_attention(q, k, v, torch.tensor(clen, dtype=torch.int32))
    assert got.dtype == dt
    np.testing.assert_allclose(got.double().numpy(), want,
                               **(BF16_TOL if dtype == "bfloat16"
                                  else F32_TOL))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_SHAPES))
def test_flash_kernel_matches_plain_version(cuda_device, name, dtype):
    b, s, h, kv, hd, vd, causal, window = FLASH_SHAPES[name]
    dt = getattr(torch, dtype)
    q, k, v = (t.to(cuda_device, dt) for t in _inputs(FLASH_SHAPES[name], 3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == (b, s, h, vd)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                dtype=torch.float64)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref.cpu().numpy(), **tol)
    # no atomics: a second launch gives the same bits
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_CROSS_CASES))
def test_flash_kernel_with_keys_that_are_not_the_queries(cuda_device, name,
                                                         dtype):
    """Sq queries over Skv keys, as cross attention calls the kernel: in
    f32 and bf16 against the f64 plain version, bitwise across two
    launches."""
    b, s, h, kv, hd, vd, causal, window, skv = FLASH_CROSS_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v = (t.to(cuda_device, dt)
               for t in _inputs(FLASH_CROSS_CASES[name], 13, skv=skv))
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == dt and out.shape == (b, s, h, vd)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                dtype=torch.float64)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref.cpu().numpy(), **tol)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLASH_BF16_CASES))
def test_flash_bf16_kernel_meets_the_smoke_limit(cuda_device, name):
    """The tensor-core kernel in bf16 against the f64 plain version on the
    same bf16 inputs, at ``chip_smoke.py``'s limit (BF16_TOL): every head
    dim pair, G of 1, 7 and 16, causal, not causal and a window of 512, a
    length that is no multiple of the tiles, and a scale of its own."""
    b, s, h, kv, hd, vd, causal, window, scale = FLASH_BF16_CASES[name]
    q, k, v = (t.to(cuda_device, torch.bfloat16)
               for t in _inputs((b, s, h, kv, hd, vd), 9))
    out = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                scale=scale, dtype=torch.float64)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h, vd)
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref.cpu().numpy(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_SHAPES))
def test_decode_kernel_matches_plain_version(cuda_device, name, dtype):
    b, s, h, kv, hd, vd, clen = DECODE_SHAPES[name]
    dt = getattr(torch, dtype)
    q, k, v = (t.to(cuda_device, dt)
               for t in _inputs(DECODE_SHAPES[name], 4, decode=True))
    n = torch.tensor(clen, dtype=torch.int32, device=cuda_device)
    before = decode_attention.launches
    out = decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dt and out.shape == (b, 1, h, vd)
    ref = decode_attention_plain(q, k, v, n, dtype=torch.float64)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref.cpu().numpy(), **tol)
    assert torch.equal(out, decode_attention(q, k, v, n))
    # slots past cache_len do not matter
    if clen < s:
        k2, v2 = k.clone(), v.clone()
        k2[:, clen:] = 99.0
        v2[:, clen:] = -99.0
        assert torch.equal(out, decode_attention(q, k2, v2, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_kernel_on_its_plan_edges(cuda_device, name, dtype):
    """The one-launch decode kernel against the f64 plain version on the
    same inputs: f32 at 1e-5, bf16 at 1e-5 + 5e-3 |ref| (``chip_smoke``'s
    limits), one launch a call and the same bits from a second launch."""
    b, s, h, kv, hd, vd, clen = DECODE_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v = (t.to(cuda_device, dt)
               for t in _inputs(DECODE_CASES[name], 10, decode=True))
    n = torch.tensor(clen, dtype=torch.int32, device=cuda_device)
    before = decode_attention.launches
    out = decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dt and out.shape == (b, 1, h, vd)
    ref = decode_attention_plain(q, k, v, n, dtype=torch.float64)
    np.testing.assert_allclose(out.double().cpu().numpy(), ref.cpu().numpy(),
                               **(BF16_TOL if dtype == "bfloat16"
                                  else F32_TOL))
    assert torch.equal(out, decode_attention(q, k, v, n))


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_cannot_take(cuda_device):
    q, k, v = (t.to(cuda_device) for t in _inputs(FLASH_SHAPES["gqa"], 5))
    bad = [
        (q.double(), k.double(), v.double()),       # f64
        (q, k.to(torch.bfloat16), v),                # mixed dtypes
        (q, k.cpu(), v),                             # mixed devices
        (q[:, ::2], k[:, ::2], v[:, ::2]),            # not contiguous
        (q[..., :48].contiguous(), k[..., :48].contiguous(), v),  # hd 48
    ]
    for args in bad:
        with pytest.raises(ValueError):
            flash_attention(*args)
    qd, kc, vc = (t.to(cuda_device)
                  for t in _inputs(DECODE_SHAPES["mqa"], 6, decode=True))
    with pytest.raises(ValueError, match="cache_len"):
        decode_attention(qd, kc, vc, torch.tensor(3, device=cuda_device))
    with pytest.raises(ValueError, match="cache_len"):
        decode_attention(qd, kc, vc, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_attention(qd, kc[:, ::2], vc[:, ::2], 3)


@pytest.mark.gpu
def test_model_layers_launch_the_kernels(cuda_device, monkeypatch):
    from repro_torch.models import layers as L

    q, k, v = (t.to(cuda_device, torch.bfloat16)
               for t in _inputs(FLASH_SHAPES["qwen2-window"], 7))
    f0, d0 = flash_attention.launches, decode_attention.launches
    out = L.blocked_attention(q, k, v)
    last = L.decode_attention(q[:, -1:].contiguous(), k, v,
                              cache_len=torch.tensor(
                                  k.shape[1], dtype=torch.int32,
                                  device=cuda_device))
    assert (flash_attention.launches, decode_attention.launches) == (
        f0 + 1, d0 + 1)
    monkeypatch.setattr(L, "flash_attention", flash_attention_plain)
    plain = L.blocked_attention(q, k, v)
    monkeypatch.undo()
    assert flash_attention.launches == f0 + 1
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), **BF16_PAIR_TOL)
    np.testing.assert_allclose(last.float().cpu().numpy(),
                               out[:, -1:].float().cpu().numpy(),
                               **BF16_PAIR_TOL)


def _check_grads(got, want, rtol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.double().cpu().numpy(),
                                   w.cpu().numpy(), rtol=rtol,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_bwd_kernel_matches_plain_version(cuda_device, name, dtype):
    """The forward's residuals (lse, f32 output) and the backward's dq, dk,
    dv against their f64 plain versions, bitwise across two launches."""
    b, s, h, kv, hd, vd, causal, window, *skv = FLASH_BWD_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v = (t.to(cuda_device, dt)
               for t in _inputs(FLASH_BWD_CASES[name], 11,
                                skv=skv[0] if skv else None))
    dout = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (b, s, h, vd)).astype(np.float32)).to(cuda_device)
    opts = dict(causal=causal, window=window)
    f0, l0 = flash_attention.launches, flash_attention.lse_launches
    out, lse = flash_attention(q, k, v, return_lse=True, **opts)
    assert (flash_attention.launches, flash_attention.lse_launches) == (
        f0 + 1, l0 + 1)
    assert out.dtype == lse.dtype == torch.float32
    assert torch.equal(out.to(dt), flash_attention(q, k, v, **opts))
    ref_out, ref_lse = flash_attention_plain(q, k, v, dtype=torch.float64,
                                             return_lse=True, **opts)
    np.testing.assert_allclose(lse.double().cpu().numpy(),
                               ref_lse.cpu().numpy(), rtol=1e-5, atol=1e-5)
    out_tol = 1e-5 if dtype == "float32" else 2e-5
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref_out.cpu().numpy(), rtol=out_tol,
                               atol=out_tol)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, **opts)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert all(g.dtype == dt for g in got)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                     dtype=torch.float64, **opts)
    _check_grads(got, want, 1e-5 if dtype == "float32" else 5e-3)
    again = flash_attention_bwd(q, k, v, out, lse, dout, **opts)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


#: the dynamic entries (blocked_attention's dynamic offsets): B, Sq, Skv,
#: H, KV, hd, vd, causal, window, (q_offset, kv_offset, kv_valid_len):
#: rows before every key (q_offset < kv_offset, causal: rows that see no
#: key output 0), the valid length inside a tile and before the first key,
#: key tiles wholly past it, a window, G = 1 and 7, hd 128 MQA
FLASH_DYNAMIC_CASES = {
    "decode-like-g7": (2, 40, 300, 14, 2, 64, 64, True, None,
                       (500, 240, None)),
    "rows-before-keys": (1, 100, 200, 4, 4, 32, 32, True, None,
                         (0, 50, None)),
    "valid-mid-tile-window": (1, 130, 257, 8, 2, 64, 64, True, 40,
                              (400, 300, 520)),
    "valid-before-every-key": (1, 20, 70, 4, 2, 32, 32, False, None,
                               (0, 30, 10)),
    "keys-past-valid-not-causal": (2, 33, 500, 6, 3, 64, 32, False, None,
                                   (7, 0, 130)),
    "mqa-hd128": (1, 65, 190, 48, 1, 128, 128, True, None,
                  (1000, 900, 1085)),
    # offsets that put the first row and the valid length mid-tile (the
    # rows 200 keys on, the last valid key 253), G = 6 at hd 128
    "offsets-mid-tile-g6-hd128": (1, 90, 300, 12, 2, 128, 128, True, None,
                                  (237, 37, 290)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_DYNAMIC_CASES))
def test_flash_dynamic_entries_match_plain_version(cuda_device, name, dtype):
    """The dynamic entries, offsets as int32 tensors on the card, against
    the plain version with the same offsets in f64: the forward's f32
    output and lse, the backward's gradients, and the layer's call under
    autograd bitwise the wrappers'."""
    from repro_torch.models import layers as L

    b, sq, skv, h, kv, hd, vd, causal, window, offs = (
        FLASH_DYNAMIC_CASES[name])
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
               .to(cuda_device, dt) for d in ((b, sq, h, hd),
                                              (b, skv, kv, hd),
                                              (b, skv, kv, vd)))
    # dO as the layer's backward gets it: the gradient of its output, in
    # q's dtype, widened
    dout = torch.from_numpy(rng.standard_normal((b, sq, h, vd)).astype(
        np.float32)).to(cuda_device, dt).float()
    offsets = FA.Offsets(*(None if x is None else torch.tensor(
        x, dtype=torch.int32, device=cuda_device) for x in offs))
    # the layer's tiles (the kernel has its own; its plain version's
    # answer depends on them in the last bits)
    opts = dict(causal=causal, window=window, q_block=512, kv_block=1024)
    f0 = FA.flash_attention_dynamic.launches
    out, lse = FA.flash_attention_dynamic(q, k, v, offsets, **opts)
    assert FA.flash_attention_dynamic.launches == f0 + 1
    ref_out, ref_lse = flash_attention_plain(
        q, k, v, dtype=torch.float64, return_lse=True, offsets=offsets,
        **opts)
    np.testing.assert_allclose(lse.double().cpu().numpy(),
                               ref_lse.cpu().numpy(), rtol=1e-5, atol=1e-5)
    out_tol = 1e-5 if dtype == "float32" else 2e-5
    np.testing.assert_allclose(out.double().cpu().numpy(),
                               ref_out.cpu().numpy(), rtol=out_tol,
                               atol=out_tol)
    b0 = FA.flash_attention_bwd_dynamic.launches
    got = FA.flash_attention_bwd_dynamic(q, k, v, out, lse, dout, offsets,
                                         **opts)
    assert FA.flash_attention_bwd_dynamic.launches == b0 + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                     dtype=torch.float64, offsets=offsets,
                                     **opts)
    _check_grads(got, want, 1e-5 if dtype == "float32" else 5e-3)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    layer = L.blocked_attention(qg, kg, vg, q_offset=offsets.q_offset,
                                kv_offset=offsets.kv_offset,
                                kv_valid_len=offsets.kv_valid_len,
                                causal=causal, window=window)
    layer.backward(dout.to(dt))
    assert torch.equal(layer, out.to(dt))
    assert all(torch.equal(t.grad, g) for t, g in zip((qg, kg, vg), got))


@pytest.mark.gpu
def test_flash_bwd_wrapper_rejects_what_it_cannot_take(cuda_device,
                                                     monkeypatch):
    q, k, v = (t.to(cuda_device) for t in _inputs(FLASH_SHAPES["gqa"], 13))
    out, lse = flash_attention(q, k, v, return_lse=True)
    dout = torch.ones_like(out)
    bad = [
        (q, k, v, out.to(torch.bfloat16), lse, dout),   # residual dtype
        (q, k, v, out, lse, dout.cpu()),                 # mixed devices
        (q, k, v, out, lse[:, :, ::2], dout),            # lse shape
        (q[:, ::2], k[:, ::2], v[:, ::2], out[:, ::2], lse[:, :, ::2],
         dout[:, ::2]),                                  # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            flash_attention_bwd(*args)
    # a pair the kernels are not built for raises, without a plain call
    hd = vd = 48
    assert (hd, vd) not in HEAD_DIM_PAIRS
    q, k, v = (t.to(cuda_device) for t in _inputs((1, 64, 2, 2, hd, vd), 15))
    out = torch.zeros((1, 64, 2, vd), device=cuda_device)
    lse = torch.zeros((1, 2, 64), device=cuda_device)

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain backward")

    monkeypatch.setattr(FA, "flash_attention_bwd_plain", no_plain)
    with pytest.raises(ValueError, match="hd=48, vd=48"):
        flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))


@pytest.mark.gpu
def test_training_call_launches_the_backward_kernel(cuda_device):
    """blocked_attention under autograd: one forward launch with lse, and
    one backward call in the backward pass, whose gradients match autograd
    through the plain version."""
    from repro_torch.models import layers as L

    q, k, v = (t.to(cuda_device, torch.bfloat16).requires_grad_()
               for t in _inputs(FLASH_SHAPES["qwen2-window"], 14))
    l0, b0 = flash_attention.lse_launches, flash_attention_bwd.launches
    out = L.blocked_attention(q, k, v, window=100)
    assert flash_attention.lse_launches == l0 + 1
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert flash_attention_bwd.launches == b0 + 1
    plain = flash_attention_plain(q, k, v, window=100)
    want = torch.autograd.grad(plain, (q, k, v), g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.float().cpu().numpy(),
                                   y.float().cpu().numpy(), rtol=2e-2,
                                   atol=1e-2 * float(y.abs().max()))
