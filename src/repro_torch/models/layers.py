"""Layer primitives: norms, RoPE, MLPs and the two attention calls.

The port of ``repro.models.layers``, with the reference's rounding order:
norms normalise in f32 and cast back before the scale, RoPE rotates in f32,
each weight is cast to the activation dtype at its use (a no-op once the
weights are held in that dtype, see ``params.cast_params``).

Every attention call of the model goes through one of two hand-written
CUDA kernels on the card: :func:`blocked_attention` (prefill and
full-sequence) launches ``kernels/flash_attention``, :func:`decode_attention`
(one token against a cache) launches ``kernels/decode_attention``.  On CPU
tensors both take the kernels' plain versions.  A training call of
:func:`blocked_attention` goes through the flash kernel's autograd
function, whose backward is the flash backward kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention as decode_attention_kernel)
from repro_torch.kernels.flash_attention.kernel import (
    Offsets, flash_attention, flash_attention_differentiable,
    flash_attention_dynamic)
from repro_torch.sharding.rules import ws


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10_000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions int[...]; cos/sin of shape positions.shape + (hd/2,), f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    # a Python base keeps theta off the host-to-device path (and out of a
    # captured CUDA graph's way); theta^x is still computed in f32
    freqs = 1.0 / torch.pow(float(theta), exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd/2) broadcast over heads;
    rotates in the cos/sin dtype (f32)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(cos.dtype)
    x2 = x[..., half:].to(cos.dtype)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def blocked_attention(
    q: torch.Tensor,                 # (B, Sq, H, hd)
    k: torch.Tensor,                 # (B, Skv, KV, hd)
    v: torch.Tensor,                 # (B, Skv, KV, vd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,                      # int or 0-d int tensor: q[0]'s position
    kv_offset=0,                     # int or 0-d int tensor: k[0]'s position
    kv_valid_len: Optional[torch.Tensor] = None,  # keys at >= this masked
    q_block: int = 512,
    kv_block: int = 1024,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention with GQA, causal and window masks; returns (B, Sq, H,
    vd) in q's dtype with f32 accumulation.  At static zero offsets (every
    model call) it is one launch of the flash kernel on the card;
    ``q_block``/``kv_block`` tile its plain version.

    ``q_offset``, ``kv_offset`` (Python ints or 0-d int tensors on q's
    device) and ``kv_valid_len`` (a 0-d int tensor) take the reference's
    dynamic path (``_blocked_attention_ref``): query ``i`` at ``q_offset +
    i``, key ``j`` at ``kv_offset + j``, the masks on those positions and
    keys at ``kv_offset + j >= kv_valid_len`` masked.  On the card that is
    one launch of the flash kernel's dynamic entry, which reads the offsets
    there (no host read).  Only the keys past Skv are masked as padding:
    the reference also masks the last ``kv_offset`` real keys when Skv is
    no multiple of ``kv_block``, which the port does not copy (ROADMAP
    queue 3 item 15); and a row that sees no key outputs 0.

    Where autograd records (grad enabled, and q, k or v requires grad) the
    call goes through :class:`FlashAttention`, as the reference's static
    path goes through its ``custom_vjp``: the forward keeps its f32 output
    and log-sum-exp, the cast to q's dtype comes after, and the backward
    is the flash backward kernel (its dynamic entry at dynamic offsets).
    Otherwise a static launch writes no log-sum-exp."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    opts = dict(causal=causal, window=window, scale=softmax_scale,
                q_block=q_block, kv_block=kv_block)
    static = (isinstance(q_offset, int) and q_offset == 0
              and isinstance(kv_offset, int) and kv_offset == 0
              and kv_valid_len is None)
    offsets = None if static else Offsets(q_offset, kv_offset, kv_valid_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_differentiable(
            q, k, v, offsets=offsets, **opts).to(q.dtype)
    if static:
        return flash_attention(q, k, v, **opts)
    return flash_attention_dynamic(q, k, v, offsets, **opts)[0].to(q.dtype)


def decode_attention(
    q: torch.Tensor,                 # (B, 1, H, hd), the new token
    k_cache: torch.Tensor,           # (B, S_cache, KV, hd)
    v_cache: torch.Tensor,
    *,
    cache_len,                       # int32 scalar tensor or int: valid slots
) -> torch.Tensor:
    """One-token attention over a (possibly ring-buffered) KV cache: slots
    at or past ``min(cache_len, S)`` are masked; a ring cache is
    window-sized, so every filled slot is attendable.  As the reference,
    q is scaled by ``hd^-0.5`` in its own dtype before it is widened (the
    kernel does that as it loads q); on the card this is one launch of the
    decode kernel."""
    return decode_attention_kernel(q.contiguous(), k_cache.contiguous(),
                                   v_cache.contiguous(), cache_len)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = ws(F.silu(g) * u, "batch", "ctx", "ff")
    return h @ w_down.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = ws(F.gelu(x @ w_up.to(x.dtype), approximate="tanh"), "batch", "ctx",
           "ff")
    return h @ w_down.to(x.dtype)


def mlp_apply_dense(p, x: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(x, p["w_up"], p["w_down"])
