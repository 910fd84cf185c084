"""Attention blocks: GQA/MQA (optional sliding window and QKV bias) and
MLA (multi-head latent attention, MiniCPM3-style), the port of
``repro.models.attention``.

- ``gqa_full`` / ``mla_full``: full-sequence attention (forward, prefill);
- ``gqa_prefill`` / ``mla_prefill``: the prompt's attention plus its cache;
- ``gqa_decode`` / ``mla_decode``: one token against the cache, which it
  updates in place.

A GQA cache is ``{"k": (B, size, KV, hd), "v": ...}``: linear (size =
``max_len``), or a ring of ``min(max_len, sliding_window)`` slots under a
sliding window (slot = position % size).  An MLA cache is the rank-r latent
and the one rope key shared by the heads, ``{"latent": (B, max_len, r),
"k_rope": (B, max_len, rope)}``, in bf16 whatever the activation dtype, as
the reference keeps it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, blocked_attention,
                                       decode_attention, rms_norm,
                                       rope_cos_sin)


def _project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd),
            v.reshape(b, s, kv, hd))


def _rope_qk(q, k, positions, cfg: ModelConfig):
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _attend(p, q, k, v, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    b, s = q.shape[:2]
    out = blocked_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                            q_block=cfg.q_block, kv_block=cfg.kv_block)
    return out.reshape(b, s, -1) @ p["wo"].to(q.dtype)


def gqa_full(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
             *, positions: Optional[torch.Tensor] = None,
             causal: bool = True) -> torch.Tensor:
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k = _rope_qk(q, k, positions, cfg)
    return _attend(p, q, k, v, cfg, causal)


def cache_size(cfg: ModelConfig, max_len: int) -> int:
    """Slots of one layer's cache: ``max_len``, or the window for a ring."""
    return (max_len if cfg.sliding_window is None
            else min(max_len, cfg.sliding_window))


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """Linear cache, or ring cache of window size under sliding-window."""
    shape = (batch, cache_size(cfg, max_len), cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, cache_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention over the prompt, and its cache of ``cache_len``
    slots (the window's under a sliding window)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k = _rope_qk(q, k, positions, cfg)
    out = _attend(p, q, k, v, cfg, True)
    cache = gqa_init_cache(cfg, b, cache_len, dtype=k.dtype, device=x.device)
    size = cache["k"].shape[1]
    if cfg.sliding_window is None or s <= size:
        cache["k"][:, :s] = k[:, :size]
        cache["v"][:, :s] = v[:, :size]
    else:
        # ring cache: keep the last `size` positions, slot = pos % size
        idx = torch.arange(s - size, s, device=x.device) % size
        cache["k"][:, idx] = k[:, s - size:]
        cache["v"][:, idx] = v[:, s - size:]
    return out, cache


def gqa_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token ``x`` (B, 1, d) at absolute position ``pos`` (an int32
    scalar tensor on x's device): writes its K/V into ``cache`` in place
    and attends over the filled slots; no host sync."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, pos.reshape(1, 1), cfg)
    size = cache["k"].shape[1]
    # a ring writes slot pos % size; a linear cache clamps to its last slot
    # as the reference's dynamic_update_slice does
    slot = (pos % size if cfg.sliding_window is not None
            else torch.clamp(pos, max=size - 1)).reshape(1).long()
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    out = decode_attention(q, cache["k"], cache["v"],
                           cache_len=(pos + 1).to(torch.int32))
    return out.reshape(b, 1, -1) @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style latent attention)
# ---------------------------------------------------------------------------
#
# q = W_qb · rmsnorm(W_qa · x)            split into (nope, rope) per head
# kv_latent = rmsnorm(W_kva · x [: r])    cached (rank r)  + k_rope (shared)
# k,v = W_kvb · kv_latent                 expanded per step (naive decoding)
#
# Heads are ``cfg.sharded_heads`` (the padded count, where one is set); the
# attention's head dim is qk_nope + qk_rope and its value dim v_head, never
# ``cfg.resolved_head_dim``.


def _mla_project_q(p, x: torch.Tensor, cfg: ModelConfig):
    """(q_nope, q_rope), (B, S, H, nope) and (B, S, H, rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    qa = rms_norm(x @ p["q_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (qa @ p["q_b"].to(x.dtype)).reshape(
        b, s, cfg.sharded_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    return q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)


def _mla_latent(p, x: torch.Tensor, cfg: ModelConfig):
    """(latent, k_rope), (B, S, r) normed and (B, S, rope) before RoPE."""
    m = cfg.mla
    kv = x @ p["kv_a"].to(x.dtype)
    latent = rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    return latent, kv[..., m.kv_lora_rank:]


def _mla_expand_kv(p, latent: torch.Tensor, cfg: ModelConfig):
    """(k_nope, v), (B, S, H, nope) and (B, S, H, v_head)."""
    m = cfg.mla
    b, s, _ = latent.shape
    kvb = (latent @ p["kv_b"].to(latent.dtype)).reshape(
        b, s, cfg.sharded_heads, m.qk_nope_head_dim + m.v_head_dim)
    return kvb.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def _mla_rope(q_rope, k_rope, positions, cfg: ModelConfig):
    """RoPE on q's rope part (B, S, H, rope) and on the one shared rope key
    (B, S, rope)."""
    cos, sin = rope_cos_sin(positions, cfg.mla.qk_rope_head_dim,
                            cfg.rope_theta)
    return (apply_rope(q_rope, cos, sin),
            apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :])


def _mla_qk(q_nope, q_rope, k_nope, k_rope):
    """q (B, Sq, H, nope + rope) and k (B, Skv, H, nope + rope), the shared
    rope key broadcast to every head."""
    k_rope = k_rope[:, :, None].expand(*k_nope.shape[:3], k_rope.shape[-1])
    return (torch.cat([q_nope, q_rope], dim=-1),
            torch.cat([k_nope, k_rope], dim=-1))


def _mla_out(p, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"].to(out.dtype)


def _mla_attend(p, x, latent, k_rope, positions, cfg: ModelConfig,
                causal: bool):
    """The full-sequence attention of x from its latent and raw rope key;
    returns (output, the rope key after RoPE)."""
    m = cfg.mla
    q_nope, q_rope = _mla_project_q(p, x, cfg)
    k_nope, v = _mla_expand_kv(p, latent, cfg)
    q_rope, k_rope = _mla_rope(q_rope, k_rope, positions, cfg)
    q, k = _mla_qk(q_nope, q_rope, k_nope, k_rope)
    out = blocked_attention(
        q, k, v, causal=causal,
        softmax_scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5,
        q_block=cfg.q_block, kv_block=cfg.kv_block)
    return _mla_out(p, out, cfg), k_rope


def mla_full(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
             *, positions: Optional[torch.Tensor] = None,
             causal: bool = True) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None]
    latent, k_rope = _mla_latent(p, x, cfg)
    return _mla_attend(p, x, latent, k_rope, positions, cfg, causal)[0]


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """The rank-r latent and the shared rope key of every slot: r + rope
    values a token instead of 2 H hd."""
    m = cfg.mla
    return {"latent": torch.zeros((batch, max_len, m.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, cache_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention over the prompt, and its bf16 cache of
    ``cache_len`` slots (the latent is computed once; the reference
    computes it twice, the same values)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    latent, k_rope = _mla_latent(p, x, cfg)
    out, k_rope = _mla_attend(p, x, latent, k_rope, positions, cfg, True)
    cache = mla_init_cache(cfg, b, cache_len, device=x.device)
    n = min(s, cache_len)
    cache["latent"][:, :n] = latent[:, :n]
    cache["k_rope"][:, :n] = k_rope[:, :n]
    return out, cache


def mla_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token ``x`` (B, 1, d) at absolute position ``pos`` (an int32
    scalar tensor on x's device): writes its latent and rope key into
    ``cache`` in place, then, as the reference's naive decode, expands K
    and V of every slot from the cached latent (widened to x's dtype) and
    attends over the filled ones; no host sync."""
    q_nope, q_rope = _mla_project_q(p, x, cfg)           # (B, 1, H, .)
    latent_new, k_rope_new = _mla_latent(p, x, cfg)      # (B, 1, r), (B, 1, .)
    q_rope, k_rope_new = _mla_rope(q_rope, k_rope_new, pos.reshape(1, 1),
                                   cfg)
    # the last slot takes a position past the cache, as the reference's
    # dynamic_update_slice clamps
    slot = torch.clamp(pos, max=cache["latent"].shape[1] - 1).reshape(
        1).long()
    cache["latent"].index_copy_(1, slot,
                                latent_new.to(cache["latent"].dtype))
    cache["k_rope"].index_copy_(1, slot,
                                k_rope_new.to(cache["k_rope"].dtype))
    k_nope, v = _mla_expand_kv(p, cache["latent"].to(x.dtype), cfg)
    q, k = _mla_qk(q_nope, q_rope, k_nope, cache["k_rope"].to(x.dtype))
    # decode_attention's default hd^-0.5 is (nope + rope)^-0.5 here
    out = decode_attention(q, k, v, cache_len=(pos + 1).to(torch.int32))
    return _mla_out(p, out, cfg), cache
