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
from repro_torch.sharding import per_shard as PS


def _project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig):
    """q, k, v with their heads fused: (B, S, H·hd), (B, S, KV·hd) x2."""
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _heads(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, S, n·d) -> (B, S, n, d), on the heads a shard holds."""
    return t.reshape(t.shape[0], t.shape[1], -1, head_dim)


def _rope_qk(q, k, positions, cfg: ModelConfig):
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None]


def head_specs(cfg: ModelConfig, x: torch.Tensor, kv_heads: int):
    """``(fused, per-head)`` specs of an attention region on DTensor ``x``
    (batch over ``batch``, heads over ``heads`` where ``kv_heads``
    divides): the fused ``(B, S, n·d)`` spec and the ``(B, S, n, d)`` one;
    ``(None, None)`` on a plain tensor."""
    mesh = PS.mesh_of(x)
    if mesh is None:
        return None, None
    spec = PS.head_spec(mesh, x.shape[0], kv_heads)
    return spec, (spec[0], None, spec[2], None)


def _gqa_local(cfg: ModelConfig, causal: bool):
    """The per-shard GQA attention of fused q, k, v (B, S, n·hd): heads,
    RoPE over positions 0..S-1 (or ``positions``), the flash call, heads
    fused again."""
    hd = cfg.resolved_head_dim

    def attend(q, k, v, positions=None):
        if positions is None:
            positions = _positions(q.shape[1], q.device)
        q, k = _rope_qk(_heads(q, hd), _heads(k, hd), positions, cfg)
        out = blocked_attention(q, k, _heads(v, hd), causal=causal,
                                window=cfg.sliding_window,
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
        return out.reshape(out.shape[0], out.shape[1], -1)
    return attend


def gqa_full(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
             *, positions: Optional[torch.Tensor] = None,
             causal: bool = True) -> torch.Tensor:
    q, k, v = _project_qkv(p, x, cfg)
    spec, _ = head_specs(cfg, x, cfg.num_kv_heads)
    out = PS.run(_gqa_local(cfg, causal), (q, k, v, positions),
                 (spec, spec, spec, None), spec)
    return out @ p["wo"].to(x.dtype)


def cache_size(cfg: ModelConfig, max_len: int) -> int:
    """Slots of one layer's cache: ``max_len``, or the window for a ring."""
    return (max_len if cfg.sliding_window is None
            else min(max_len, cfg.sliding_window))


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16,
                   device=None, kv_heads: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Linear cache, or ring cache of window size under sliding-window
    (of ``kv_heads`` heads, by default all of them)."""
    shape = (batch, cache_size(cfg, max_len),
             cfg.num_kv_heads if kv_heads is None else kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, cache_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention over the prompt, and its cache of ``cache_len``
    slots (the window's under a sliding window)."""
    hd = cfg.resolved_head_dim

    def attend(q, k, v):
        b, s, _ = q.shape
        q, k = _rope_qk(_heads(q, hd), _heads(k, hd),
                        _positions(s, q.device), cfg)
        v = _heads(v, hd)
        out = blocked_attention(q, k, v, causal=True,
                                window=cfg.sliding_window,
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
        cache = gqa_init_cache(cfg, b, cache_len, dtype=k.dtype,
                               device=q.device, kv_heads=k.shape[2])
        size = cache["k"].shape[1]
        if cfg.sliding_window is None or s <= size:
            cache["k"][:, :s] = k[:, :size]
            cache["v"][:, :s] = v[:, :size]
        else:
            # ring cache: keep the last `size` positions, slot = pos % size
            idx = torch.arange(s - size, s, device=q.device) % size
            cache["k"][:, idx] = k[:, s - size:]
            cache["v"][:, idx] = v[:, s - size:]
        return out.reshape(b, s, -1), cache["k"], cache["v"]

    q, k, v = _project_qkv(p, x, cfg)
    spec, spec4 = head_specs(cfg, x, cfg.num_kv_heads)
    out, ck, cv = PS.run(attend, (q, k, v), (spec, spec, spec),
                         [spec, spec4, spec4])
    return out @ p["wo"].to(x.dtype), {"k": ck, "v": cv}


def _decode_slot(pos: torch.Tensor, size: int,
                 ring: bool) -> torch.Tensor:
    """The cache slot of a token at ``pos``: a ring writes slot pos %
    size, a linear cache clamps to its last slot as the reference's
    dynamic_update_slice does."""
    return (pos % size if ring else torch.clamp(pos, max=size - 1)
            ).reshape(1).long()


def gqa_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token ``x`` (B, 1, d) at absolute position ``pos`` (an int32
    scalar tensor on x's device): writes its K/V into ``cache`` in place
    and attends over the filled slots; no host sync."""
    hd = cfg.resolved_head_dim

    def attend(q, k, v, k_cache, v_cache, pos):
        b = q.shape[0]
        q, k = _rope_qk(_heads(q, hd), _heads(k, hd), pos.reshape(1, 1),
                        cfg)
        slot = _decode_slot(pos, k_cache.shape[1],
                            cfg.sliding_window is not None)
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, _heads(v, hd).to(v_cache.dtype))
        out = decode_attention(q, k_cache, v_cache,
                               cache_len=(pos + 1).to(torch.int32))
        return out.reshape(b, 1, -1)

    q, k, v = _project_qkv(p, x, cfg)
    spec, spec4 = head_specs(cfg, x, cfg.num_kv_heads)
    mesh = PS.mesh_of(x)
    k_cache, k_back = PS.held_as(cache["k"], spec4, mesh)
    v_cache, v_back = PS.held_as(cache["v"], spec4, mesh)
    out = PS.run(attend, (q, k, v, k_cache, v_cache, pos),
                 (spec, spec, spec, spec4, spec4, ()), spec)
    k_back()
    v_back()
    return out @ p["wo"].to(x.dtype), cache


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


def _mla_q_fused(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q with its heads fused, (B, S, H·(nope + rope))."""
    qa = rms_norm(x @ p["q_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    return qa @ p["q_b"].to(x.dtype)


def _mla_split_q(q: torch.Tensor, cfg: ModelConfig):
    """(q_nope, q_rope) of a fused q, on the heads a shard holds."""
    m = cfg.mla
    return _heads(q, m.qk_nope_head_dim + m.qk_rope_head_dim).split(
        [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)


def _mla_project_q(p, x: torch.Tensor, cfg: ModelConfig):
    """(q_nope, q_rope), (B, S, H, nope) and (B, S, H, rope)."""
    return _mla_split_q(_mla_q_fused(p, x, cfg), cfg)


def _mla_latent(p, x: torch.Tensor, cfg: ModelConfig):
    """(latent, k_rope), (B, S, r) normed and (B, S, rope) before RoPE."""
    m = cfg.mla
    kv = x @ p["kv_a"].to(x.dtype)
    latent = rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    return latent, kv[..., m.kv_lora_rank:]


def _mla_split_kv(kvb: torch.Tensor, cfg: ModelConfig):
    """(k_nope, v) of the fused expansion, on the heads a shard holds."""
    m = cfg.mla
    return _heads(kvb, m.qk_nope_head_dim + m.v_head_dim).split(
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def _mla_expand_kv(p, latent: torch.Tensor, cfg: ModelConfig):
    """(k_nope, v), (B, S, H, nope) and (B, S, H, v_head)."""
    return _mla_split_kv(latent @ p["kv_b"].to(latent.dtype), cfg)


def _mla_rope_k(k_rope, cos, sin):
    """RoPE on the one shared rope key (B, S, rope)."""
    return apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]


def _mla_rope(q_rope, k_rope, positions, cfg: ModelConfig):
    """RoPE on q's rope part (B, S, H, rope) and on the one shared rope key
    (B, S, rope)."""
    cos, sin = rope_cos_sin(positions, cfg.mla.qk_rope_head_dim,
                            cfg.rope_theta)
    return apply_rope(q_rope, cos, sin), _mla_rope_k(k_rope, cos, sin)


def _mla_qk(q_nope, q_rope, k_nope, k_rope):
    """q (B, Sq, H, nope + rope) and k (B, Skv, H, nope + rope), the shared
    rope key broadcast to every head."""
    k_rope = k_rope[:, :, None].expand(*k_nope.shape[:3], k_rope.shape[-1])
    return (torch.cat([q_nope, q_rope], dim=-1),
            torch.cat([k_nope, k_rope], dim=-1))


def _mla_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _mla_local(cfg: ModelConfig, causal: bool):
    """The per-shard MLA attention of the fused q (B, S, H·(nope + rope)),
    the fused expansion (B, S, H·(nope + v)) and the raw rope key (B, S,
    rope): returns (output (B, S, H·v), the rope key after RoPE)."""
    def attend(q, kvb, k_rope, positions=None):
        b, s, _ = q.shape
        if positions is None:
            positions = _positions(s, q.device)
        q_nope, q_rope = _mla_split_q(q, cfg)
        k_nope, v = _mla_split_kv(kvb, cfg)
        q_rope, k_rope = _mla_rope(q_rope, k_rope, positions, cfg)
        q, k = _mla_qk(q_nope, q_rope, k_nope, k_rope)
        out = blocked_attention(q, k, v, causal=causal,
                                softmax_scale=_mla_scale(cfg),
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
        return out.reshape(b, s, -1), k_rope
    return attend


def _mla_specs(cfg: ModelConfig, x: torch.Tensor):
    """(heads spec, batch-only spec) of an MLA region (``(None, None)`` on
    a plain tensor); every tensor of the region has H heads."""
    spec, _ = head_specs(cfg, x, cfg.sharded_heads)
    return spec, None if spec is None else (spec[0],)


def mla_full(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
             *, positions: Optional[torch.Tensor] = None,
             causal: bool = True) -> torch.Tensor:
    latent, k_rope = _mla_latent(p, x, cfg)
    q = _mla_q_fused(p, x, cfg)
    kvb = latent @ p["kv_b"].to(latent.dtype)
    spec, bspec = _mla_specs(cfg, x)
    out, _ = PS.run(_mla_local(cfg, causal), (q, kvb, k_rope, positions),
                    (spec, spec, bspec, None), [spec, bspec])
    return out @ p["wo"].to(x.dtype)


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
    attend = _mla_local(cfg, True)

    def prefill(q, kvb, k_rope, latent):
        b, s, _ = q.shape
        out, k_rope = attend(q, kvb, k_rope)
        cache = mla_init_cache(cfg, b, cache_len, device=q.device)
        n = min(s, cache_len)
        cache["latent"][:, :n] = latent[:, :n]
        cache["k_rope"][:, :n] = k_rope[:, :n]
        return out, cache["latent"], cache["k_rope"]

    latent, k_rope = _mla_latent(p, x, cfg)
    q = _mla_q_fused(p, x, cfg)
    kvb = latent @ p["kv_b"].to(latent.dtype)
    spec, bspec = _mla_specs(cfg, x)
    out, c_latent, c_rope = PS.run(prefill, (q, kvb, k_rope, latent),
                                   (spec, spec, bspec, bspec),
                                   [spec, bspec, bspec])
    return out @ p["wo"].to(x.dtype), {"latent": c_latent,
                                       "k_rope": c_rope}


def mla_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token ``x`` (B, 1, d) at absolute position ``pos`` (an int32
    scalar tensor on x's device): writes its latent and rope key into
    ``cache`` in place, then, as the reference's naive decode, expands K
    and V of every slot from the cached latent (widened to x's dtype) and
    attends over the filled ones; no host sync."""
    rope_dim = cfg.mla.qk_rope_head_dim

    def write(c_latent, c_rope, latent_new, k_rope_new, pos):
        cos, sin = rope_cos_sin(pos.reshape(1, 1), rope_dim, cfg.rope_theta)
        # the last slot takes a position past the cache, as the
        # reference's dynamic_update_slice clamps
        slot = _decode_slot(pos, c_latent.shape[1], False)
        c_latent.index_copy_(1, slot, latent_new.to(c_latent.dtype))
        c_rope.index_copy_(1, slot, _mla_rope_k(k_rope_new, cos, sin
                                                ).to(c_rope.dtype))

    def attend(q, kvb, c_rope, pos):
        b = q.shape[0]
        cos, sin = rope_cos_sin(pos.reshape(1, 1), rope_dim, cfg.rope_theta)
        q_nope, q_rope = _mla_split_q(q, cfg)
        k_nope, v = _mla_split_kv(kvb, cfg)
        q, k = _mla_qk(q_nope, apply_rope(q_rope, cos, sin), k_nope,
                       c_rope.to(q.dtype))
        # decode_attention's default hd^-0.5 is (nope + rope)^-0.5 here
        out = decode_attention(q, k, v, cache_len=(pos + 1).to(torch.int32))
        return out.reshape(b, 1, -1)

    q = _mla_q_fused(p, x, cfg)                          # (B, 1, H·.)
    latent_new, k_rope_new = _mla_latent(p, x, cfg)      # (B, 1, r), (B, 1, .)
    spec, bspec = _mla_specs(cfg, x)
    c_spec = None if bspec is None else bspec + (None, None)
    mesh = PS.mesh_of(x)
    c_latent, latent_back = PS.held_as(cache["latent"], c_spec, mesh)
    c_rope, rope_back = PS.held_as(cache["k_rope"], c_spec, mesh)
    PS.run(write, (c_latent, c_rope, latent_new, k_rope_new, pos),
           (c_spec, c_spec, bspec, bspec, ()), [None])
    kvb = c_latent.to(x.dtype) @ p["kv_b"].to(x.dtype)
    out = PS.run(attend, (q, kvb, c_rope, pos), (spec, spec, c_spec, ()),
                 spec)
    latent_back()
    rope_back()
    return out @ p["wo"].to(x.dtype), cache
