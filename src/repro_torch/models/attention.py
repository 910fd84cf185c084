"""GQA/MQA attention blocks (optional sliding window and QKV bias): the port
of the GQA half of ``repro.models.attention``.

- ``gqa_full``: full-sequence attention (forward, prefill);
- ``gqa_prefill``: the prompt's attention plus its KV cache;
- ``gqa_decode``: one token against the cache, which it updates in place.

A cache is ``{"k": (B, size, KV, hd), "v": ...}``: linear (size =
``max_len``), or a ring of ``min(max_len, sliding_window)`` slots under a
sliding window (slot = position % size).  MLA waits for its ROADMAP entry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, blocked_attention,
                                       decode_attention, rope_cos_sin)
from repro_torch.models.params import NOT_PORTED_ENTRY


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


def mla_full(*args, **kwargs):
    raise NotImplementedError(f"MLA attention is not ported yet "
                              f"({NOT_PORTED_ENTRY})")


mla_init_cache = mla_prefill = mla_decode = mla_full
