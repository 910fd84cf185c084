"""Model assembly for every family of the reference: the port of
``repro.models.transformer``.

- ``lm_forward``: full-sequence logits (training, eval; ``remat=True``
  recomputes each block in the backward);
- ``lm_prefill``: prompt -> (full logits, KV caches);
- ``lm_decode_step``: one token against the caches (serving);
- ``encode``: an encoder-decoder's encoder over its frame embeddings.

Per-layer weights stay stacked on a leading L axis, as in the reference;
the layer loop is a Python loop over views of them.  Caches are stacked
the same way (``{"kv": {"k": (L, B, size, KV, hd), "v": ...}}``; MLA's
``{"mla": {"latent": (L, B, max_len, r), "k_rope": ...}}`` in bf16; an
SSM's ``{"ssm": {"conv": (L, B, k-1, conv_dim), "ssm": (L, B, H, P, N)}}``
in f32), and a decode step updates them in place.  An MoE block is a dense
block whose MLP is ``moe.moe_mlp``.  A hybrid model is the SSM stack with
one shared attention + MLP block (``params["shared"]``) applied after
every ``hybrid_period``-th layer: ``L // hybrid_period`` applications of
the one weight set, each with its own KV cache (``{"ssm": ..., "attn":
{"k": (apps, B, size, KV, hd), "v": ...}}``).

The modality frontends are stubs, as in the reference: precomputed
embeddings come in with the tokens.  A vision model (a dense model with
``cfg.frontend == "vision"``) takes ``prefix_embeds`` (B, P, d), put
before the token embeddings, so its logits and caches cover P + S
positions.  An encoder-decoder takes ``encoder_embeds`` (B, S_enc, d):
:func:`encode` runs them through a bidirectional stack, and each decoder
block attends causally over the tokens, then across to the encoder's
output (``_cross_attend``), then runs its MLP.  Its caches are ``{"self":
{"k", "v": (L, B, size, KV, hd)}, "cross": {"k", "v": (L, B, S_enc, KV,
hd)}}``: the cross keys and values are projected once at prefill, kept in
bf16, and read unchanged by every decode step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (blocked_attention, decode_attention,
                                       mlp_apply_dense, rms_norm)
from repro_torch.models.moe import moe_mlp
from repro_torch.models.params import require_ported


def _layers(params: Dict[str, Any], cfg: ModelConfig,
            stack: str = "blocks") -> List[Dict[str, Any]]:
    """One tree of views ``params[stack][...][l]`` per layer (of the
    decoder's ``blocks``, or of an encoder-decoder's ``encoder``), from one
    ``unbind`` of each stacked leaf (whose backward stacks the layers'
    gradients in one copy, where indexing would add a zero-filled stack
    per layer)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, l):
        return {k: pick(v, l) if isinstance(v, dict) else v[l]
                for k, v in tree.items()}
    per_layer = split(params[stack])
    n = cfg.encoder_layers if stack == "encoder" else cfg.num_layers
    return [pick(per_layer, l) for l in range(n)]


def _at(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Entry ``i`` of each stacked cache leaf (views, updated in place)."""
    return {name: t[i] for name, t in tree.items()}


def _shared_after(cfg: ModelConfig, l: int) -> bool:
    """Whether a hybrid model applies its shared block after layer ``l``:
    after every ``hybrid_period``-th layer, none after the tail."""
    return cfg.family == "hybrid" and (l + 1) % cfg.hybrid_period == 0


def attention_calls(cfg: ModelConfig, *, decode: bool = False) -> int:
    """Attention calls of one pass of the model: a forward or prefill, or
    with ``decode`` a decode step.  One per layer, a hybrid's one per
    application of its shared block, none in an SSM; an encoder-decoder's
    self and cross calls per decoder layer and, but in a decode step, one
    per encoder layer.  Each call but an encoder's and a cross call has a
    self cache of its own."""
    if cfg.encoder_layers > 0:
        return 2 * cfg.num_layers + (0 if decode else cfg.encoder_layers)
    if cfg.family == "hybrid":
        return sum(_shared_after(cfg, l) for l in range(cfg.num_layers))
    return 0 if cfg.is_attention_free else cfg.num_layers


def _mlp_apply(p: Dict[str, Any], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe is not None and "router" in p:
        return moe_mlp(p, x, cfg)
    return mlp_apply_dense(p, x, cfg.mlp_gated)


def _attn_apply_full(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mla is not None:
        return attn.mla_full(p, x, cfg)
    return attn.gqa_full(p, x, cfg)


def _dense_block_full(lp: Dict[str, Any], x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    x = x + _attn_apply_full(lp["attn"],
                             rms_norm(x, lp["norm0"], cfg.norm_eps), cfg)
    return x + _mlp_apply(lp["mlp"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                          cfg)


def _ssm_block_full(lp: Dict[str, Any], x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return x + m2.mamba2_full(lp["ssm"], rms_norm(x, lp["norm0"],
                                                  cfg.norm_eps), cfg)


def _shared_mlp(sp: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The hybrid shared block's second half: x + its dense MLP."""
    return x + mlp_apply_dense(sp["mlp"], rms_norm(x, sp["norm1"],
                                                   cfg.norm_eps),
                               cfg.mlp_gated)


def _shared_block_full(sp: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    x = x + attn.gqa_full(sp["attn"], rms_norm(x, sp["norm0"], cfg.norm_eps),
                          cfg)
    return _shared_mlp(sp, x, cfg)


def _encoder_block(lp: Dict[str, Any], x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    x = x + attn.gqa_full(lp["attn"], rms_norm(x, lp["norm0"], cfg.norm_eps),
                          cfg, causal=False)
    return x + mlp_apply_dense(lp["mlp"], rms_norm(x, lp["norm1"],
                                                   cfg.norm_eps),
                               cfg.mlp_gated)


def _cross_kv(p: Dict[str, torch.Tensor], memory: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross attention's keys and values (B, S_enc, KV, hd), projected from
    the encoder's output (no RoPE, no bias)."""
    b = memory.shape[0]
    shape = (b, -1, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((memory @ p["wk"].to(memory.dtype)).reshape(shape),
            (memory @ p["wv"].to(memory.dtype)).reshape(shape))


def _cross_attend(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Cross attention: queries from the decoder's x (B, S, d) over the
    keys and values of :func:`_cross_kv`, unmasked (on the card one flash
    launch at Sq = S, Skv = S_enc)."""
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.num_heads,
                                          cfg.resolved_head_dim)
    out = blocked_attention(q, k, v, causal=False, q_block=cfg.q_block,
                            kv_block=cfg.kv_block)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def _decoder_block_full(lp: Dict[str, Any], x: torch.Tensor,
                        cfg: ModelConfig,
                        memory: torch.Tensor) -> torch.Tensor:
    x = x + attn.gqa_full(lp["attn"], rms_norm(x, lp["norm0"], cfg.norm_eps),
                          cfg)
    x = x + _cross_attend(lp["cross"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                          *_cross_kv(lp["cross"], memory, cfg),
                          cfg)
    return x + mlp_apply_dense(lp["mlp"], rms_norm(x, lp["norm2"],
                                                   cfg.norm_eps),
                               cfg.mlp_gated)


def _run(block, remat: bool, *args) -> torch.Tensor:
    """``block(*args)``; with ``remat`` under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the block and its forward
    saves nothing inside it, the reference's ``jax.checkpoint`` with
    ``nothing_saveable``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False)
    return block(*args)


def encode(params: Dict[str, Any], cfg: ModelConfig, frames: torch.Tensor,
           *, remat: bool = False) -> torch.Tensor:
    """The encoder's output (B, S_enc, d) in the activation dtype: the
    bidirectional stack over the frame embeddings ``frames`` (B, S_enc, d)
    (RoPE over positions 0..S_enc-1, ``cfg.sliding_window``), then its
    final norm."""
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs its encoder "
                         f"frames (encoder_embeds, a batch's 'frames')")
    x = frames.to(getattr(torch, cfg.activation_dtype))
    for lp in _layers(params, cfg, "encoder"):
        x = _run(_encoder_block, remat, lp, x, cfg)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _mamba_final_state(p, x: torch.Tensor,
                       cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The exact (conv, ssm) state after the sequence x (B, S, d), both
    f32: the last k-1 conv inputs, and Σ_s decay-to-end · dt · x ⊗ B."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    z, xh, bc, dt, di, gn, nh = m2._split_proj(p, x, cfg)
    xbc = torch.cat([xh, bc], -1)
    # a copy: a view of the tail would keep the whole (B, S, C) input alive
    # with the cache (f32's .float() is no copy)
    conv_state = xbc[:, s - (s_cfg.conv_kernel - 1):].to(torch.float32,
                                                          copy=True)
    conv_out = m2._causal_conv_full(xbc, p["conv_w"], p["conv_b"])
    xh_c, bmat = conv_out[..., :di], conv_out[..., di:di + gn]
    dt, a = m2._dt_and_a(p, dt)
    da_cum = (dt * a).cumsum(1)                               # (B,S,H)
    decay_to_end = torch.exp(da_cum[:, -1:] - da_cum)
    g = s_cfg.n_groups
    xw = (xh_c.reshape(b, s, nh, s_cfg.head_dim).float()
          * (decay_to_end * dt)[..., None])                   # (B,S,H,P)
    state = torch.matmul(                                     # per group
        xw.reshape(b, s, g, -1).permute(0, 2, 3, 1),          # (B,G,hpg·P,S)
        bmat.reshape(b, s, g, -1).float().transpose(1, 2))    # (B,G,S,N)
    return {"conv": conv_state,
            "ssm": state.reshape(b, nh, s_cfg.head_dim, s_cfg.d_state)}


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    # gather first, then cast: the same values as the reference's cast of
    # the whole table, without casting it
    x = params["embed"]["tok"][tokens.long()].to(
        getattr(torch, cfg.activation_dtype))
    if prefix_embeds is not None:
        # the frontend stub: precomputed patch embeddings before the tokens
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return x @ w


def lm_forward(params: Dict[str, Any], cfg: ModelConfig,
               tokens: torch.Tensor, *,
               prefix_embeds: Optional[torch.Tensor] = None,
               encoder_embeds: Optional[torch.Tensor] = None,
               remat: bool = False) -> torch.Tensor:
    """Logits (B, P + S, V) of ``tokens`` (B, S) after the ``prefix_embeds``
    (B, P, d) of a vision model (P = 0 without them); an encoder-decoder's
    decoder attends across to the encoder's output over
    ``encoder_embeds`` (B, S_enc, d).  ``remat=True`` runs each block (a
    hybrid's shared block, an encoder's blocks too) under
    ``torch.utils.checkpoint`` (:func:`_run`)."""
    require_ported(cfg)
    x = _embed(params, cfg, tokens, prefix_embeds)
    if cfg.encoder_layers > 0:
        memory = encode(params, cfg, encoder_embeds, remat=remat)
        for lp in _layers(params, cfg):
            x = _run(_decoder_block_full, remat, lp, x, cfg, memory)
        return _head(params, cfg, x)
    block = (_ssm_block_full if cfg.family in ("ssm", "hybrid")
             else _dense_block_full)
    for l, lp in enumerate(_layers(params, cfg)):
        x = _run(block, remat, lp, x, cfg)
        if _shared_after(cfg, l):
            x = _run(_shared_block_full, remat, params["shared"], x, cfg)
    return _head(params, cfg, x)


def _stack(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([c[name] for c in caches])
            for name in caches[0]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    """Zeroed serving caches, stacked over the layers (a hybrid's attention
    caches over its shared block's applications): KV and MLA caches in
    ``dtype``, an SSM's conv and state in f32 (``max_len`` unused), an
    encoder-decoder's self caches and its cross keys and values of
    ``enc_len`` slots, both in ``dtype``."""
    require_ported(cfg)

    def stacked(one, n):
        return {name: t.new_zeros((n,) + t.shape) for name, t in one.items()}

    out = {}
    if cfg.encoder_layers > 0:
        cross = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"self": stacked(attn.gqa_init_cache(cfg, batch, max_len,
                                                    dtype, device),
                                cfg.num_layers),
                "cross": {name: torch.zeros(cross, dtype=dtype,
                                            device=device)
                          for name in ("k", "v")}}
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = stacked(m2.mamba2_init_cache(cfg, batch, device=device),
                             cfg.num_layers)
    if cfg.family == "ssm":
        return out
    if cfg.mla is not None:
        out["mla"] = stacked(attn.mla_init_cache(cfg, batch, max_len, dtype,
                                                 device), attention_calls(cfg))
        return out
    out["attn" if cfg.family == "hybrid" else "kv"] = stacked(
        attn.gqa_init_cache(cfg, batch, max_len, dtype, device),
        attention_calls(cfg))
    return out


def lm_prefill(params: Dict[str, Any], cfg: ModelConfig,
               tokens: torch.Tensor, *, cache_len: int,
               prefix_embeds: Optional[torch.Tensor] = None,
               encoder_embeds: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt: (full logits (B, P + S, V), caches of ``cache_len``
    slots holding its keys and values, in the activation dtype (MLA's
    latent and rope key in bf16); an SSM's final conv and state instead,
    in f32, whatever ``cache_len``; a hybrid's both).  A vision model's
    ``prefix_embeds`` fill the first P slots; an encoder-decoder's
    ``encoder_embeds`` run through :func:`encode`, and its caches are the
    decoder's self caches and the cross keys and values in bf16."""
    require_ported(cfg)
    x = _embed(params, cfg, tokens, prefix_embeds)
    caches: Dict[str, list] = {}
    memory = (encode(params, cfg, encoder_embeds)
              if cfg.encoder_layers > 0 else None)
    for l, lp in enumerate(_layers(params, cfg)):
        h_in = rms_norm(x, lp["norm0"], cfg.norm_eps)
        if cfg.family in ("ssm", "hybrid"):
            x = x + m2.mamba2_full(lp["ssm"], h_in, cfg)
            caches.setdefault("ssm", []).append(
                _mamba_final_state(lp["ssm"], h_in, cfg))
            if _shared_after(cfg, l):
                sp = params["shared"]
                h, c = attn.gqa_prefill(
                    sp["attn"], rms_norm(x, sp["norm0"], cfg.norm_eps), cfg,
                    cache_len)
                x = _shared_mlp(sp, x + h, cfg)
                caches.setdefault("attn", []).append(c)
            continue
        if memory is not None:
            h, c = attn.gqa_prefill(lp["attn"], h_in, cfg, cache_len)
            x = x + h
            k, v = _cross_kv(lp["cross"], memory, cfg)
            x = x + _cross_attend(lp["cross"], rms_norm(x, lp["norm1"],
                                                        cfg.norm_eps),
                                  k, v, cfg)
            x = x + mlp_apply_dense(lp["mlp"], rms_norm(x, lp["norm2"],
                                                        cfg.norm_eps),
                                    cfg.mlp_gated)
            caches.setdefault("self", []).append(c)
            # constant through the decode steps, in bf16 as the reference
            caches.setdefault("cross", []).append(
                {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)})
            continue
        if cfg.mla is not None:
            h, c = attn.mla_prefill(lp["attn"], h_in, cfg, cache_len)
        else:
            h, c = attn.gqa_prefill(lp["attn"], h_in, cfg, cache_len)
        x = x + h
        x = x + _mlp_apply(lp["mlp"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                           cfg)
        caches.setdefault("mla" if cfg.mla is not None else "kv",
                          []).append(c)
    return _head(params, cfg, x), {k: _stack(v) for k, v in caches.items()}


def lm_decode_step(params: Dict[str, Any], cfg: ModelConfig,
                   cache: Dict[str, Any], token: torch.Tensor,
                   pos: Union[int, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: next-token logits (B, 1, V) for ``token`` (B, 1)
    at absolute position ``pos`` (an int, or an int32 scalar tensor that
    stays on the device; an SSM ignores it), and the caches, updated in
    place.  An encoder-decoder's decoder attends over its self cache,
    then across the whole cross cache (which it leaves as it is)."""
    require_ported(cfg)
    x = _embed(params, cfg, token)
    if not torch.is_tensor(pos):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    if cfg.encoder_layers > 0:
        return _encdec_decode(params, cfg, cache, x, pos), cache
    for l, lp in enumerate(_layers(params, cfg)):
        h_in = rms_norm(x, lp["norm0"], cfg.norm_eps)
        if cfg.family in ("ssm", "hybrid"):
            h, _ = m2.mamba2_decode(lp["ssm"], h_in, _at(cache["ssm"], l),
                                    cfg)
            x = x + h
            if _shared_after(cfg, l):
                sp = params["shared"]
                app = (l + 1) // cfg.hybrid_period - 1
                h, _ = attn.gqa_decode(
                    sp["attn"], rms_norm(x, sp["norm0"], cfg.norm_eps),
                    _at(cache["attn"], app), pos, cfg)
                x = _shared_mlp(sp, x + h, cfg)
            continue
        if cfg.mla is not None:
            h, _ = attn.mla_decode(lp["attn"], h_in, _at(cache["mla"], l),
                                   pos, cfg)
        else:
            h, _ = attn.gqa_decode(lp["attn"], h_in, _at(cache["kv"], l),
                                   pos, cfg)
        x = x + h
        x = x + _mlp_apply(lp["mlp"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                           cfg)
    return _head(params, cfg, x), cache


def _encdec_decode(params: Dict[str, Any], cfg: ModelConfig,
                   cache: Dict[str, Any], x: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """An encoder-decoder's decode step (``lm_decode_step``): the logits
    (B, 1, V); the self caches are updated in place."""
    b = x.shape[0]
    # every cross slot is filled: cache_len is the encoder's length, made
    # on the device (a fill, no host copy) so that a step can be captured
    enc_len = pos.new_full((), cache["cross"]["k"].shape[2])
    for l, lp in enumerate(_layers(params, cfg)):
        h, _ = attn.gqa_decode(lp["attn"], rms_norm(x, lp["norm0"],
                                                    cfg.norm_eps),
                               _at(cache["self"], l), pos, cfg)
        x = x + h
        cp, cc = lp["cross"], _at(cache["cross"], l)
        q = (rms_norm(x, lp["norm1"], cfg.norm_eps) @ cp["wq"].to(x.dtype)
             ).reshape(b, 1, cfg.num_heads, cfg.resolved_head_dim)
        out = decode_attention(q, cc["k"].to(x.dtype), cc["v"].to(x.dtype),
                               cache_len=enc_len)
        x = x + out.reshape(b, 1, -1) @ cp["wo"].to(x.dtype)
        x = x + mlp_apply_dense(lp["mlp"], rms_norm(x, lp["norm2"],
                                                    cfg.norm_eps),
                                cfg.mlp_gated)
    return _head(params, cfg, x)
