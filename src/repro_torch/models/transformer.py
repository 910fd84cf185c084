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
from repro_torch.sharding import per_shard as PS
from repro_torch.sharding.rules import axis_rules, get_rules, ws


def _norm(x: torch.Tensor, scale: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """``rms_norm`` of the residual stream, the result with its sequence
    whole (``ctx``): between blocks the stream keeps the reference's
    ``ctx_res`` sharding, and the reference's GSPMD gathers the sequence
    around attention and the MLP; DTensor's products want it gathered
    first.  On a plain tensor, ``rms_norm`` itself."""
    return ws(rms_norm(x, scale, cfg.norm_eps), "batch", "ctx", "embed")


def _res(h: torch.Tensor) -> torch.Tensor:
    """A mixer's output (attention, MLP, SSM) as the residual stream holds
    it (``ctx_res``) before it is added: on DTensors the add's gradient
    then reaches the mixer's products with the sequence whole again (the
    redistribution is autograd's to invert, where the add's own implicit
    one is not).  On a plain tensor, ``h`` itself."""
    return ws(h, "batch", "ctx_res", "embed")


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
    x = x + _res(_attn_apply_full(lp["attn"], _norm(x, lp["norm0"], cfg),
                                  cfg))
    x = x + _res(_mlp_apply(lp["mlp"], _norm(x, lp["norm1"], cfg), cfg))
    return ws(x, "batch", "ctx_res", "embed")


def _ssm_block_full(lp: Dict[str, Any], x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return ws(x + _res(m2.mamba2_full(lp["ssm"], _norm(x, lp["norm0"], cfg),
                                      cfg)),
              "batch", "ctx_res", "embed")


def _shared_mlp(sp: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The hybrid shared block's second half: x + its dense MLP."""
    return x + _res(mlp_apply_dense(sp["mlp"], _norm(x, sp["norm1"], cfg),
                                    cfg.mlp_gated))


def _shared_block_full(sp: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    x = x + _res(attn.gqa_full(sp["attn"], _norm(x, sp["norm0"], cfg), cfg))
    return _shared_mlp(sp, x, cfg)


def _encoder_block(lp: Dict[str, Any], x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    x = x + attn.gqa_full(lp["attn"], _norm(x, lp["norm0"], cfg),
                          cfg, causal=False)
    return x + mlp_apply_dense(lp["mlp"], _norm(x, lp["norm1"], cfg),
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
    def attend(q, k, v):
        b, s, _ = q.shape
        out = blocked_attention(
            q.reshape(b, s, -1, cfg.resolved_head_dim), k, v, causal=False,
            q_block=cfg.q_block, kv_block=cfg.kv_block)
        return out.reshape(b, s, -1)

    spec, spec4 = attn.head_specs(cfg, x, cfg.num_kv_heads)
    out = PS.run(attend, (x @ p["wq"].to(x.dtype), k, v),
                 (spec, spec4, spec4), spec)
    return out @ p["wo"].to(x.dtype)


def _decoder_block_full(lp: Dict[str, Any], x: torch.Tensor,
                        cfg: ModelConfig,
                        memory: torch.Tensor) -> torch.Tensor:
    x = x + _res(attn.gqa_full(lp["attn"], _norm(x, lp["norm0"], cfg), cfg))
    x = x + _res(_cross_attend(lp["cross"], _norm(x, lp["norm1"], cfg),
                               *_cross_kv(lp["cross"], memory, cfg), cfg))
    return x + _res(mlp_apply_dense(lp["mlp"], _norm(x, lp["norm2"], cfg),
                                    cfg.mlp_gated))


def _run(block, remat: bool, *args) -> torch.Tensor:
    """``block(*args)``; with ``remat`` under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the block and its forward
    saves nothing inside it, the reference's ``jax.checkpoint`` with
    ``nothing_saveable``.  The recompute runs under the forward's sharding
    rules: autograd runs a card's backward on a thread of its own, which
    the thread-local rules would not reach, and its ``ws`` would do
    nothing."""
    if remat:
        rules = get_rules()

        def ruled(*a):
            with axis_rules(rules):
                return block(*a)
        return torch.utils.checkpoint.checkpoint(ruled, *args,
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
    x = ws(frames.to(getattr(torch, cfg.activation_dtype)), "batch", "ctx",
           "embed")
    for lp in _layers(params, cfg, "encoder"):
        x = _run(_encoder_block, remat, lp, x, cfg)
    return _norm(x, params["enc_final_norm"], cfg)


def _mamba_final_state(p, x: torch.Tensor, cfg: ModelConfig,
                       zxbcdt: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """The exact (conv, ssm) state after the sequence x (B, S, d), both
    f32: the last k-1 conv inputs, and Σ_s decay-to-end · dt · x ⊗ B
    (from x's input projection ``zxbcdt`` where the caller has it)."""
    if zxbcdt is None:
        zxbcdt = x @ p["in_proj"].to(x.dtype)
    conv, ssm = m2._per_batch_shard(
        lambda zx, lp: _final_state(lp, zx, cfg), cfg, p, zxbcdt, outs=2)
    return {"conv": conv, "ssm": ssm}


def _final_state(p, zxbcdt: torch.Tensor, cfg: ModelConfig):
    """One shard's (conv, ssm) state from its projection output."""
    s_cfg = cfg.ssm
    b, s, _ = zxbcdt.shape
    z, xh, bc, dt, di, gn, nh = m2._split(zxbcdt, cfg)
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
    return conv_state, state.reshape(b, nh, s_cfg.head_dim, s_cfg.d_state)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    # gather first, then cast: the same values as the reference's cast of
    # the whole table, without casting it (a DTensor table per shard)
    rows = PS.vocab_lookup(params["embed"]["tok"], tokens)
    x = rows.to(getattr(torch, cfg.activation_dtype))
    if prefix_embeds is not None:
        # the frontend stub: precomputed patch embeddings before the tokens
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return ws(x, "batch", "ctx_res", "embed")


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return ws(x @ w, "batch", "ctx", "vocab")


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
        h_in = _norm(x, lp["norm0"], cfg)
        if cfg.family in ("ssm", "hybrid"):
            # one input projection for the mixer and its final state
            zx = h_in @ lp["ssm"]["in_proj"].to(h_in.dtype)
            x = x + m2.mamba2_from_proj(lp["ssm"], zx, h_in.dtype, cfg)
            caches.setdefault("ssm", []).append(
                _mamba_final_state(lp["ssm"], h_in, cfg, zx))
            if _shared_after(cfg, l):
                sp = params["shared"]
                h, c = attn.gqa_prefill(
                    sp["attn"], _norm(x, sp["norm0"], cfg), cfg,
                    cache_len)
                x = _shared_mlp(sp, x + h, cfg)
                caches.setdefault("attn", []).append(c)
            continue
        if memory is not None:
            h, c = attn.gqa_prefill(lp["attn"], h_in, cfg, cache_len)
            x = x + h
            k, v = _cross_kv(lp["cross"], memory, cfg)
            x = x + _cross_attend(lp["cross"], _norm(x, lp["norm1"], cfg),
                                  k, v, cfg)
            x = x + mlp_apply_dense(lp["mlp"], _norm(x, lp["norm2"], cfg),
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
        x = x + _mlp_apply(lp["mlp"], _norm(x, lp["norm1"], cfg),
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
        h_in = _norm(x, lp["norm0"], cfg)
        if cfg.family in ("ssm", "hybrid"):
            h, _ = m2.mamba2_decode(lp["ssm"], h_in, _at(cache["ssm"], l),
                                    cfg)
            x = x + h
            if _shared_after(cfg, l):
                sp = params["shared"]
                app = (l + 1) // cfg.hybrid_period - 1
                h, _ = attn.gqa_decode(
                    sp["attn"], _norm(x, sp["norm0"], cfg),
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
        x = x + _mlp_apply(lp["mlp"], _norm(x, lp["norm1"], cfg),
                           cfg)
    return _head(params, cfg, x), cache


def _encdec_decode(params: Dict[str, Any], cfg: ModelConfig,
                   cache: Dict[str, Any], x: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """An encoder-decoder's decode step (``lm_decode_step``): the logits
    (B, 1, V); the self caches are updated in place."""
    def cross(q, k, v, pos):
        b = q.shape[0]
        # every cross slot is filled: cache_len is the encoder's length,
        # made on the device (a fill, no host copy) so that a step can be
        # captured
        out = decode_attention(
            q.reshape(b, 1, -1, cfg.resolved_head_dim), k.to(q.dtype),
            v.to(q.dtype), cache_len=pos.new_full((), k.shape[1]))
        return out.reshape(b, 1, -1)

    spec, spec4 = attn.head_specs(cfg, x, cfg.num_kv_heads)
    for l, lp in enumerate(_layers(params, cfg)):
        h, _ = attn.gqa_decode(lp["attn"], _norm(x, lp["norm0"], cfg),
                               _at(cache["self"], l), pos, cfg)
        x = x + h
        cp, cc = lp["cross"], _at(cache["cross"], l)
        q = _norm(x, lp["norm1"], cfg) @ cp["wq"].to(x.dtype)
        out = PS.run(cross, (q, cc["k"], cc["v"], pos),
                     (spec, spec4, spec4, ()), spec)
        x = x + out @ cp["wo"].to(x.dtype)
        x = x + mlp_apply_dense(lp["mlp"], _norm(x, lp["norm2"], cfg),
                                cfg.mlp_gated)
    return _head(params, cfg, x)
