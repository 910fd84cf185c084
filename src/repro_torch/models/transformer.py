"""Model assembly for the dense GQA and MLA, MoE, SSM (Mamba2) and hybrid
(Zamba2) families: the port of those families of
``repro.models.transformer``.

- ``lm_forward``: full-sequence logits (training, eval; ``remat=True``
  recomputes each block in the backward);
- ``lm_prefill``: prompt -> (full logits, KV caches);
- ``lm_decode_step``: one token against the caches (serving).

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
{"k": (apps, B, size, KV, hd), "v": ...}}``).  The other families
(encoder-decoder, modality frontends) raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply_dense, rms_norm
from repro_torch.models.moe import moe_mlp
from repro_torch.models.params import require_ported


def _layers(params: Dict[str, Any], cfg: ModelConfig) -> List[Dict[str, Any]]:
    """One tree of views ``blocks[...][l]`` per layer, from one ``unbind``
    of each stacked leaf (whose backward stacks the layers' gradients in
    one copy, where indexing would add a zero-filled stack per layer)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, l):
        return {k: pick(v, l) if isinstance(v, dict) else v[l]
                for k, v in tree.items()}
    per_layer = split(params["blocks"])
    return [pick(per_layer, l) for l in range(cfg.num_layers)]


def _at(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Entry ``i`` of each stacked cache leaf (views, updated in place)."""
    return {name: t[i] for name, t in tree.items()}


def _shared_after(cfg: ModelConfig, l: int) -> bool:
    """Whether a hybrid model applies its shared block after layer ``l``:
    after every ``hybrid_period``-th layer, none after the tail."""
    return cfg.family == "hybrid" and (l + 1) % cfg.hybrid_period == 0


def attention_calls(cfg: ModelConfig) -> int:
    """Attention calls of one pass of the model (a prefill, or a decode
    step), each with its own cache: one per layer, a hybrid's one per
    application of its shared block, none in an SSM."""
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


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather first, then cast: the same values as the reference's cast of
    # the whole table, without casting it
    return params["embed"]["tok"][tokens.long()].to(
        getattr(torch, cfg.activation_dtype))


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return x @ w


def lm_forward(params: Dict[str, Any], cfg: ModelConfig,
               tokens: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
    """Logits (B, S, V).  ``remat=True`` runs each block (a hybrid's shared
    block too) under ``torch.utils.checkpoint`` (non-reentrant): the
    backward recomputes the block and its forward saves nothing inside it,
    the reference's ``jax.checkpoint`` with ``nothing_saveable``."""
    require_ported(cfg)

    def run(block, p, x):
        if remat:
            return torch.utils.checkpoint.checkpoint(block, p, x, cfg,
                                                     use_reentrant=False)
        return block(p, x, cfg)

    block = (_ssm_block_full if cfg.family in ("ssm", "hybrid")
             else _dense_block_full)
    x = _embed(params, cfg, tokens)
    for l, lp in enumerate(_layers(params, cfg)):
        x = run(block, lp, x)
        if _shared_after(cfg, l):
            x = run(_shared_block_full, params["shared"], x)
    return _head(params, cfg, x)


def _stack(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([c[name] for c in caches])
            for name in caches[0]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed serving caches, stacked over the layers (a hybrid's attention
    caches over its shared block's applications): KV and MLA caches in
    ``dtype``, an SSM's conv and state in f32 (``max_len`` unused)."""
    require_ported(cfg)

    def stacked(one, n):
        return {name: t.new_zeros((n,) + t.shape) for name, t in one.items()}

    out = {}
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
               tokens: torch.Tensor, *, cache_len: int
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt: (full logits (B, S, V), caches of ``cache_len``
    slots holding its keys and values, in the activation dtype (MLA's
    latent and rope key in bf16); an SSM's final conv and state instead,
    in f32, whatever ``cache_len``; a hybrid's both)."""
    require_ported(cfg)
    x = _embed(params, cfg, tokens)
    caches: Dict[str, list] = {}
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
    place."""
    require_ported(cfg)
    x = _embed(params, cfg, token)
    if not torch.is_tensor(pos):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
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
