"""Model assembly for the dense GQA, MoE and SSM (Mamba2) families: the
port of those families of ``repro.models.transformer``.

- ``lm_forward``: full-sequence logits (training, eval; ``remat=True``
  recomputes each block in the backward);
- ``lm_prefill``: prompt -> (full logits, KV caches);
- ``lm_decode_step``: one token against the caches (serving).

Per-layer weights stay stacked on a leading L axis, as in the reference;
the layer loop is a Python loop over views of them.  Caches are stacked
the same way (``{"kv": {"k": (L, B, size, KV, hd), "v": ...}}``; an SSM's
``{"ssm": {"conv": (L, B, k-1, conv_dim), "ssm": (L, B, H, P, N)}}`` in
f32), and a decode step updates them in place.  An MoE block is a dense
block whose MLP is ``moe.moe_mlp``.  The other families (MLA, hybrid,
encoder-decoder, modality frontends) raise.
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


def _mlp_apply(p: Dict[str, Any], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe is not None and "router" in p:
        return moe_mlp(p, x, cfg)
    return mlp_apply_dense(p, x, cfg.mlp_gated)


def _dense_block_full(lp: Dict[str, Any], x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    x = x + attn.gqa_full(lp["attn"], rms_norm(x, lp["norm0"], cfg.norm_eps),
                          cfg)
    return x + _mlp_apply(lp["mlp"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                          cfg)


def _ssm_block_full(lp: Dict[str, Any], x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return x + m2.mamba2_full(lp["ssm"], rms_norm(x, lp["norm0"],
                                                  cfg.norm_eps), cfg)


def _mamba_final_state(p, x: torch.Tensor,
                       cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The exact (conv, ssm) state after the sequence x (B, S, d), both
    f32: the last k-1 conv inputs, and Σ_s decay-to-end · dt · x ⊗ B."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    z, xh, bc, dt, di, gn, nh = m2._split_proj(p, x, cfg)
    xbc = torch.cat([xh, bc], -1)
    conv_state = xbc[:, s - (s_cfg.conv_kernel - 1):].float()
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
    """Logits (B, S, V).  ``remat=True`` runs each block under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
    block and its forward saves nothing inside it, the reference's
    ``jax.checkpoint`` with ``nothing_saveable``."""
    require_ported(cfg)
    block = _ssm_block_full if cfg.family == "ssm" else _dense_block_full
    x = _embed(params, cfg, tokens)
    for lp in _layers(params, cfg):
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, lp, x, cfg,
                                                  use_reentrant=False)
        else:
            x = block(lp, x, cfg)
    return _head(params, cfg, x)


def _stack(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([c[name] for c in caches])
            for name in caches[0]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed serving caches, stacked over the layers: KV caches in
    ``dtype``, an SSM's conv and state in f32 (``max_len`` unused)."""
    require_ported(cfg)
    if cfg.family == "ssm":
        one = m2.mamba2_init_cache(cfg, batch, device=device)
        return {"ssm": {name: t.new_zeros((cfg.num_layers,) + t.shape)
                        for name, t in one.items()}}
    shape = (cfg.num_layers, batch, attn.cache_size(cfg, max_len),
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def lm_prefill(params: Dict[str, Any], cfg: ModelConfig,
               tokens: torch.Tensor, *, cache_len: int
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt: (full logits (B, S, V), caches of ``cache_len``
    slots holding its keys and values, in the activation dtype; an SSM's
    final conv and state instead, in f32, whatever ``cache_len``)."""
    require_ported(cfg)
    x = _embed(params, cfg, tokens)
    caches = []
    for lp in _layers(params, cfg):
        h_in = rms_norm(x, lp["norm0"], cfg.norm_eps)
        if cfg.family == "ssm":
            x = x + m2.mamba2_full(lp["ssm"], h_in, cfg)
            caches.append(_mamba_final_state(lp["ssm"], h_in, cfg))
            continue
        h, c = attn.gqa_prefill(lp["attn"], h_in, cfg, cache_len)
        x = x + h
        x = x + _mlp_apply(lp["mlp"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                           cfg)
        caches.append(c)
    key = "ssm" if cfg.family == "ssm" else "kv"
    return _head(params, cfg, x), {key: _stack(caches)}


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
    if cfg.family == "ssm":
        st = cache["ssm"]
        for l, lp in enumerate(_layers(params, cfg)):
            h, _ = m2.mamba2_decode(
                lp["ssm"], rms_norm(x, lp["norm0"], cfg.norm_eps),
                {name: t[l] for name, t in st.items()}, cfg)
            x = x + h
        return _head(params, cfg, x), cache
    if not torch.is_tensor(pos):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    kv = cache["kv"]
    for l, lp in enumerate(_layers(params, cfg)):
        h, _ = attn.gqa_decode(lp["attn"],
                               rms_norm(x, lp["norm0"], cfg.norm_eps),
                               {"k": kv["k"][l], "v": kv["v"][l]}, pos, cfg)
        x = x + h
        x = x + _mlp_apply(lp["mlp"], rms_norm(x, lp["norm1"], cfg.norm_eps),
                           cfg)
    return _head(params, cfg, x), cache
