"""Model assembly for the dense GQA family: the port of the dense half of
``repro.models.transformer``.

- ``lm_forward``: full-sequence logits (training, eval; ``remat=True``
  recomputes each block in the backward);
- ``lm_prefill``: prompt -> (full logits, KV caches);
- ``lm_decode_step``: one token against the caches (serving).

Per-layer weights stay stacked on a leading L axis, as in the reference;
the layer loop is a Python loop over views of them.  Caches are stacked
the same way (``{"kv": {"k": (L, B, size, KV, hd), "v": ...}}``), and a
decode step updates them in place.  The other families (MoE, MLA, SSM,
hybrid, encoder-decoder, modality frontends) raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply_dense, rms_norm
from repro_torch.models.params import require_dense


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


def _dense_block_full(lp: Dict[str, Any], x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    x = x + attn.gqa_full(lp["attn"], rms_norm(x, lp["norm0"], cfg.norm_eps),
                          cfg)
    return x + mlp_apply_dense(lp["mlp"],
                               rms_norm(x, lp["norm1"], cfg.norm_eps),
                               cfg.mlp_gated)


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
    """Logits (B, S, V) of a dense GQA model.  ``remat=True`` runs each
    block under ``torch.utils.checkpoint`` (non-reentrant): the backward
    recomputes the block and its forward saves nothing inside it, the
    reference's ``jax.checkpoint`` with ``nothing_saveable``."""
    require_dense(cfg)
    x = _embed(params, cfg, tokens)
    for lp in _layers(params, cfg):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _dense_block_full, lp, x, cfg, use_reentrant=False)
        else:
            x = _dense_block_full(lp, x, cfg)
    return _head(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed serving caches, stacked over the layers."""
    require_dense(cfg)
    shape = (cfg.num_layers, batch, attn.cache_size(cfg, max_len),
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def lm_prefill(params: Dict[str, Any], cfg: ModelConfig,
               tokens: torch.Tensor, *, cache_len: int
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt: (full logits (B, S, V), caches of ``cache_len``
    slots holding its keys and values, in the activation dtype)."""
    require_dense(cfg)
    x = _embed(params, cfg, tokens)
    caches = []
    for lp in _layers(params, cfg):
        h, c = attn.gqa_prefill(lp["attn"],
                                rms_norm(x, lp["norm0"], cfg.norm_eps), cfg,
                                cache_len)
        x = x + h
        x = x + mlp_apply_dense(lp["mlp"],
                                rms_norm(x, lp["norm1"], cfg.norm_eps),
                                cfg.mlp_gated)
        caches.append(c)
    return _head(params, cfg, x), {"kv": {
        name: torch.stack([c[name] for c in caches]) for name in ("k", "v")}}


def lm_decode_step(params: Dict[str, Any], cfg: ModelConfig,
                   cache: Dict[str, Any], token: torch.Tensor,
                   pos: Union[int, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: next-token logits (B, 1, V) for ``token`` (B, 1)
    at absolute position ``pos`` (an int, or an int32 scalar tensor that
    stays on the device), and the caches, updated in place."""
    require_dense(cfg)
    x = _embed(params, cfg, token)
    if not torch.is_tensor(pos):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    kv = cache["kv"]
    for l, lp in enumerate(_layers(params, cfg)):
        h, _ = attn.gqa_decode(lp["attn"],
                               rms_norm(x, lp["norm0"], cfg.norm_eps),
                               {"k": kv["k"][l], "v": kv["v"][l]}, pos, cfg)
        x = x + h
        x = x + mlp_apply_dense(lp["mlp"],
                                rms_norm(x, lp["norm1"], cfg.norm_eps),
                                cfg.mlp_gated)
    return _head(params, cfg, x), cache
