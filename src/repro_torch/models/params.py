"""Parameter definitions: one source of truth for shape, init and dtype.

The port of ``repro.models.params`` for every family: dense GQA and MLA
(the vision frontend's text backbone among them), MoE, SSM, hybrid and
encoder-decoder.
``build_defs(cfg)`` returns a tree (nested dicts) of ``ParamDef`` leaves,
and ``init_params`` materializes it.  Per-layer weights keep the
reference's stacked ``[L, ...]`` leaves (the hybrid's one shared block is
unstacked; an encoder-decoder's encoder is stacked over its own
``encoder_layers``), so that ``convert.lm_params_from_numpy`` maps the JAX tree one
for one.  Every leaf carries the reference's logical axis names, from
which :func:`param_pspecs` derives its sharding spec under a rule table
(:mod:`repro_torch.sharding.rules`); :func:`abstract_params` gives the
tree's shapes and dtypes without allocating.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import AxisRules, logical_to_pspec


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis per dim
    init: str = "normal"          # normal | zeros | ones | small_normal
    dtype: Optional[str] = None   # override cfg.param_dtype


#: the model families the port builds (MLA is a dense model with
#: ``cfg.mla`` set, the vision frontend a dense model with
#: ``cfg.frontend == "vision"``)
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


def require_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of a family the port builds (every family
    of the reference)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown model family {cfg.family!r}; the port "
            f"builds {PORTED_FAMILIES}")


def _attn_defs(cfg: ModelConfig, layers: Optional[int],
               cross: bool = False) -> Dict[str, ParamDef]:
    """GQA attention projections, stacked over ``layers`` (``None``: the
    hybrid's unstacked shared block); cross attention has no QKV bias."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    lead = () if layers is None else (layers,)
    ll = () if layers is None else ("layers",)
    defs = {
        "wq": ParamDef(lead + (d, h * hd), ll + ("embed_p", "heads")),
        "wk": ParamDef(lead + (d, kv * hd), ll + ("embed_p", "kv_heads")),
        "wv": ParamDef(lead + (d, kv * hd), ll + ("embed_p", "kv_heads")),
        "wo": ParamDef(lead + (h * hd, d), ll + ("heads", "embed_p")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef(lead + (h * hd,), ll + ("heads",), "zeros")
        defs["bk"] = ParamDef(lead + (kv * hd,), ll + ("kv_heads",), "zeros")
        defs["bv"] = ParamDef(lead + (kv * hd,), ll + ("kv_heads",), "zeros")
    return defs


def _mla_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    """Multi-head latent attention: the q and kv low-rank projections with
    their norms, the expansions to ``cfg.sharded_heads`` heads, the output
    projection."""
    m, d, h = cfg.mla, cfg.d_model, cfg.sharded_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "q_a": ParamDef((layers, d, m.q_lora_rank),
                        ("layers", "embed_p", None)),
        "q_norm": ParamDef((layers, m.q_lora_rank), ("layers", None),
                           "ones"),
        "q_b": ParamDef((layers, m.q_lora_rank, h * qk_dim),
                        ("layers", None, "heads")),
        "kv_a": ParamDef((layers, d, m.kv_lora_rank + m.qk_rope_head_dim),
                         ("layers", "embed_p", None)),
        "kv_norm": ParamDef((layers, m.kv_lora_rank), ("layers", None),
                            "ones"),
        "kv_b": ParamDef((layers, m.kv_lora_rank,
                          h * (m.qk_nope_head_dim + m.v_head_dim)),
                         ("layers", None, "heads")),
        "wo": ParamDef((layers, h * m.v_head_dim, d),
                       ("layers", "heads", "embed_p")),
    }


def _mlp_defs(cfg: ModelConfig,
              layers: Optional[int]) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    lead = () if layers is None else (layers,)
    ll = () if layers is None else ("layers",)
    defs = {
        "w_up": ParamDef(lead + (d, ff), ll + ("embed_p", "ff")),
        "w_down": ParamDef(lead + (ff, d), ll + ("ff", "embed_p")),
    }
    if cfg.mlp_gated:
        defs["w_gate"] = ParamDef(lead + (d, ff), ll + ("embed_p", "ff"))
    return defs


def _moe_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": ParamDef((layers, d, e), ("layers", "embed_p", None)),
        "w_gate": ParamDef((layers, e, d, ff),
                           ("layers", "experts", "embed_p", "ff")),
        "w_up": ParamDef((layers, e, d, ff),
                         ("layers", "experts", "embed_p", "ff")),
        "w_down": ParamDef((layers, e, ff, d),
                           ("layers", "experts", "ff", "embed_p")),
    }


def _ssm_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn = s.n_groups * s.d_state
    cdim = s.conv_dim(d)
    return {
        "in_proj": ParamDef((layers, d, 2 * di + 2 * gn + nh),  # z x B C dt
                            ("layers", "embed_p", "conv_dim")),
        "conv_w": ParamDef((layers, s.conv_kernel, cdim),
                           ("layers", None, "conv_dim"), "small_normal"),
        "conv_b": ParamDef((layers, cdim), ("layers", "conv_dim"), "zeros"),
        "a_log": ParamDef((layers, nh), ("layers", "ssm_heads"), "ones"),
        "d_skip": ParamDef((layers, nh), ("layers", "ssm_heads"), "ones"),
        "dt_bias": ParamDef((layers, nh), ("layers", "ssm_heads"), "zeros"),
        "norm": ParamDef((layers, di), ("layers", "conv_dim"), "ones"),
        "out_proj": ParamDef((layers, di, d),
                             ("layers", "conv_dim", "embed_p")),
    }


def _block_norms(layers: int, d: int, n: int = 2) -> Dict[str, ParamDef]:
    return {f"norm{i}": ParamDef((layers, d), ("layers", None), "ones")
            for i in range(n)}


def build_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter-definition tree of a dense GQA or MLA, MoE, SSM,
    hybrid or encoder-decoder model."""
    require_ported(cfg)
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    defs: Dict[str, Any] = {
        "embed": {"tok": ParamDef((v, d), ("vocab", "embed_p"),
                                  "small_normal")},
        "final_norm": ParamDef((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed_p", "vocab"),
                                   "small_normal")
    if cfg.family in ("ssm", "hybrid"):
        defs["blocks"] = {"ssm": _ssm_defs(cfg, L), **_block_norms(L, d, 1)}
    elif cfg.encoder_layers > 0:
        # the encoder's bidirectional blocks, then decoder blocks with self
        # attention, cross attention over the encoder's output and 3 norms
        eL = cfg.encoder_layers
        defs["encoder"] = {"attn": _attn_defs(cfg, eL),
                           "mlp": _mlp_defs(cfg, eL),
                           **_block_norms(eL, d, 2)}
        defs["enc_final_norm"] = ParamDef((d,), (None,), "ones")
        defs["blocks"] = {"attn": _attn_defs(cfg, L),
                          "cross": _attn_defs(cfg, L, cross=True),
                          "mlp": _mlp_defs(cfg, L),
                          **_block_norms(L, d, 3)}
    else:
        defs["blocks"] = {"attn": (_mla_defs(cfg, L) if cfg.mla is not None
                                   else _attn_defs(cfg, L)),
                          "mlp": (_moe_defs(cfg, L) if cfg.moe is not None
                                  else _mlp_defs(cfg, L)),
                          **_block_norms(L, d, 2)}
    if cfg.family == "hybrid":
        # one shared attention + MLP block, applied every hybrid_period
        # layers
        defs["shared"] = {"attn": _attn_defs(cfg, None),
                          "mlp": _mlp_defs(cfg, None),
                          "norm0": ParamDef((d,), (None,), "ones"),
                          "norm1": ParamDef((d,), (None,), "ones")}
    return defs


def _tree_map_defs(f: Callable[[Tuple[str, ...], ParamDef], Any],
                   defs: Dict[str, Any],
                   prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Map ``f(path, leaf)`` over the tree in sorted key order (the order
    in which ``jax.tree_util`` visits a dict)."""
    out = {}
    for k in sorted(defs):
        v = defs[k]
        out[k] = (f(prefix + (k,), v) if isinstance(v, ParamDef)
                  else _tree_map_defs(f, v, prefix + (k,)))
    return out


#: a leaf of more elements than this is drawn a slice of its leading
#: (stacked-layer) dim at a time into a tensor of its own dtype, without a
#: whole f32 draw and its scaled copy (Granite-34B's stacked MLP leaves,
#: 88 x 6,144 x 24,576 = 13.3G elements, would take 53 GB each in f32).
#: Every smaller leaf is drawn whole as before, so every model served or
#: trained with no leaf above this size keeps its numbers: the largest
#: such leaf is Zamba2-7B's stacked in_proj at its 81 layers (4.23G).
SLICED_INIT_ELEMENTS = 2**32


def _init_leaf(pd: ParamDef, cfg: ModelConfig, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, pd.dtype or cfg.param_dtype)
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    scale = 0.02 if pd.init == "small_normal" else (
        1.0 / math.sqrt(max(pd.shape[-2] if len(pd.shape) >= 2
                            else pd.shape[-1], 1)))
    if math.prod(pd.shape) > SLICED_INIT_ELEMENTS and len(pd.shape) > 1:
        out = torch.empty(pd.shape, dtype=dtype, device=device)
        for part in out:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       .mul_(scale))
        return out
    x = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Materialized parameters, drawn from ``generator`` (on ``device``,
    the generator's device by default) with the reference's scales:
    ``small_normal`` 0.02, ``normal`` 1/√fan-in, ``zeros``, ``ones``.  The
    numbers differ from ``jax.random``'s; carry JAX's own parameters across
    with ``convert.lm_params_from_numpy``."""
    device = torch.device(device) if device is not None else generator.device
    return _tree_map_defs(
        lambda path, pd: _init_leaf(pd, cfg, generator, device),
        build_defs(cfg))


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree of ``(shape, dtype)`` of every leaf, without allocating."""
    return _tree_map_defs(
        lambda path, pd: (pd.shape,
                          getattr(torch, pd.dtype or cfg.param_dtype)),
        build_defs(cfg))


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree of every leaf as a tensor on the ``meta`` device: its
    shape and dtype, nothing allocated (the reference's
    ``ShapeDtypeStruct`` tree)."""
    return _tree_map_defs(
        lambda path, pd: torch.empty(
            pd.shape, dtype=getattr(torch, pd.dtype or cfg.param_dtype),
            device="meta"),
        build_defs(cfg))


def param_pspecs(cfg: ModelConfig, rules: AxisRules) -> Dict[str, Any]:
    """The tree of every leaf's sharding spec under ``rules``
    (:func:`repro_torch.sharding.rules.logical_to_pspec` of its logical
    names; :func:`repro_torch.sharding.rules.to_placements` makes DTensor
    placements of one)."""
    return _tree_map_defs(
        lambda path, pd: logical_to_pspec(pd.logical, rules),
        build_defs(cfg))


def param_count_actual(cfg: ModelConfig) -> int:
    total = []
    _tree_map_defs(lambda path, pd: total.append(math.prod(pd.shape)),
                   build_defs(cfg))
    return sum(total)


#: leaves that the reference reads in f32 whatever the activation dtype
#: (the SSM's conv weights in its decode step, its dt bias, A and D), which
#: ``cast_params`` leaves as they are
F32_LEAVES = frozenset({"conv_w", "conv_b", "a_log", "d_skip", "dt_bias"})


def cast_params(params: Dict[str, Any], dtype: torch.dtype,
                device=None) -> Dict[str, Any]:
    """A copy of the tree with every floating leaf in ``dtype`` (on
    ``device`` if given), but the ``F32_LEAVES``.  The reference casts each
    weight to the activation dtype at every use; the cast is exact and
    deterministic, so one copy made at load gives the same numbers without
    re-casting the weights at every step."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, dtype, device)
        else:
            v = v.to(device) if device is not None else v
            out[k] = (v.to(dtype) if v.is_floating_point()
                      and k not in F32_LEAVES else v)
    return out
