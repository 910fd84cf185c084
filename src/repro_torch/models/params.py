"""Parameter definitions: one source of truth for shape, init and dtype.

The port of ``repro.models.params`` for the dense GQA, MoE and SSM
families.
``build_defs(cfg)`` returns a tree (nested dicts) of ``ParamDef`` leaves,
and ``init_params`` materializes it.  Per-layer weights keep the
reference's stacked ``[L, ...]`` leaves, so that
``convert.lm_params_from_numpy`` maps the JAX tree one for one.  The
reference's logical sharding names wait for the sharding slice (ROADMAP
queue 1 entry 15).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

#: the ROADMAP entry that holds the model families the port does not have
NOT_PORTED_ENTRY = "ROADMAP queue 1 entry 17b"


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | small_normal
    dtype: Optional[str] = None   # override cfg.param_dtype


#: the model families the port builds
PORTED_FAMILIES = ("dense", "moe", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense GQA, MoE or SSM (Mamba2) decoder,
    the families the port builds; the others wait for their ROADMAP
    entry."""
    missing = [name for name, present in (
        ("MLA", cfg.mla is not None), ("hybrid", cfg.family == "hybrid"),
        ("encoder-decoder", cfg.encoder_layers > 0),
        ("modality frontend", cfg.frontend is not None)) if present]
    if missing or cfg.family not in PORTED_FAMILIES:
        what = ", ".join(missing) or f"family {cfg.family!r}"
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet ({NOT_PORTED_ENTRY}); "
            f"the port builds dense GQA, MoE and SSM models only")


def _attn_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    """GQA attention projections, stacked over ``layers``."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((layers, d, h * hd)),
        "wk": ParamDef((layers, d, kv * hd)),
        "wv": ParamDef((layers, d, kv * hd)),
        "wo": ParamDef((layers, h * hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((layers, h * hd), "zeros")
        defs["bk"] = ParamDef((layers, kv * hd), "zeros")
        defs["bv"] = ParamDef((layers, kv * hd), "zeros")
    return defs


def _mlp_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": ParamDef((layers, d, ff)),
        "w_down": ParamDef((layers, ff, d)),
    }
    if cfg.mlp_gated:
        defs["w_gate"] = ParamDef((layers, d, ff))
    return defs


def _moe_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": ParamDef((layers, d, e)),
        "w_gate": ParamDef((layers, e, d, ff)),
        "w_up": ParamDef((layers, e, d, ff)),
        "w_down": ParamDef((layers, e, ff, d)),
    }


def _ssm_defs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn = s.n_groups * s.d_state
    cdim = s.conv_dim(d)
    return {
        "in_proj": ParamDef((layers, d, 2 * di + 2 * gn + nh)),  # z x B C dt
        "conv_w": ParamDef((layers, s.conv_kernel, cdim), "small_normal"),
        "conv_b": ParamDef((layers, cdim), "zeros"),
        "a_log": ParamDef((layers, nh), "ones"),
        "d_skip": ParamDef((layers, nh), "ones"),
        "dt_bias": ParamDef((layers, nh), "zeros"),
        "norm": ParamDef((layers, di), "ones"),
        "out_proj": ParamDef((layers, di, d)),
    }


def _block_norms(layers: int, d: int, n: int = 2) -> Dict[str, ParamDef]:
    return {f"norm{i}": ParamDef((layers, d), "ones") for i in range(n)}


def build_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter-definition tree of a dense GQA, MoE or SSM model."""
    require_ported(cfg)
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    defs: Dict[str, Any] = {
        "embed": {"tok": ParamDef((v, d), "small_normal")},
        "final_norm": ParamDef((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), "small_normal")
    if cfg.family == "ssm":
        defs["blocks"] = {"ssm": _ssm_defs(cfg, L), **_block_norms(L, d, 1)}
    else:
        defs["blocks"] = {"attn": _attn_defs(cfg, L),
                          "mlp": (_moe_defs(cfg, L) if cfg.moe is not None
                                  else _mlp_defs(cfg, L)),
                          **_block_norms(L, d, 2)}
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
