"""Input specs and shardings per (architecture x shape x mesh) cell: the
port of ``repro.launch.specs``.

``input_specs(cfg, shape)`` returns ``meta`` tensors standing in for every
model input (their shapes and dtypes, nothing allocated), as the
reference's ``ShapeDtypeStruct`` stand-ins; ``input_pspecs`` the matching
specs (the spec tuples of :mod:`repro_torch.sharding.rules`, through
``guarded_pspec``).  ``cell_spec`` bundles what the dry run needs to run
one cell: the step function of :mod:`repro_torch.train.step`, its abstract
arguments, their specs and the positions the step donates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.params import (_tree_map_defs, abstract_params,
                                       build_defs)
from repro_torch.models.transformer import init_cache
from repro_torch.sharding.rules import AxisRules, Spec, guarded_pspec
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step)


def text_and_prefix_lens(cfg: ModelConfig,
                         shape: ShapeConfig) -> Tuple[int, int]:
    """Split a cell's seq_len into (text tokens, frontend prefix/frames)."""
    if cfg.frontend == "vision":
        pref = min(cfg.frontend_len, shape.seq_len // 2)
        return shape.seq_len - pref, pref
    if cfg.encoder_layers > 0:
        # half the budget to encoder frames, half to decoder tokens
        return shape.seq_len // 2, shape.seq_len // 2
    return shape.seq_len, 0


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the cell runs; otherwise why it is skipped (the
    reference's reason)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full quadratic attention at 524288 would need a "
                "sub-quadratic mechanism this arch does not have")
    return None


def param_pspecs_guarded(cfg: ModelConfig, rules: AxisRules,
                         sizes: Dict[str, int]):
    """Every parameter's spec, guarded by the mesh's axis sizes."""
    return _tree_map_defs(
        lambda path, pd: guarded_pspec(pd.shape, pd.logical, rules, sizes),
        build_defs(cfg))


def _cache_pspec(path: Tuple[str, ...], leaf, rules: AxisRules,
                 sizes: Dict[str, int]) -> Spec:
    """Sharding for one cache leaf, chosen by its owner key and rank.

    KV caches (L, B, S, KV, hd): batch over data when divisible, else the
    sequence dim context-parallel (guarded_pspec's used set handles the
    fall-through).  Mamba conv (L, B, K, C): channels over model; SSM
    state (L, B, H, P, N): heads over model.  MLA latent (L, B, S, r):
    replicated rank."""
    name = path[0]
    nd = len(leaf.shape)
    if name in ("kv", "attn", "self", "cross"):
        logical = ("layers", "batch", "ctx_shard", "kv_heads", None)[:nd]
    elif name == "mla":
        logical = ("layers", "batch", "ctx_shard", None)[:nd]
    elif name == "ssm":
        if nd == 4:      # conv (L, B, K, C)
            logical = ("layers", "batch", None, "conv_dim")
        else:            # state (L, B, H, P, N)
            logical = ("layers", "batch", "ssm_heads", None, None)
    else:
        logical = (None,) * nd
    return guarded_pspec(leaf.shape, logical, rules, sizes)


def cache_pspecs(cache, rules: AxisRules, sizes: Dict[str, int]):
    """The spec of every leaf of a cache tree."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return _cache_pspec(path, tree, rules, sizes)
    return walk(cache)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend(cfg: ModelConfig, b: int, prefix_len: int,
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _meta((b, prefix_len, cfg.d_model),
                                      torch.float32)
    if cfg.encoder_layers > 0:
        batch["frames"] = _meta((b, prefix_len, cfg.d_model), torch.float32)
    return batch


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The cell's serving caches as ``meta`` tensors."""
    _, prefix_len = text_and_prefix_lens(cfg, shape)
    enc_len = prefix_len if cfg.encoder_layers > 0 else 0
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      enc_len=enc_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for one cell (``meta`` tensors)."""
    b = shape.global_batch
    text_len, prefix_len = text_and_prefix_lens(cfg, shape)
    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": _meta((b, text_len), i32),
                 "labels": _meta((b, text_len), i32)}
        return {"batch": _frontend(cfg, b, prefix_len, batch)}
    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, text_len), i32)}
        return {"batch": _frontend(cfg, b, prefix_len, batch)}
    # decode: one new token against a seq_len-deep cache
    return {"cache": abstract_cache(cfg, shape),
            "token": _meta((b, 1), i32), "pos": _meta((), i32)}


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, specs: Dict[str, Any],
                 rules: AxisRules, sizes: Dict[str, int]) -> Dict[str, Any]:
    """The specs of :func:`input_specs`' tree: batch leaves over
    ``batch``, caches by :func:`cache_pspecs`, the position replicated."""
    def batch_spec(t):
        logical = ("batch",) + (None,) * (t.ndim - 1)
        return guarded_pspec(t.shape, logical, rules, sizes)

    out: Dict[str, Any] = {}
    if "batch" in specs:
        out["batch"] = {k: batch_spec(v) for k, v in specs["batch"].items()}
    if "cache" in specs:
        out["cache"] = cache_pspecs(specs["cache"], rules, sizes)
        out["token"] = guarded_pspec(specs["token"].shape, ("batch", None),
                                     rules, sizes)
        out["pos"] = ()
    return out


@dataclasses.dataclass
class CellSpec:
    """Everything needed to run one (arch x shape) cell on a mesh."""
    arch: str
    shape: ShapeConfig
    step_fn: Callable
    args: Tuple              # abstract positional args (meta tensors)
    in_pspecs: Tuple         # the matching spec tree
    out_pspecs: Any          # the outputs' specs
    donate: Tuple[int, ...]  # donated positional args


def cell_spec(cfg: ModelConfig, arch: str, shape: ShapeConfig,
              rules: AxisRules, sizes: Dict[str, int]) -> CellSpec:
    """The step, abstract arguments and specs of one cell: the donated
    train step with remat, the prefill step over a ``seq_len`` cache, or
    the serve step against one."""
    p_abs = abstract_params(cfg)
    p_ps = param_pspecs_guarded(cfg, rules, sizes)
    specs = input_specs(cfg, shape)
    in_ps = input_pspecs(cfg, shape, specs, rules, sizes)
    logits_ps = guarded_pspec((shape.global_batch, cfg.vocab_size),
                              ("batch", "vocab"), rules, sizes)
    if shape.kind == "train":
        o_abs = adamw_init(p_abs)
        o_ps = AdamWState(step=(), mu=p_ps, nu=p_ps)
        metrics_ps = {"loss": (), "accuracy": (), "grad_norm": (), "lr": ()}
        return CellSpec(arch, shape, make_train_step(cfg, remat=True),
                        (p_abs, o_abs, specs["batch"]),
                        (p_ps, o_ps, in_ps["batch"]),
                        (p_ps, o_ps, metrics_ps), donate=(0, 1))
    if shape.kind == "prefill":
        cache_ps = cache_pspecs(abstract_cache(cfg, shape), rules, sizes)
        return CellSpec(arch, shape,
                        make_prefill_step(cfg, cache_len=shape.seq_len),
                        (p_abs, specs["batch"]), (p_ps, in_ps["batch"]),
                        (logits_ps, cache_ps), donate=())
    return CellSpec(arch, shape, make_serve_step(cfg),
                    (p_abs, specs["cache"], specs["token"], specs["pos"]),
                    (p_ps, in_ps["cache"], in_ps["token"], in_ps["pos"]),
                    (logits_ps, in_ps["cache"]), donate=(1,))


__all__ = ["CellSpec", "abstract_cache", "cache_pspecs", "cell_spec",
           "input_pspecs", "input_specs", "param_pspecs_guarded",
           "skip_reason", "text_and_prefix_lens"]
