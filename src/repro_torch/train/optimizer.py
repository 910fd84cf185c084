"""AdamW, its cosine schedule and global-norm clipping on dicts of tensors:
the port of ``repro.train.optimizer``.

A parameter tree is a nested dict of tensors (``models.params``); the
moments mirror it in f32.  The functions are pure, as the reference's:
``adamw_update`` returns new parameters and a new state and leaves its
arguments as they were.  Leaves are visited in sorted key order, the
order ``jax.tree_util`` gives a dict, so that sums over leaves (the global
norm) add in the reference's order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # first moment, like params, f32
    nu: Any              # second moment, like params, f32


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure, rebuilt as a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def adamw_init(params: Any) -> AdamWState:
    """Zero moments like ``params`` and step 0, on the parameters'
    device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(tree · min(1, max_norm / max(norm, 1e-9)), norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def adamw_update(grads: Any, state: AdamWState, params: Any,
                 lr: Union[torch.Tensor, float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One AdamW step in f32, the reference's arithmetic: bias-corrected
    moments, decoupled weight decay on the parameter, the new parameter
    cast back to its dtype.  Returns ``(new_params, new_state)``."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, grads, state.mu, state.nu, params)
    return _pick(out, 0), AdamWState(step=step, mu=_pick(out, 1),
                                     nu=_pick(out, 2))


def _pick(tree: Any, i: int) -> Any:
    """The ``i``-th entry of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """``lr(step)`` as an f32 tensor: linear warm-up over ``warmup`` steps,
    then half a cosine from ``base_lr`` down to 0 at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
