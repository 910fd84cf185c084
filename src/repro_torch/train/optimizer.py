"""AdamW, its cosine schedule and global-norm clipping on dicts of tensors:
the port of ``repro.train.optimizer``.

A parameter tree is a nested dict of tensors (``models.params``); the
moments mirror it in f32.  ``adamw_update`` is pure, as the reference's:
it returns new parameters and a new state and leaves its arguments as
they were.  ``adamw_update_`` is the same step with the arguments donated,
as the reference's launcher jits it (``donate_argnums``): it writes the
new values into the tensors it was given, a slice at a time.  Leaves are
visited in sorted key order, the order ``jax.tree_util`` gives a dict, so
that sums over leaves (the global norm) add in the reference's order.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Iterator, List, NamedTuple, Optional,
                    Tuple, Union)

import torch

from repro_torch.sharding.per_shard import (is_dtensor, mesh_of,
                                            to_placements_of)

#: ``adamw_update_`` updates a leaf of more elements one slice of its
#: leading axes at a time (an expert, a layer, a run of rows), so that its
#: temporaries stay a few times a slice: 64M elements, 256 MB in f32
DONATE_SLICE_ELEMENTS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # first moment, like params, f32
    nu: Any              # second moment, like params, f32


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order (of a list of
    leaves, the list)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for x in tree for leaf in tree_leaves(x)]
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
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32.

    On DTensor leaves (one mesh) each rank sums the squares of its own
    shards, a replicated block only on the ranks at coordinate 0 of the
    mesh dims it is replicated over (so every element is counted once),
    and the ranks meet in one all-reduce over the flattened mesh; the norm
    comes back replicated.  A partial leaf is reduced first (a train step
    hands over gradients already reduced to their parameters'
    placements).  On a mesh of one rank every term and its order are the
    plain sum's."""
    leaves = tree_leaves(tree)
    mesh = mesh_of(*leaves)
    coord = None if mesh is None else mesh.get_coordinate()
    total = 0
    for x in leaves:
        if is_dtensor(x):
            from torch.distributed.tensor import Replicate

            if any(p.is_partial() for p in x.placements):
                x = to_placements_of(x, [Replicate() if p.is_partial()
                                         else p for p in x.placements])
            if any(c and p.is_replicate()
                   for c, p in zip(coord, x.placements)):
                continue
            x = x.to_local()
        total = total + x.float().square().sum()
    if mesh is None:
        return torch.sqrt(total)
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.rules import flat_sum

    if not isinstance(total, torch.Tensor):
        total = torch.zeros((), dtype=torch.float32,
                            device=leaves[0].to_local().device)
    total = flat_sum(total, mesh)
    return DTensor.from_local(torch.sqrt(total), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))``: the factor that clips
    gradients of global norm ``norm`` to ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(tree · clip_scale(norm, max_norm), norm)``."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, tree), norm


def _bias_corrections(step: torch.Tensor, b1: float, b2: float):
    t = step.float()
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def _upd(g, m, v, p, lr, c1, c2, b1, b2, eps, weight_decay):
    """The reference's AdamW arithmetic for one leaf (or a slice of one):
    ``(new p, new m, new v)``, new tensors."""
    g = g.float()
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g.square()
    mhat = m / c1
    vhat = v / c2
    delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def adamw_update(grads: Any, state: AdamWState, params: Any,
                 lr: Union[torch.Tensor, float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One AdamW step in f32, the reference's arithmetic: bias-corrected
    moments, decoupled weight decay on the parameter, the new parameter
    cast back to its dtype.  Returns ``(new_params, new_state)``."""
    step = state.step + 1
    c1, c2 = _bias_corrections(step, b1, b2)
    out = tree_map(lambda g, m, v, p: _upd(g, m, v, p, lr, c1, c2, b1, b2,
                                           eps, weight_decay),
                   grads, state.mu, state.nu, params)
    return _pick(out, 0), AdamWState(step=step, mu=_pick(out, 1),
                                     nu=_pick(out, 2))


class DonatedStateError(RuntimeError):
    """A train step was given parameters and moments that a donated step
    had half written when it failed: the reference's donated buffers are
    deleted at that point, and these hold neither step's values."""


def check_not_donated(state: AdamWState) -> None:
    """Raise :class:`DonatedStateError` if a failed ``adamw_update_`` had
    written into ``state`` (its ``step`` tensor carries the mark)."""
    if getattr(state.step, "donated", False):
        raise DonatedStateError(
            "this optimizer state (and its parameters) was donated to a "
            "train step that failed after its first write; restore a "
            "checkpoint instead of retrying")


def _chunks(shape: Tuple[int, ...], limit: int) -> Iterator[tuple]:
    """Index tuples whose views cover a tensor of ``shape`` once, each of
    at most ``limit`` elements where a run of its leading axis allows:
    the whole tensor, runs of rows, or (a row above ``limit``) each row's
    own chunks."""
    numel = math.prod(shape)
    if numel <= limit or not shape:
        yield ()
        return
    row = numel // shape[0]
    if row > limit:
        for i in range(shape[0]):
            for rest in _chunks(shape[1:], limit):
                yield (i,) + rest
        return
    n = limit // row
    for i in range(0, shape[0], n):
        yield (slice(i, i + n),)


def adamw_update_(grads: List[Optional[torch.Tensor]], state: AdamWState,
                  params: Any, lr: Union[torch.Tensor, float], *,
                  grad_scale: Union[torch.Tensor, float] = 1.0,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1) -> AdamWState:
    """:func:`adamw_update` of the gradients times ``grad_scale`` (the
    clip), with ``params`` and ``state`` donated: each leaf's new
    parameter, ``mu`` and ``nu`` are written into the tensors given, leaf
    by leaf in sorted key order and a plain leaf of more than
    :data:`DONATE_SLICE_ELEMENTS` one slice at a time (a DTensor leaf, each
    rank's shard, whole), computed by the same
    arithmetic (bitwise the functional step's).  ``grads`` holds the
    gradient leaves in that order; each entry is set to None once its
    leaf is written, so the step holds about 16 bytes a parameter (p, g,
    m, v in f32) where the functional one holds 28.  ``state.step`` is
    advanced in place last.  Returns ``state``.

    A failure after the first write marks ``state`` donated
    (:func:`check_not_donated` then raises); one before it leaves
    everything as it was."""
    check_not_donated(state)
    step = state.step + 1
    c1, c2 = _bias_corrections(step, b1, b2)
    leaves = zip(tree_leaves(params), tree_leaves(state.mu),
                 tree_leaves(state.nu))
    written = False
    try:
        for i, (p, m, v) in enumerate(leaves):
            g, grads[i] = grads[i], None
            # a DTensor leaf is updated whole: its arithmetic runs on each
            # rank's own shard, and a slice of a sharded dim is no view
            for idx in (((),) if is_dtensor(p) else
                        _chunks(tuple(p.shape), DONATE_SLICE_ELEMENTS)):
                new_p, new_m, new_v = _upd(g[idx] * grad_scale, m[idx],
                                           v[idx], p[idx], lr, c1, c2, b1,
                                           b2, eps, weight_decay)
                written = True
                p[idx].copy_(new_p)
                m[idx].copy_(new_m)
                v[idx].copy_(new_v)
            del g
        state.step.copy_(step)
    except BaseException:
        if written:
            state.step.donated = True
        raise
    return state


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
