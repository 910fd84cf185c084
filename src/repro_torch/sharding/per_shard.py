"""The model's per-shard regions on DTensor activations.

The reference's GSPMD propagates shardings through every op by itself;
DTensor has a rule for most ops but not for the ones the model's hot
regions are built from (the attention kernels, the SSD scan, the MoE's
index scatter and gather) and none for the ``_StridedShard`` placements a
head reshape of a sharded projection makes.  So those regions run per
shard, under ``torch.distributed.tensor.experimental.local_map``: their
DTensor inputs are redistributed to the placements named here (batch on
the rule table's ``batch`` axes, heads on ``model`` where both the query
and the key/value head counts divide), each rank runs the plain-tensor
code on its local shards (on the card the CUDA kernels, on a CPU tensor
their plain versions), and the outputs come back as DTensors of the same
placements.

On plain tensors every function here is the identity or calls the region
directly, so a model run on plain tensors keeps its bits.  Nothing is
caught: an op without a DTensor rule outside these regions raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.rules import (Spec, flat_sum, get_rules,
                                        guarded_pspec, rules_for_mesh,
                                        to_placements)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_of(*xs):
    """The device mesh of the first DTensor among ``xs``, or None."""
    for x in xs:
        if is_dtensor(x):
            return x.device_mesh
    return None


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def guarded_spec(mesh, shape: Sequence[int],
                 logical: Sequence[Optional[str]]) -> Spec:
    """``guarded_pspec`` of ``shape`` under the ambient rules (else the
    mesh's own table) and the mesh's axis sizes."""
    rules = get_rules() or rules_for_mesh(mesh)
    return guarded_pspec(shape, logical, rules, _sizes(mesh))


def replicate_like(x, t: torch.Tensor):
    """``t`` (a tensor the model makes itself: a mask, positions, a rope
    table, a zero state) as a replicated DTensor on ``x``'s mesh when
    ``x`` is a DTensor; else ``t``."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def head_spec(mesh, batch: int, heads: int) -> Spec:
    """The per-shard spec of an attention region's fused ``(B, S, heads ·
    d)`` tensors: batch by the ``batch`` rule, the fused dim by the
    ``heads`` rule where ``heads`` (the key/value head count, which
    divides the query heads) is divisible, so each rank holds whole heads
    and whole GQA groups."""
    spec = guarded_spec(mesh, (batch, 1, heads), ("batch", None, "heads"))
    return spec + (None,) * (3 - len(spec))


def batch_spec(mesh, shape: Sequence[int], dim: int = 0) -> Spec:
    """The spec of ``shape`` with only dim ``dim`` laid over the ``batch``
    rule (where it divides)."""
    logical = [None] * len(shape)
    logical[dim] = "batch"
    return guarded_spec(mesh, shape, logical)


def run(fn: Callable, args: tuple, in_specs: Sequence[Optional[Spec]],
        out_specs):
    """``fn(*args)`` per shard: with a DTensor among ``args``, under
    ``local_map`` with each tensor argument redistributed to its spec of
    ``in_specs`` (``None`` for a non-tensor) and the outputs, one spec
    each in ``out_specs`` (a spec, or a tuple of specs for a tuple of
    outputs), made DTensors again; else ``fn(*args)`` itself."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    place = lambda s: None if s is None else to_placements(s, mesh)
    outs = (tuple(place(s) for s in out_specs)
            if isinstance(out_specs, list) else (place(out_specs),))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(place(s) for s in in_specs),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def vocab_lookup(table, ids):
    """``table[ids]``: the rows of a ``(V, d)`` embedding table.  On a
    DTensor table, per shard: the table's vocabulary split kept and its
    other dims gathered, the ids on the ``batch`` rule's axes, each rank
    taking the rows its vocabulary range holds (zero elsewhere), then one
    sum over the vocabulary axes, which adds each row to zeros (exact).
    DTensor's own ``embedding`` marks its output a masked partial whose
    mask a 2-D mesh mismatches, so the region does not use it."""
    if not is_dtensor(table):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import local_index

    mesh = table.device_mesh
    vocab = tuple(Shard(0) if p == Shard(0) else Replicate()
                  for p in table.placements)
    table = table.redistribute(placements=vocab)
    if not is_dtensor(ids):
        ids = replicate_like(table, ids)
    id_pl = to_placements(batch_spec(mesh, ids.shape), mesh)
    id_pl = tuple(Replicate() if v == Shard(0) else p
                  for p, v in zip(id_pl, vocab))
    lo = local_index(table.shape, mesh, vocab)[0].start

    def rows(t, i):
        i = i.long() - lo
        hit = (i >= 0) & (i < t.shape[0])
        got = t[i.clamp(0, max(t.shape[0] - 1, 0))]
        return torch.where(hit[..., None], got, torch.zeros_like(got))
    out_pl = tuple(Partial() if v == Shard(0) else p
                   for p, v in zip(id_pl, vocab))
    # a rank's table gradient covers its own ids' rows only: a partial
    # sum over the mesh dims the ids are split over
    grad_pl = tuple(v if v == Shard(0) else Partial() if p.is_shard()
                    else Replicate() for p, v in zip(id_pl, vocab))
    out = local_map(rows, out_placements=(out_pl,),
                    in_placements=(vocab, id_pl),
                    in_grad_placements=(grad_pl, id_pl), device_mesh=mesh,
                    redistribute_inputs=True)(table, ids)
    return out.redistribute(placements=tuple(
        Replicate() if p == Partial() else p for p in out_pl))


def to_placements_of(x, placements):
    """DTensor ``x`` redistributed to ``placements``.  Where ``x`` is
    partial over several mesh dims that ``placements`` replicate, and
    agrees with it on every other dim, the sum is one all-reduce over
    those dims flattened, where DTensor's redistribute would run one a
    dim, in an order the ranks need not share."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    dims = [i for i, p in enumerate(x.placements) if p.is_partial()]
    same = all(p == q for i, (p, q) in enumerate(zip(x.placements,
                                                     placements))
               if i not in dims)
    if (len(dims) < 2 or not same
            or not all(placements[i].is_replicate() for i in dims)):
        return x.redistribute(placements=placements)
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    local = flat_sum(x.to_local(), mesh,
                     [mesh.mesh_dim_names[i] for i in dims])
    return DTensor.from_local(local, mesh, placements, shape=x.shape,
                              stride=x.stride(), run_check=False)


def held_as(cache, spec: Spec, mesh):
    """``(view, write_back)`` for a cache leaf a region updates in place:
    on a DTensor whose placements differ from ``spec``'s (a
    context-parallel cache, sequence over ``data``), a copy redistributed
    to ``spec`` and a function that writes it back into ``cache``; else
    ``cache`` itself and a no-op (also on a plain tensor)."""
    if not is_dtensor(cache):
        return cache, lambda: None
    want = to_placements(spec, mesh)
    if tuple(cache.placements) == tuple(want):
        return cache, lambda: None
    held = cache.redistribute(placements=want)

    def write_back():
        cache.copy_(held.redistribute(placements=cache.placements))
    return held, write_back


__all__ = ["batch_spec", "guarded_spec", "head_spec", "held_as",
           "is_dtensor", "mesh_of", "replicate_like", "run",
           "to_placements_of", "vocab_lookup"]
