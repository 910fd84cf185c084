"""Logical-to-physical sharding rules (the port of ``repro.sharding.rules``,
MaxText-style logical axis names).

Every parameter is annotated with *logical* axis names
(``models.params.ParamDef.logical``); a rule table maps those to mesh axes.
The tables are the reference's, as data: the single-pod ``(data, model)``
mesh, the multi-pod ``(pod, data, model)`` mesh, or no mesh (rules empty:
nothing sharded).

A spec is the reference's ``PartitionSpec`` as data: a tuple with one entry
per tensor dim, each ``None`` (replicated), a mesh axis name, or a tuple of
names (the dim split over their product), trailing ``None``s trimmed.
:func:`to_placements` turns a spec into the DTensor placements of a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``: for each mesh
dim ``Shard(d)`` of the tensor dim it splits, or ``Replicate()``.  A dim
split over several mesh axes becomes one ``Shard(d)`` per axis, which
DTensor nests in the mesh's dim order: the order every table's specs
name them in (``NamedSharding`` nests in the spec's order), but for the
ZeRO-1 table's ``ff_zero``, which no parameter uses.

:func:`ws` is the reference's ``with_sharding_constraint`` by logical names,
called at the reference's sites of the model code: it redistributes a
DTensor and leaves a plain tensor as it is.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

AxisRules = Dict[str, Tuple[str, ...]]
#: one spec entry: replicated, one mesh axis, or several
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

# ---- rule tables -----------------------------------------------------------

# single-pod (16, 16) mesh: axes ("data", "model")
RULES_SINGLE_POD: AxisRules = {
    "batch": ("data",),
    "ctx": (),                # sequence dim of activations (replicated)
    "ctx_res": ("model",),    # residual-stream seq dim (Megatron-style SP):
                              # layer boundaries keep activations S-sharded so
                              # the per-layer scan carries saved for backward
                              # are 1/16th size; GSPMD all-gathers S around
                              # attention/MLP and reduce-scatters back
    "ctx_shard": ("data",),   # sequence dim when context-parallel (B=1 decode)
    "embed": (),              # d_model dim (activations)
    "embed_p": ("data",),     # d_model dim of PARAMETERS: ZeRO-3/FSDP-style
                              # 2D sharding (data × model) so 132B MoE params
                              # + AdamW state fit 256 chips
    "heads": ("model",),      # attention heads / head*hd fused dims
    "kv_heads": ("model",),   # kv heads (sharded only if divisible)
    "ff": ("model",),         # MLP hidden
    "vocab": ("model",),
    "experts": (),            # MoE expert dim (EP is a hillclimb variant)
    "ssm_heads": ("model",),  # mamba2 heads
    "conv_dim": ("model",),   # mamba2 conv channels
    "layers": (),             # stacked-layer leading dim
    "edges": ("data", "model"),  # veilgraph edge buffers: flattened mesh
    "nodes": (),              # veilgraph node vectors (replicated)
}

# multi-pod (2, 16, 16) mesh: axes ("pod", "data", "model"); pod acts as an
# outer data-parallel axis.
RULES_MULTI_POD: AxisRules = {
    **RULES_SINGLE_POD,
    "batch": ("pod", "data"),
    "ctx_shard": ("data",),
    "edges": ("pod", "data", "model"),
}

# ZeRO-1 style variant: optimizer/parameter ff dims also sharded over data.
RULES_SINGLE_POD_ZERO1: AxisRules = {
    **RULES_SINGLE_POD,
    "ff_zero": ("model", "data"),
}


_state = threading.local()


def set_rules(rules: Optional[AxisRules]) -> None:
    _state.rules = rules


def get_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


@contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names; raises for a mesh without them (the
    rules address mesh axes by name)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("the sharding rules need a DeviceMesh with "
                         "mesh_dim_names")
    return tuple(names)


def flat_mesh(mesh, axes: Optional[Sequence[str]] = None):
    """A 1-D ``DeviceMesh`` over ``axes`` of ``mesh`` (default: every dim),
    its ranks in the mesh's row-major order: the mesh itself when it is
    1-D and ``axes`` names its dim (or none), one axis's submesh, or the
    axes flattened into one (``DeviceMesh._flatten``, which the mesh
    caches; the dims need names)."""
    if axes is None and mesh.ndim == 1:
        return mesh
    names = mesh_axis_names(mesh)
    axes = tuple(axes) if axes is not None else names
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh axis {a!r} not in mesh {names}")
    if axes == names and mesh.ndim == 1:
        return mesh
    if len(axes) == 1:
        return mesh[axes[0]]
    # the mesh's own bookkeeping, outside any fake tensor or counting mode
    # a caller runs under
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return mesh[axes]._flatten()


def flat_sum(x, mesh, axes: Optional[Sequence[str]] = None):
    """``x`` summed over the ranks of ``mesh``'s dims ``axes`` (every dim by
    default): one all-reduce over them flattened (:func:`flat_mesh`), where
    DTensor would run one a dim, in an order the ranks need not share.
    Returns a new tensor."""
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(
        x, "sum", flat_mesh(mesh, axes).get_group()))


def rules_for_mesh(mesh) -> AxisRules:
    """The rule table of a ``DeviceMesh`` (by its dim names), or none
    without a mesh."""
    if mesh is None:
        return {}
    if "pod" in mesh_axis_names(mesh):
        return RULES_MULTI_POD
    return RULES_SINGLE_POD


def _entry(axes: Sequence[str]) -> SpecEntry:
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _trim(out: list) -> Spec:
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_to_pspec(logical: Sequence[Optional[str]],
                     rules: Optional[AxisRules] = None) -> Spec:
    """Map logical axis names (None = replicated) to a spec; a mesh axis
    is never used twice in one spec."""
    rules = rules if rules is not None else (get_rules() or {})
    out = []
    used: set = set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a not in used)
        used.update(axes)
        out.append(_entry(axes))
    return _trim(out)


def guarded_pspec(shape: Sequence[int], logical: Sequence[Optional[str]],
                  rules: AxisRules, axis_sizes: Dict[str, int]) -> Spec:
    """:func:`logical_to_pspec` with divisibility guards.

    A mesh axis is applied to a dim only if the dim is divisible by the
    product of the axes selected so far times that axis (e.g. qwen2's
    2 kv-heads are NOT sharded over a 16-way model axis — replicated
    instead), and an axis is never used twice in one spec (so a decode
    cache with batch=1 automatically falls through to context-parallel
    sharding of the sequence dim when the rules list both).
    """
    out = []
    used: set = set()
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        sel = []
        prod = 1
        for a in rules.get(name, ()):
            if a in used:
                continue
            nxt = prod * axis_sizes.get(a, 1)
            if nxt > 0 and dim % nxt == 0 and dim >= nxt:
                sel.append(a)
                prod = nxt
        used.update(sel)
        out.append(_entry(sel))
    return _trim(out)


def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``.  A mesh dim of size 1 splits nothing and is
    ``Replicate()`` whatever the spec names: the same layout, but a
    tensor dim of size 1 marked sharded (a batch of one over a ``data``
    axis of one) could not be flattened by DTensor's views.  Raises for an
    axis the mesh does not have."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if axis not in names:
                raise ValueError(f"spec {spec} names mesh axis {axis!r}; the "
                                 f"mesh has {names}")
            if mesh.size(names.index(axis)) > 1:
                out[names.index(axis)] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    :attr:`placements` are its DTensor placements."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def named_sharding(mesh, *logical: Optional[str]) -> NamedSharding:
    """The sharding of the logical names under the mesh's rule table."""
    return NamedSharding(mesh, logical_to_pspec(logical,
                                                rules_for_mesh(mesh)))


def ws(x, *logical: Optional[str]):
    """The reference's sharding constraint by logical axis names: ``x`` as
    it is without rules or for a plain tensor; a DTensor redistributed to
    the placements of its names on its own mesh, each axis applied where
    it divides the dim (``guarded_pspec``: GSPMD pads an uneven dim, which
    DTensor's views and products do not take; a decode step's one
    position stays whole)."""
    from torch.distributed.tensor import DTensor

    rules = get_rules()
    if not rules or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh_axis_names(mesh), mesh.mesh.shape))
    spec = guarded_pspec(x.shape, logical, rules, sizes)
    return x.redistribute(mesh, to_placements(spec, mesh))


def local_index(shape, mesh, placements) -> Tuple[slice, ...]:
    """The global index of this rank's local shard of a DTensor of
    ``shape`` placed by ``placements`` (``Shard``/``Replicate``) on
    ``mesh``: each ``Shard(d)`` splits dim ``d``'s current range into
    ``mesh.size(i)`` chunks as ``torch.chunk`` does, in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard

    ranges = [[0, n] for n in shape]
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Replicate):
            continue
        if not isinstance(pl, Shard):
            raise ValueError(f"placement {pl} is not Shard or Replicate")
        lo, hi = ranges[pl.dim]
        chunk = -(-(hi - lo) // mesh.size(i))
        start = min(lo + coord[i] * chunk, hi)
        ranges[pl.dim] = [start, min(start + chunk, hi)]
    return tuple(slice(lo, hi) for lo, hi in ranges)


def place(full, sharding: NamedSharding):
    """A host array (numpy) as a DTensor under ``sharding``, this rank
    holding its own shard of it, on its mesh's device: no collective, so
    every rank passes the whole array."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding.mesh, sharding.placements
    dev = (torch.device("cpu") if mesh.device_type == "cpu" else
           torch.device(mesh.device_type, torch.cuda.current_device()))
    # np.array: a contiguous copy that keeps a 0-d array 0-d
    local = np.array(full[local_index(full.shape, mesh, placements)])
    return DTensor.from_local(
        torch.from_numpy(local).to(dev), mesh, placements,
        shape=torch.Size(full.shape),
        stride=torch.empty(full.shape, device="meta").stride())
