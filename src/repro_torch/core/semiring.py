"""The algebra behind every propagation sweep (PyTorch port of
``repro.core.semiring``).

Every sweep is one primitive,

    out[v] = ⊕ over in-edges (u, v) of ( values[u] ⊗ weight(u, v) )

and a :class:`Semiring` names the (⊕, ⊗) pair, its identities and the
element dtype:

=============  =====  =====  ========  ===============================
name           ⊕      ⊗      dtype     workload
=============  =====  =====  ========  ===============================
``plus_times`` sum    ×      float32   PageRank, HITS, Katz
``min_plus``   min    \\+     float32   SSSP relaxations
``min_min``    min    min    int32     connected components
``max_times``  max    ×      float32   widest / most-reliable paths
=============  =====  =====  ========  ===============================

``zero`` is ⊕'s identity (what padding and masked edges contribute) and
``one`` is ⊗'s identity (the weight a ``"unit"`` layout bakes); for integer
dtypes ±∞ means the dtype's extrema.  ``merge`` (⊕ of two shards'
partials on one device) and ``all_reduce`` (the same across the ranks of a
device mesh) complete the sharded push.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import flat_mesh

#: ⊕ reduce kinds the backends implement.
ADD_OPS = ("sum", "min", "max")
#: ⊗ combine kinds.
MUL_OPS = ("times", "plus", "min")


def _identity(op: str, dtype: np.dtype, *, lower: bool):
    """The neutral element of ``op`` over ``dtype``: ``sum``/``plus`` → 0,
    ``times`` → 1, ``min`` → +∞ (int max), ``max`` → −∞ (int min);
    ``lower`` selects which extremum."""
    if op in ("sum", "plus"):
        return dtype.type(0)
    if op == "times":
        return dtype.type(1)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(-np.inf if lower else np.inf)
    info = np.iinfo(dtype)
    return dtype.type(info.min if lower else info.max)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair with identities and element dtype (a numpy dtype
    name, so instances stay hashable)."""

    name: str
    add: str = "sum"
    mul: str = "times"
    dtype: str = "float32"

    def __post_init__(self):
        if self.add not in ADD_OPS:
            raise ValueError(f"unknown ⊕ op {self.add!r}; expected {ADD_OPS}")
        if self.mul not in MUL_OPS:
            raise ValueError(f"unknown ⊗ op {self.mul!r}; expected {MUL_OPS}")
        np.dtype(self.dtype)  # fail fast on bogus dtype strings

    @property
    def np_dtype(self) -> np.dtype:
        """The element dtype as a ``np.dtype``."""
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The element dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype)

    @property
    def zero(self):
        """⊕'s identity: what padding, masked edges and empty in-neighbour
        sets contribute (0 for sum, +∞ for min, −∞ for max)."""
        return _identity(self.add, self.np_dtype, lower=(self.add == "max"))

    @property
    def one(self):
        """⊗'s identity: the weight a ``"unit"`` layout bakes (1 for ×, 0
        for +, +∞ for min)."""
        return _identity(self.mul, self.np_dtype, lower=False)

    def combine(self, values: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
        """``values ⊗ weight`` elementwise; narrower stored weights widen to
        the values' dtype first."""
        if weight.dtype != values.dtype:
            weight = weight.to(values.dtype)
        if self.mul == "times":
            return values * weight
        if self.mul == "plus":
            return values + weight
        return torch.minimum(values, weight)

    def segment_reduce(self, contrib: torch.Tensor, segments: torch.Tensor,
                       *, num_segments: int) -> torch.Tensor:
        """⊕-reduce contributions per segment along the last axis; empty
        segments get ``zero``.  ``contrib`` is ``[E]`` or ``[B, E]`` over
        one shared ``segments[E]``."""
        shape = contrib.shape[:-1] + (num_segments,)
        idx = segments.long()
        if self.add == "sum":
            out = torch.zeros(shape, dtype=contrib.dtype, device=contrib.device)
            return out.index_add_(-1, idx, contrib)
        # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
        out = torch.full(shape, self.zero.item(), dtype=contrib.dtype,
                         device=contrib.device)
        return out.scatter_reduce_(-1, idx.expand(contrib.shape), contrib,
                                   reduce="amin" if self.add == "min"
                                   else "amax", include_self=True)

    def merge(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """⊕ of two partial reduces, elementwise: how two shards' partial
        pushes combine on one device."""
        if self.add == "sum":
            return x + y
        if self.add == "min":
            return torch.minimum(x, y)
        return torch.maximum(x, y)

    def all_reduce(self, x: torch.Tensor, group) -> torch.Tensor:
        """⊕ all-reduce of ``x`` across ``group`` (a ``DeviceMesh``, all of
        whose ranks take part, or a process group): the cross-rank merge of
        per-shard partial pushes, ``torch.distributed.all_reduce`` with
        SUM, MIN or MAX.  Reduces ``x`` in place and returns it."""
        if hasattr(group, "get_group"):
            group = flat_mesh(group).get_group()
        op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}[self.add]
        dist.all_reduce(x, op=op, group=group)
        return x


_REGISTRY: Dict[str, Semiring] = {}


def register_semiring(s: Semiring) -> Semiring:
    """Register ``s`` under its name (latest registration wins)."""
    _REGISTRY[s.name] = s
    return s


def available_semirings() -> tuple:
    """Sorted names of every registered semiring."""
    return tuple(sorted(_REGISTRY))


def resolve_semiring(spec: Union[str, Semiring, None]) -> Semiring:
    """Name / instance / ``None`` (→ ``plus_times``) to a :class:`Semiring`."""
    if spec is None:
        return PLUS_TIMES
    if isinstance(spec, Semiring):
        return spec
    try:
        return _REGISTRY[spec]
    except KeyError:
        raise KeyError(
            f"unknown semiring {spec!r}; registered: "
            f"{', '.join(available_semirings())}") from None


PLUS_TIMES = register_semiring(Semiring("plus_times", "sum", "times",
                                        "float32"))
MIN_PLUS = register_semiring(Semiring("min_plus", "min", "plus", "float32"))
MIN_MIN = register_semiring(Semiring("min_min", "min", "min", "int32"))
MAX_TIMES = register_semiring(Semiring("max_times", "max", "times",
                                       "float32"))
