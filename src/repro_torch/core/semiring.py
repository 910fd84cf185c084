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
dtypes ±∞ means the dtype's extrema.  The cross-device ⊕ (``merge``,
``all_reduce``) belongs to the sharded push, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

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

    def merge(self, x, y):
        """⊕ of two shards' partial pushes: part of the sharded push, not
        ported yet."""
        raise NotImplementedError(
            "Semiring.merge belongs to the sharded push (ROADMAP queue 1 "
            "entry 15)")

    def all_reduce(self, x, axis_name):
        """Cross-device ⊕ all-reduce: part of the sharded push, not ported
        yet."""
        raise NotImplementedError(
            "Semiring.all_reduce belongs to the sharded push (ROADMAP queue "
            "1 entry 15)")


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
