"""Convenience wrappers: padded-COO graph -> sorted layout -> one push
(PyTorch port of ``repro.kernels.spmv.ops``).

Thin layers over the propagation backend (:mod:`repro_torch.core.backend`):
build (or accept) a destination-sorted :class:`~repro_torch.core.backend.
EdgeLayout` and run one :func:`~repro_torch.core.backend.push` through it.
The device of ``values`` picks the route, as everywhere in the port: a CUDA
tensor launches the SpMV kernel (``spmv_push`` for sums, ``spmv_reduce_push``
for min/max, their batched forms for ``[B, N]`` values) and a CPU tensor
takes the kernel's plain version.  There is no ``interpret=`` argument, and
no ``tile_n``/``chunk``: the kernels' one geometry knob, the merge-path
tile, is stamped on a layout by the engine's tuner.

Callers issuing repeated pushes should build the layout once
(:func:`repro_torch.core.backend.build_layout`, or the engine's cached
layouts) and pass it in: re-sorting per push is the cost a layout
amortizes away.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.backend import (AnyEdgeLayout, EdgeLayout, build_layout,
                                      push)
from repro_torch.graph.graph import GraphState
from repro_torch.graph.partition import (build_sharded_layout,
                                         place_sharded_layout)


def semiring_push(state: GraphState, values: torch.Tensor, *,
                  semiring: str = "plus_times",
                  weight: str = "unit",
                  layout: Optional[EdgeLayout] = None) -> torch.Tensor:
    """One kernel-backed push over any registered semiring:
    ``out[v] = ⊕_{(u,v)∈E} values[u] ⊗ weight(u, v)`` (e.g.
    ``semiring="min_plus", weight="length"`` is one Bellman-Ford
    relaxation step).  ``values`` is ``[N]`` or ``[B, N]``."""
    if layout is None:
        layout = build_layout(state, weight=weight, semiring=semiring)
    return push(values, layout, semiring=semiring)


def sharded_semiring_push(state: GraphState, values: torch.Tensor, *,
                          mesh=None, axes: Optional[Tuple[str, ...]] = None,
                          num_shards: Optional[int] = None,
                          semiring: str = "plus_times",
                          weight: str = "unit",
                          layout: Optional[AnyEdgeLayout] = None,
                          slots: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """:func:`semiring_push` over edge shards: builds (or accepts) a
    :class:`~repro_torch.core.backend.ShardedEdgeLayout` and runs one
    kernel push per shard, the partials merged by ⊕ and, with a ``mesh``
    (a 1-D ``DeviceMesh``), all-reduced over it.  ``mesh=None`` with
    ``num_shards`` runs every shard here.  ``slots`` replaces the
    contiguous cut with an explicit slot→shard assignment (see
    :func:`repro_torch.graph.partition.balanced_shard_slots`).  Builds the
    layout on every call without ``layout=``."""
    if layout is None:
        layout = place_sharded_layout(build_sharded_layout(
            state, mesh=mesh, axes=axes, num_shards=num_shards,
            weight=weight, semiring=semiring, slots=slots))
    return push(values, layout, semiring=semiring)


def pagerank_push(state: GraphState, ranks: torch.Tensor, *,
                  layout: Optional[EdgeLayout] = None) -> torch.Tensor:
    """One power-iteration push: ``out[v] = Σ_{(u,v)∈E} ranks[u]/d_out(u)``,
    the ``plus_times``/``inv_out`` specialization of
    :func:`semiring_push`."""
    return semiring_push(state, ranks, semiring="plus_times",
                         weight="inv_out", layout=layout)
