"""Receiver-sorted edge order derived from the padded COO buffer (PyTorch
port of ``repro.graph.csr``).

Every push consumes the edges sorted by receiving endpoint with per-receiver
``row_offsets``: on the card that is a CSR matrix the SpMV kernel reads row
by row.  The engine sorts once per applied update batch and reuses the
result across queries and across each query's ~30 power iterations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.semiring import resolve_semiring
from .graph import GraphState


class SortedEdges(NamedTuple):
    """Edges permuted so the receiving endpoint is non-decreasing.

    ``src`` is the emitting endpoint and ``dst`` the receiving one in the
    chosen orientation (with ``reverse=True``, ``src`` holds original
    destinations).  Padding and tombstone slots sort to the end with
    ``dst = node_capacity``.  ``order`` maps sorted position to original
    edge slot.
    """

    src: torch.Tensor          # int32[E_cap]
    dst: torch.Tensor          # int32[E_cap] (n_cap = padding)
    valid: torch.Tensor        # bool[E_cap]
    row_offsets: torch.Tensor  # int32[N_cap + 1]
    order: torch.Tensor        # int32[E_cap]


def sort_by_dst(state: GraphState, *, reverse: bool = False) -> SortedEdges:
    """Stable-sort live edges by receiving endpoint (``state.src`` when
    ``reverse``), invalid slots last."""
    mask = state.edge_mask()
    n = state.node_capacity
    e_src, e_dst = (state.dst, state.src) if reverse else (state.src, state.dst)
    key = torch.where(mask, e_dst, n)
    dst_s, order = torch.sort(key, stable=True)
    row_offsets = torch.searchsorted(
        dst_s, torch.arange(n + 1, dtype=torch.int32, device=state.device),
        side="left", out_int32=True)
    return SortedEdges(e_src[order], dst_s, mask[order], row_offsets,
                       order.to(torch.int32))


def gather_push(
    edges,
    values: torch.Tensor,
    num_segments: int,
    *,
    weight: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    semiring=None,
) -> torch.Tensor:
    """out[v] = ⊕ over sorted in-edges (u, v) of values[u] ⊗ weight(u, v).

    The plain segment-reduce form of :func:`repro_torch.core.backend.push`.
    ``edges`` is anything with ``src``/``dst``/``valid`` fields over one
    edge order; ``values`` is ``[N]`` or ``[B, N]`` (rows reduce
    independently).  ``semiring`` is a resolved
    :class:`~repro_torch.core.semiring.Semiring` (``None`` = sum of
    products); masked and invalid edges contribute the ⊕-identity.
    """
    s = resolve_semiring(semiring)
    contrib = values[..., edges.src]
    if weight is not None:
        contrib = s.combine(contrib, weight)
    keep = edges.valid if mask is None else (edges.valid & mask)
    # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
    contrib = torch.where(keep, contrib, s.zero.item())
    # the padding sentinel (= node capacity) clamps into range; its
    # contribution is already the reduce identity
    dst = edges.dst.clamp(max=num_segments - 1)
    return s.segment_reduce(contrib, dst, num_segments=num_segments)
