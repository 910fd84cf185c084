"""Traversal workloads on min/max semirings: SSSP, widest path and connected
components (PyTorch port of ``repro.core.traversal``, non-batched part).

Each is the same sweep as PageRank over another algebra:

- **SSSP** is Bellman-Ford on ``min_plus``: ``dist(v) = min(dist(v),
  min_{(u,v)} dist(u) + len(u,v))`` with sources pinned to 0, over a
  ``weight="length"`` layout (unit lengths unless the graph carries
  streamed ones).
- **Widest path** is the same relaxation on ``max_times`` with sources
  pinned to 1; lengths are non-negative reliabilities and unreached
  vertices hold 0.
- **Connected components** is label-min propagation on ``min_min`` over
  int32 labels, pushed over a forward and a reverse unit layout per
  iteration (weak connectivity).

Every sweep iterates to a fixed point (no element changed) or the
iteration budget.  The loop runs on the host and reads the changed count
back once per iteration, so its trip count is the JAX package's exactly.
The summarized versions relax only the hot set K against E_K and the
frozen cold boundary ``b_in``; cold values carry over.  Min and max give
the same answer in any order, so every result here is bitwise equal to the
reference's on the same inputs.  The ``*_batched`` sweeps run B queries
of the serving engine over one shared summary, one batched push per
relaxation (two for connected components), each row bitwise equal to its
single-query sweep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import backend as B
from repro_torch.core.pagerank import SummaryBuffers, _keep, _set_drop
from repro_torch.graph.graph import GraphState

#: int32 "+∞": the label of never-seen vertices and empty reduces
LABEL_SENTINEL = torch.iinfo(torch.int32).max

_INF = float("inf")


def _fixed_point(step, x0: torch.Tensor,
                 num_iters: int) -> Tuple[torch.Tensor, int]:
    """Iterate ``x = step(x)`` until no element changes or the budget runs
    out; returns ``(x, iterations)``.  The relaxations are monotone, so
    "nothing changed" is the fixed point exactly."""
    x, i, changed = x0, 0, 1
    while i < num_iters and changed > 0:
        new_x = step(x)
        changed = int((new_x != x).sum())
        x, i = new_x, i + 1
    return x, i


def _fixed_point_batched(step, x0: torch.Tensor, num_iters: int,
                         row_mask: Optional[torch.Tensor]):
    """Batched :func:`_fixed_point` over ``[B, K]`` rows: rows masked out
    by ``row_mask`` (bool[B], None = all live) carry their state unchanged
    and report zero change.  Iterates until no row changes (the rows
    converge unevenly; the per-row change counts are the serving engine's
    convergence signal).  Returns ``(x, iterations, changed_rows
    i32[B])``."""
    keep = _keep(row_mask, x0.shape[0], x0.device)
    x, i, go = x0, 0, True
    changed = torch.ones(x0.shape[0], dtype=torch.int32, device=x0.device)
    while i < num_iters and go:
        new_x = torch.where(keep, step(x), x)
        changed = (new_x != x).sum(dim=1, dtype=torch.int32)
        go = bool(changed.max() > 0)
        x, i = new_x, i + 1
    return x, i, changed


def _scatter_rows(prev: torch.Tensor, hot_ids: torch.Tensor,
                  local: torch.Tensor, row_mask: Optional[torch.Tensor]):
    """The hot rows written back into ``prev`` [B, N], masked rows kept."""
    out = _set_drop(prev, hot_ids, local)
    if row_mask is None:
        return out
    return torch.where(row_mask[:, None], out, prev)


def _hot_view(summary: SummaryBuffers, n: int):
    """``(local_valid, hot_c)``: which of the K_cap local slots hold a hot
    vertex, and ``hot_ids`` clamped into ``[0, n)`` for gathers (padding
    slots hold the ``n`` sentinel; their gathers are masked)."""
    k_cap = summary.hot_ids.shape[0]
    local_valid = (torch.arange(k_cap, dtype=torch.int32,
                                device=summary.hot_ids.device)
                   < summary.num_hot)
    return local_valid, summary.hot_ids.clamp(max=n - 1)


# --------------------------------------------------------------------------
# SSSP: Bellman-Ford on min_plus
# --------------------------------------------------------------------------


def sssp(
    state: GraphState,
    source_mask: torch.Tensor,
    dist0: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 30,
    layout: Optional[B.EdgeLayout] = None,
) -> Tuple[torch.Tensor, int]:
    """Bounded Bellman-Ford from the vertices in ``source_mask``; returns
    ``(dist f32[N_cap], iterations)`` with ``inf`` where unreachable.

    ``dist0`` warm-starts (exact under edge additions); sources are pinned
    to 0 regardless.  ``layout`` is a cached ``weight="length"``/
    ``min_plus`` layout; without one the sweep builds it on entry.
    """
    B.require_layout(layout, weight="length", reverse=False, who="sssp",
                     semiring="min_plus")
    d0 = (torch.full(source_mask.shape, _INF, dtype=torch.float32,
                     device=source_mask.device)
          if dist0 is None else dist0.to(torch.float32))
    d0 = torch.where(source_mask, 0.0, d0)
    if layout is None:
        layout = B.build_layout(state, weight="length", semiring="min_plus")

    def relax(d):
        incoming = B.push(d, layout, semiring="min_plus")
        return torch.where(source_mask, 0.0, torch.minimum(d, incoming))

    return _fixed_point(relax, d0, num_iters)


def summarized_sssp(
    summary: SummaryBuffers,
    dist_prev: torch.Tensor,
    source_mask: torch.Tensor,
    *,
    num_iters: int = 30,
) -> Tuple[torch.Tensor, int]:
    """Bellman-Ford restricted to the hot set K over a
    ``weight="length"``/``min_plus`` summary, whose ``b_in`` freezes the
    cold boundary.  Returns the global distance vector (a new tensor) and
    the iterations run."""
    local_valid, hot_c = _hot_view(summary, dist_prev.shape[0])
    src_local = local_valid & source_mask[hot_c]
    d0 = torch.where(local_valid, dist_prev[hot_c], _INF)
    d0 = torch.where(src_local, 0.0, d0)
    layout = B.summary_layout(summary, semiring="min_plus")

    def relax(d):
        relaxed = torch.minimum(d, torch.minimum(
            B.push(d, layout, semiring="min_plus"), summary.b_in))
        return torch.where(local_valid, torch.where(src_local, 0.0, relaxed),
                           _INF)

    d_loc, i = _fixed_point(relax, d0, num_iters)
    return _set_drop(dist_prev, summary.hot_ids, d_loc), i


def summarized_sssp_batched(
    summary: SummaryBuffers,
    dist_prev: torch.Tensor,
    source_mask: torch.Tensor,
    *,
    num_iters: int = 30,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Batched :func:`summarized_sssp`: ``dist_prev``/``source_mask`` are
    ``[B, N]`` (one source set per slot) over one shared summary whose
    ``b_in`` is ``[K_cap]`` or ``[B, K_cap]``.  Each relaxation is one
    batched ``min_plus`` push.  ``row_mask`` (bool[B]) freezes finished or
    vacant slots.  Returns ``(dist [B, N], iterations, changed_rows
    i32[B])``."""
    local_valid, hot_c = _hot_view(summary, dist_prev.shape[1])
    src_local = local_valid & source_mask[:, hot_c]
    d0 = torch.where(local_valid, dist_prev[:, hot_c], _INF)
    d0 = torch.where(src_local, 0.0, d0)
    layout = B.summary_layout(summary, semiring="min_plus")

    def relax(d):
        relaxed = torch.minimum(d, torch.minimum(
            B.push(d, layout, semiring="min_plus"), summary.b_in))
        return torch.where(local_valid, torch.where(src_local, 0.0, relaxed),
                           _INF)

    d_loc, i, changed = _fixed_point_batched(relax, d0, num_iters, row_mask)
    return (_scatter_rows(dist_prev, summary.hot_ids, d_loc, row_mask), i,
            changed)


# --------------------------------------------------------------------------
# Widest path: max-reliability relaxation on max_times
# --------------------------------------------------------------------------


def widest_path(
    state: GraphState,
    source_mask: torch.Tensor,
    width0: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 30,
    layout: Optional[B.EdgeLayout] = None,
) -> Tuple[torch.Tensor, int]:
    """Bounded widest-path relaxation from the vertices in ``source_mask``
    (sources pinned to 1, lengths non-negative); returns
    ``(width f32[N_cap], iterations)`` with 0 where unreachable.

    ``width0`` warm-starts (exact under edge additions).  ``layout`` is a
    cached ``weight="length"``/``max_times`` layout.
    """
    B.require_layout(layout, weight="length", reverse=False,
                     who="widest_path", semiring="max_times")
    w0 = (torch.zeros(source_mask.shape, dtype=torch.float32,
                      device=source_mask.device)
          if width0 is None else width0.to(torch.float32))
    w0 = torch.where(source_mask, 1.0, w0)
    if layout is None:
        layout = B.build_layout(state, weight="length", semiring="max_times")

    def relax(w):
        incoming = B.push(w, layout, semiring="max_times")
        return torch.where(source_mask, 1.0, torch.maximum(w, incoming))

    return _fixed_point(relax, w0, num_iters)


def summarized_widest_path(
    summary: SummaryBuffers,
    width_prev: torch.Tensor,
    source_mask: torch.Tensor,
    *,
    num_iters: int = 30,
) -> Tuple[torch.Tensor, int]:
    """Widest-path relaxation restricted to the hot set K over a
    ``weight="length"``/``max_times`` summary (``b_in`` is −∞ where a hot
    vertex has no cold in-neighbour).  Returns the global width vector and
    the iterations run."""
    local_valid, hot_c = _hot_view(summary, width_prev.shape[0])
    src_local = local_valid & source_mask[hot_c]
    w0 = torch.where(local_valid, width_prev[hot_c], 0.0)
    w0 = torch.where(src_local, 1.0, w0)
    layout = B.summary_layout(summary, semiring="max_times")

    def relax(w):
        relaxed = torch.maximum(w, torch.maximum(
            B.push(w, layout, semiring="max_times"), summary.b_in))
        return torch.where(local_valid, torch.where(src_local, 1.0, relaxed),
                           0.0)

    w_loc, i = _fixed_point(relax, w0, num_iters)
    return _set_drop(width_prev, summary.hot_ids, w_loc), i


def summarized_widest_path_batched(
    summary: SummaryBuffers,
    width_prev: torch.Tensor,
    source_mask: torch.Tensor,
    *,
    num_iters: int = 30,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Batched :func:`summarized_widest_path`: ``[B, N]`` widths and source
    masks over one shared summary, one batched ``max_times`` push per
    relaxation.  ``row_mask`` (bool[B]) freezes finished or vacant slots.
    Returns ``(width [B, N], iterations, changed_rows i32[B])``."""
    local_valid, hot_c = _hot_view(summary, width_prev.shape[1])
    src_local = local_valid & source_mask[:, hot_c]
    w0 = torch.where(local_valid, width_prev[:, hot_c], 0.0)
    w0 = torch.where(src_local, 1.0, w0)
    layout = B.summary_layout(summary, semiring="max_times")

    def relax(w):
        relaxed = torch.maximum(w, torch.maximum(
            B.push(w, layout, semiring="max_times"), summary.b_in))
        return torch.where(local_valid, torch.where(src_local, 1.0, relaxed),
                           0.0)

    w_loc, i, changed = _fixed_point_batched(relax, w0, num_iters, row_mask)
    return (_scatter_rows(width_prev, summary.hot_ids, w_loc, row_mask), i,
            changed)


# --------------------------------------------------------------------------
# Connected components: label-min propagation on min_min
# --------------------------------------------------------------------------


def connected_components(
    state: GraphState,
    labels0: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 30,
    fwd_layout: Optional[B.EdgeLayout] = None,
    rev_layout: Optional[B.EdgeLayout] = None,
) -> Tuple[torch.Tensor, int]:
    """Weakly connected components by label-min propagation; returns
    ``(labels i32[N_cap], iterations)``.  Every active vertex ends with the
    least id of its component, inactive ones with :data:`LABEL_SENTINEL`.
    ``labels0`` warm-starts; each active vertex is re-seeded with
    ``min(labels0[v], v)``.  Either cached unit ``min_min`` layout may be
    missing; it is then built on entry.
    """
    B.require_layout(fwd_layout, weight="unit", reverse=False,
                     who="connected_components fwd_layout",
                     semiring="min_min")
    B.require_layout(rev_layout, weight="unit", reverse=True,
                     who="connected_components rev_layout",
                     semiring="min_min")
    active = state.node_active
    ids = torch.arange(state.node_capacity, dtype=torch.int32,
                       device=active.device)
    seed = ids if labels0 is None else torch.minimum(
        labels0.to(torch.int32), ids)
    l0 = torch.where(active, seed, LABEL_SENTINEL)
    if fwd_layout is None:
        fwd_layout = B.build_layout(state, weight="unit", semiring="min_min")
    if rev_layout is None:
        rev_layout = B.build_layout(state, weight="unit", reverse=True,
                                    semiring="min_min")

    def relax(lab):
        incoming = torch.minimum(
            B.push(lab, fwd_layout, semiring="min_min"),
            B.push(lab, rev_layout, semiring="min_min"))
        return torch.where(active, torch.minimum(lab, incoming),
                           LABEL_SENTINEL)

    return _fixed_point(relax, l0, num_iters)


def summarized_connected_components(
    fwd: SummaryBuffers,
    rev: SummaryBuffers,
    labels_prev: torch.Tensor,
    *,
    num_iters: int = 30,
) -> Tuple[torch.Tensor, int]:
    """Label-min propagation restricted to the hot set K over a forward and
    a reverse ``weight="unit"``/``min_min`` summary of the same hot mask
    (they share ``hot_ids``).  Hot vertices are re-seeded with their own
    ids: a vertex first seen since ``labels_prev`` is always hot.  Returns
    the global label vector and the iterations run."""
    local_valid, hot_c = _hot_view(fwd, labels_prev.shape[0])
    l0 = torch.where(
        local_valid,
        torch.minimum(labels_prev.to(torch.int32)[hot_c], fwd.hot_ids),
        LABEL_SENTINEL)
    boundary = torch.minimum(fwd.b_in, rev.b_in)
    fwd_layout = B.summary_layout(fwd, semiring="min_min")
    rev_layout = B.summary_layout(rev, semiring="min_min")

    def relax(lab):
        incoming = torch.minimum(
            B.push(lab, fwd_layout, semiring="min_min"),
            B.push(lab, rev_layout, semiring="min_min"))
        relaxed = torch.minimum(lab, torch.minimum(incoming, boundary))
        return torch.where(local_valid, relaxed, LABEL_SENTINEL)

    l_loc, i = _fixed_point(relax, l0, num_iters)
    return _set_drop(labels_prev, fwd.hot_ids, l_loc), i


def summarized_connected_components_batched(
    fwd: SummaryBuffers,
    rev: SummaryBuffers,
    labels_prev: torch.Tensor,
    *,
    num_iters: int = 30,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Batched :func:`summarized_connected_components` over ``[B, N]``
    labels sharing one forward/reverse summary pair, two batched
    ``min_min`` pushes per relaxation.  ``row_mask`` (bool[B]) freezes
    finished or vacant slots.  Returns ``(labels [B, N], iterations,
    changed_rows i32[B])``."""
    local_valid, hot_c = _hot_view(fwd, labels_prev.shape[1])
    l0 = torch.where(
        local_valid,
        torch.minimum(labels_prev.to(torch.int32)[:, hot_c], fwd.hot_ids),
        LABEL_SENTINEL)
    boundary = torch.minimum(fwd.b_in, rev.b_in)
    fwd_layout = B.summary_layout(fwd, semiring="min_min")
    rev_layout = B.summary_layout(rev, semiring="min_min")

    def relax(lab):
        incoming = torch.minimum(
            B.push(lab, fwd_layout, semiring="min_min"),
            B.push(lab, rev_layout, semiring="min_min"))
        relaxed = torch.minimum(lab, torch.minimum(incoming, boundary))
        return torch.where(local_valid, relaxed, LABEL_SENTINEL)

    l_loc, i, changed = _fixed_point_batched(relax, l0, num_iters, row_mask)
    return (_scatter_rows(labels_prev, fwd.hot_ids, l_loc, row_mask), i,
            changed)
