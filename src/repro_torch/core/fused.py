"""The approximate query step: selection + summary + iteration (PyTorch port
of ``repro.core.fused``).

    (GraphState, state, deg_prev, active_prev, r, Δ) -> (state', stats)

The overflow fallback (|K| or |E_K| over capacity → exact recompute) stays
a flag in the stats: the summarized result is computed unconditionally and
the caller discards it when ``used_fallback`` is set.  The drift estimator
and the mesh path are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.algorithm import PageRankAlgorithm, summaries_overflow
from repro_torch.core.hotset import select_hot_set
from repro_torch.graph.graph import GraphState


class QueryStepStats(NamedTuple):
    """Stats of one query step: 0-d tensors on the step's device, except
    ``iterations`` (counted on the host)."""

    num_hot: torch.Tensor
    num_kr: torch.Tensor
    num_kn: torch.Tensor
    num_kdelta: torch.Tensor
    num_ek: torch.Tensor
    num_eb: torch.Tensor
    iterations: int
    used_fallback: torch.Tensor  # bool


def fused_query_step(
    state: GraphState,
    algo_state,
    deg_prev: torch.Tensor,
    active_prev: torch.Tensor,
    r: torch.Tensor,
    delta: torch.Tensor,
    probe_ids: Optional[torch.Tensor] = None,
    *,
    algo,
    hot_node_capacity: int,
    hot_edge_capacity: int,
    n: int = 1,
    delta_hop_cap: int = 4,
    degree_mode: str = "out",
    expand_both: bool = False,
    layouts=None,
    with_drift: bool = False,
):
    """One summarized query for any :class:`StreamingAlgorithm`.

    ``layouts`` is the cached layout tuple matching ``algo.layout_specs``.
    Returns ``(new_algo_state, QueryStepStats)``; the caller discards the
    new state and recomputes exactly when ``used_fallback`` is set.
    """
    if with_drift:
        raise NotImplementedError(
            "the drift estimator is not ported yet (ROADMAP queue 1 "
            "entry 11)")
    hot, hstats = select_hot_set(
        state, deg_prev, algo.selection_view(algo_state), r, delta,
        active_prev=active_prev, n=n, delta_hop_cap=delta_hop_cap,
        degree_mode=degree_mode, expand_both=expand_both,
        normalize_scores=algo.normalize_selection_scores)
    summaries = algo.build_summaries(
        algo_state, state, hot, hot_node_capacity=hot_node_capacity,
        hot_edge_capacity=hot_edge_capacity, layouts=layouts)
    new_state, iters = algo.summarized(algo_state, state, summaries)
    num_eb = summaries[0].num_eb
    for s in summaries[1:]:
        num_eb = num_eb + s.num_eb
    return new_state, QueryStepStats(
        num_hot=hstats.num_hot, num_kr=hstats.num_kr, num_kn=hstats.num_kn,
        num_kdelta=hstats.num_kdelta, num_ek=summaries[0].num_ek,
        num_eb=num_eb, iterations=iters,
        used_fallback=summaries_overflow(summaries))


def approximate_query_step(
    state: GraphState,
    ranks_prev: torch.Tensor,
    deg_prev: torch.Tensor,
    active_prev: torch.Tensor,
    r: torch.Tensor,
    delta: torch.Tensor,
    *,
    hot_node_capacity: int,
    hot_edge_capacity: int,
    beta: float = 0.85,
    num_iters: int = 30,
    tol: float = 0.0,
    n: int = 1,
    delta_hop_cap: int = 4,
    degree_mode: str = "out",
    expand_both: bool = False,
    layout=None,
) -> Tuple[torch.Tensor, QueryStepStats]:
    """One summarized-PageRank query: :func:`fused_query_step` for
    PageRank with the given knobs.  ``layout`` is an optional cached
    forward ``inv_out`` layout."""
    new_state, stats = fused_query_step(
        state, {"ranks": ranks_prev}, deg_prev, active_prev, r, delta,
        algo=PageRankAlgorithm(beta=beta, num_iters=num_iters, tol=tol),
        hot_node_capacity=hot_node_capacity,
        hot_edge_capacity=hot_edge_capacity, n=n,
        delta_hop_cap=delta_hop_cap, degree_mode=degree_mode,
        expand_both=expand_both,
        layouts=None if layout is None else (layout,))
    return new_state["ranks"], stats
