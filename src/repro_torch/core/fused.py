"""The approximate query step: selection + summary + iteration (PyTorch port
of ``repro.core.fused``).

    (GraphState, state, deg_prev, active_prev, r, Δ) -> (state', stats)

The overflow fallback (|K| or |E_K| over capacity → exact recompute) stays
a flag in the stats: the summarized result is computed unconditionally and
the caller discards it when ``used_fallback`` is set.
:func:`fused_query_step_batched` is the serving engine's wave: B queries of
one algorithm over one shared hot set and summary.  Under
``with_drift=True`` both also compute the quality controller's drift
estimate (:mod:`repro_torch.core.control`) on the step's device.  Handed
sharded layouts (a mesh engine's), every push of the step runs per shard
and the summaries are built sharded; ``mesh``/``mesh_axes`` build them here
for a caller with no cached layouts.

Under ``EngineConfig.async_rebuild`` every input here is epoch-bound: the
graph, the layouts and the ``deg_prev``/``active_prev`` baselines all come
from one frozen :class:`~repro_torch.core.epoch.EpochSnapshot`.  The step
itself is the same in both modes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.algorithm import (PageRankAlgorithm, _finite_churn,
                                        summaries_overflow)
from repro_torch.core.backend import normalize_layout_spec
from repro_torch.core.control import drift_signals
from repro_torch.core.hotset import _frontier_sweep, select_hot_set
from repro_torch.graph.graph import GraphState
from repro_torch.graph.partition import build_sharded_layout


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
    # the drift estimate (f32 0-d tensors) under with_drift=True; 0.0
    # otherwise, as in the JAX package
    drift_probe: Union[torch.Tensor, float] = 0.0
    drift_cold: Union[torch.Tensor, float] = 0.0


def _drift_from_state(algo, new_state, old_state, graph, hot, probe_ids, *,
                      layouts):
    """``(drift_probe, drift_cold)`` of one step: from the algorithm's
    fixed-point residual, or, where it defines none, from the churn of its
    result view.  ``[B, ...]`` states give one pair per row, f32[B]."""
    resid = algo.drift_residual(new_state, graph, layouts=layouts)
    if resid is None:
        resid = _finite_churn(algo.result_view(new_state),
                              algo.result_view(old_state))
    return drift_signals(resid, algo.result_view(new_state), hot,
                         graph.node_active, probe_ids,
                         normalize=algo.drift_normalize)


def _mesh_layouts(state: GraphState, algo, layouts, mesh, mesh_axes):
    """``layouts``, or, when there are none and a mesh is given, the
    algorithm's sharded layouts built and placed here (one per spec)."""
    if layouts is not None or mesh is None:
        return layouts
    return tuple(
        build_sharded_layout(state, mesh=mesh, axes=mesh_axes, weight=w,
                             reverse=rev, semiring=sr, placed=True)
        for w, rev, sr in map(normalize_layout_spec, algo.layout_specs))


def summary_kwargs(shard_bucket_capacity: Optional[int]) -> dict:
    """``shard_bucket_capacity`` for ``build_summaries``, only when set,
    so that an override without the keyword still works."""
    return ({} if shard_bucket_capacity is None
            else {"shard_bucket_capacity": shard_bucket_capacity})


def _wave_stats(hstats, summaries, iters, num_hot=None) -> QueryStepStats:
    num_eb = summaries[0].num_eb
    for s in summaries[1:]:
        num_eb = num_eb + s.num_eb
    return QueryStepStats(
        num_hot=hstats.num_hot if num_hot is None else num_hot,
        num_kr=hstats.num_kr, num_kn=hstats.num_kn,
        num_kdelta=hstats.num_kdelta, num_ek=summaries[0].num_ek,
        num_eb=num_eb, iterations=iters,
        used_fallback=summaries_overflow(summaries))


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
    mesh=None,
    mesh_axes=None,
    shard_bucket_capacity: Optional[int] = None,
    with_drift: bool = False,
):
    """One summarized query for any :class:`StreamingAlgorithm`.

    ``layouts`` is the cached layout tuple matching ``algo.layout_specs``,
    single or (a mesh engine's) sharded.  With ``layouts=None`` and a
    ``mesh`` (a ``DeviceMesh``, over ``mesh_axes``) the sharded
    layouts are built here; ``shard_bucket_capacity`` goes to the sharded
    summaries.  Returns ``(new_algo_state, QueryStepStats)``; the caller
    discards the new state and recomputes exactly when ``used_fallback``
    is set.  ``with_drift=True`` also fills the stats' ``drift_probe`` and
    ``drift_cold`` (probed on ``probe_ids``), on the device: they reach the
    host in the caller's one stats read.
    """
    layouts = _mesh_layouts(state, algo, layouts, mesh, mesh_axes)
    hot, hstats = select_hot_set(
        state, deg_prev, algo.selection_view(algo_state), r, delta,
        active_prev=active_prev, n=n, delta_hop_cap=delta_hop_cap,
        degree_mode=degree_mode, expand_both=expand_both,
        normalize_scores=algo.normalize_selection_scores)
    summaries = algo.build_summaries(
        algo_state, state, hot, hot_node_capacity=hot_node_capacity,
        hot_edge_capacity=hot_edge_capacity, layouts=layouts,
        **summary_kwargs(shard_bucket_capacity))
    new_state, iters = algo.summarized(algo_state, state, summaries)
    stats = _wave_stats(hstats, summaries, iters)
    if with_drift:
        probe, cold = _drift_from_state(algo, new_state, algo_state, state,
                                        hot, probe_ids, layouts=layouts)
        stats = stats._replace(drift_probe=probe, drift_cold=cold)
    return new_state, stats


def _cold_coverage(state: GraphState, algo, batch_state,
                   live_cold: torch.Tensor) -> Optional[torch.Tensor]:
    """The vertices a wave with cold rows must cover besides its hot set,
    or None when no live row is cold (one device read).  Algorithms with
    per-query seeds cover the forward reachability of the live cold rows'
    seed union, grown one frontier sweep at a time until a sweep adds
    nothing (one device read per sweep); the others cover every active
    vertex."""
    if not bool(live_cold.any()):
        return None
    seeds = algo.batched_cold_seeds(batch_state)
    if seeds is None:
        return state.node_active
    mark = (seeds & live_cold[:, None]).any(dim=0) & state.node_active
    while True:
        nxt = _frontier_sweep(state, mark, both=False)
        if not bool((nxt != mark).any()):
            return mark
        mark = nxt


def fused_query_step_batched(
    state: GraphState,
    batch_state,
    deg_prev: torch.Tensor,
    active_prev: torch.Tensor,
    r: torch.Tensor,
    delta: torch.Tensor,
    row_mask: torch.Tensor,
    cold_rows: Optional[torch.Tensor] = None,
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
    mesh=None,
    mesh_axes=None,
    shard_bucket_capacity: Optional[int] = None,
    with_drift: bool = False,
):
    """One summarized wave for B concurrent queries of one algorithm.

    ``batch_state`` holds every slot's state with a leading batch axis
    (``[B, ...]`` leaves).  The wave shares one hot set, one summary
    structure and one edge layout across the B queries: selection reads
    ``algo.batched_selection_scores`` (the element-wise maximum over the
    live rows), the summaries carry a per-query ``b_in [B, K_cap]`` (one
    batched push), and ``algo.summarized_batched`` runs the restricted
    sweep as batched pushes with ``row_mask`` (bool[B], True = live)
    freezing finished or vacant slots.

    ``cold_rows`` (bool[B]) marks freshly seated slots that have not
    converged once.  They have no churn history, so the wave also covers
    the forward reachability of their seeds
    (``algo.batched_cold_seeds``: PPR's teleport support, the path
    sources), which is closed under out-edges and so gives the answer full
    coverage would; algorithms without seeds cover every active vertex.  A
    wave with no live cold row runs no reachability sweep.

    Returns ``(new_batch_state, QueryStepStats, row_delta f32[B])``: the
    stats describe the shared wave and ``row_delta`` is each slot's
    convergence signal.  As in :func:`fused_query_step`, the caller
    discards the new state and recomputes each live row exactly when
    ``used_fallback`` is set.  ``with_drift=True`` adds a fourth value,
    ``row_drift f32[B, 2]`` (each slot's drift_probe and drift_cold, zero on
    vacant rows), for the caller to read with ``row_delta``; the stats then
    carry the maximum over the live rows.  ``mesh``, ``mesh_axes`` and
    ``shard_bucket_capacity`` are as for :func:`fused_query_step`: with
    sharded layouts each batched push runs per shard.
    """
    layouts = _mesh_layouts(state, algo, layouts, mesh, mesh_axes)
    scores = algo.batched_selection_scores(batch_state, row_mask)
    hot, hstats = select_hot_set(
        state, deg_prev, scores, r, delta, active_prev=active_prev, n=n,
        delta_hop_cap=delta_hop_cap, degree_mode=degree_mode,
        expand_both=expand_both,
        normalize_scores=algo.normalize_selection_scores)
    num_hot = None
    if cold_rows is not None:
        extra = _cold_coverage(state, algo, batch_state,
                               cold_rows & row_mask)
        if extra is not None:
            hot = hot | extra
        num_hot = hot.sum(dtype=torch.int32)
    summaries = algo.build_summaries(
        batch_state, state, hot, hot_node_capacity=hot_node_capacity,
        hot_edge_capacity=hot_edge_capacity, layouts=layouts,
        **summary_kwargs(shard_bucket_capacity))
    new_state, iters, row_delta = algo.summarized_batched(
        batch_state, state, summaries, row_mask=row_mask)
    stats = _wave_stats(hstats, summaries, iters, num_hot)
    if not with_drift:
        return new_state, stats, row_delta
    probe, cold = _drift_from_state(algo, new_state, batch_state, state, hot,
                                    probe_ids, layouts=layouts)
    live = row_mask.to(torch.float32)
    row_drift = torch.stack([probe, cold], dim=-1) * live[:, None]
    stats = stats._replace(drift_probe=(probe * live).max(),
                           drift_cold=(cold * live).max())
    return new_state, stats, row_delta, row_drift


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
