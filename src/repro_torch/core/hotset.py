"""Hot-vertex selection K = K_r ∪ K_n ∪ K_Δ (paper §3.2, Eqs. 2–5; PyTorch
port of ``repro.core.hotset``).

Each stage is a dense masked sweep over the edge list: a frontier
expansion is one scatter-or along the edges, so K_n costs n sweeps and K_Δ
at most ``delta_hop_cap``.  The K_Δ loop stops once a sweep adds nothing,
which the host learns with one device read per sweep.  On a state placed
on a mesh each rank sweeps its own edge slots and the ranks meet in one
``[N]`` all-reduce a sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.graph.graph import GraphState, edge_group, edge_slice
from repro_torch.sharding.rules import flat_sum


class HotSetParams(NamedTuple):
    """The paper's hot-set model knobs (r, n, Δ)."""

    r: torch.Tensor    # update-ratio threshold (f32 0-d)
    n: int             # neighbourhood diameter
    delta: torch.Tensor  # Δ score-dilution bound (f32 0-d)


class HotSetStats(NamedTuple):
    """Sizes of the three selection stages (K_r, K_n, K_Δ) and of K."""

    num_kr: torch.Tensor
    num_kn: torch.Tensor
    num_kdelta: torch.Tensor
    num_hot: torch.Tensor


def _frontier_sweep(state: GraphState, mark: torch.Tensor, *,
                    both: bool) -> torch.Tensor:
    """One BFS sweep: the vertices reachable in <= 1 hop from ``mark``.
    On a sliced state each rank counts its own edges and the counts meet
    in one all-reduce before ``reach > 0`` (the reduction GSPMD inserts
    for the reference's segment sum over sharded edges)."""
    sl = edge_slice(state)
    n = mark.shape[0]

    def reach_along(frm, to):
        # a count per receiver stands in for the scatter-or, so duplicate
        # receivers need no ordering
        hit = (sl.mask & mark[frm]).to(torch.int32)
        return torch.zeros(n, dtype=torch.int32,
                           device=mark.device).index_add_(0, to.long(), hit)

    reach = reach_along(sl.src, sl.dst)
    if both:
        reach = reach + reach_along(sl.dst, sl.src)
    group = edge_group(state)
    if group is not None:
        reach = flat_sum(reach, group)
    return mark | (reach > 0)


def select_hot_set(
    state: GraphState,
    deg_prev: torch.Tensor,
    ranks_prev: torch.Tensor,
    r: torch.Tensor,
    delta: torch.Tensor,
    *,
    active_prev: Optional[torch.Tensor] = None,
    n: int = 1,
    delta_hop_cap: int = 4,
    degree_mode: str = "out",
    expand_both: bool = False,
    normalize_scores: bool = False,
) -> Tuple[torch.Tensor, HotSetStats]:
    """The hot-vertex mask K over the current graph, and its stats.

    ``deg_prev`` is the degree snapshot at the previous measurement point
    (same ``degree_mode``) and ``active_prev`` the activity snapshot: a
    vertex first seen since then is always in K_r (paper footnote 2).
    Without ``active_prev``, ``deg_prev > 0`` stands in for it.
    ``normalize_scores`` rescales v_s to mean 1 over the active set before
    the Δ bound.
    """
    if degree_mode == "out":
        deg_now = state.out_deg
    elif degree_mode == "in":
        deg_now = state.in_deg
    elif degree_mode == "total":
        deg_now = state.out_deg + state.in_deg
    else:
        raise ValueError(f"degree_mode={degree_mode}")

    active = state.node_active
    deg_now_f = deg_now.to(torch.float32)
    deg_prev_f = deg_prev.to(torch.float32)

    # ---- Eq. 2: K_r ------------------------------------------------------
    was_seen = deg_prev > 0 if active_prev is None else active_prev
    is_new = active & ~was_seen
    # the ratio's denominator clamps to >= 1 and is consulted only where
    # deg_prev > 0; a vertex without prior degree is changed iff it gained
    ratio = (deg_now_f / deg_prev_f.clamp(min=1.0) - 1.0).abs()
    changed = torch.where(deg_prev > 0, ratio > r, deg_now > 0)
    k_r = active & (is_new | (was_seen & changed))

    # ---- Eq. 3: K_n, n-hop directed expansion around K_r ------------------
    k_rn = k_r
    for _ in range(n):
        k_rn = _frontier_sweep(state, k_rn, both=expand_both)
    k_n_only = k_rn & ~k_r

    # ---- Eqs. 4-5: K_Δ, score-dilution-bounded expansion -----------------
    # f_Δ(v) = log(n + d̄·v_s / (Δ·d_t(v))) / log(d̄), clamped to [0, cap]
    n_active = state.num_active_nodes().to(torch.float32).clamp(min=1.0)
    total_deg = torch.where(active, deg_now_f, 0.0).sum()
    d_bar = (total_deg / n_active).clamp(min=1.0 + 1e-6)
    v_s = ranks_prev.clamp(min=0.0)
    if normalize_scores:
        total_score = torch.where(active, v_s, 0.0).sum()
        v_s = v_s * (n_active / total_score.clamp(min=1e-30))
    arg = n + d_bar * v_s / (delta.clamp(min=1e-9) * deg_now_f.clamp(min=1.0))
    f_delta = torch.log(arg.clamp(min=1e-9)) / torch.log(d_bar)
    f_delta = f_delta.clamp(0.0, float(delta_hop_cap))

    # hop-distance relaxation from K_r ∪ K_n: a candidate at distance h
    # joins when h <= f_Δ(v); expansion continues only through joiners
    h, grew = 1, True
    k_delta = torch.zeros_like(k_rn)
    frontier = k_rn
    while h <= delta_hop_cap and grew:
        nxt = _frontier_sweep(state, frontier, both=expand_both) & ~frontier
        joined = nxt & (f_delta >= float(h)) & ~k_rn & ~k_delta
        grew = bool(joined.any())
        k_delta = k_delta | joined
        frontier = frontier | joined
        h += 1

    hot = (k_r | k_rn | k_delta) & active
    count = lambda m: m.sum(dtype=torch.int32)
    return hot, HotSetStats(num_kr=count(k_r), num_kn=count(k_n_only),
                            num_kdelta=count(k_delta), num_hot=count(hot))
