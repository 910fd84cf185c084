"""Katz centrality, exact and summarized (PyTorch port of
``repro.core.katz``).

Katz scores count attenuated walks, ``c = Σ_k α^k (Aᵀ)^k · β·1``, computed
by the fixed-point iteration

    c(v) = β + α · Σ_{(u,v) ∈ E} c(u)

the PageRank sweep over unit edge weights with the teleport term replaced
by the constant attraction β.  It contracts (and the fixed point exists)
only while ``α < 1/σ_max(A)``: keep α small on hub-heavy graphs.  The
summarized sweep is the summarized PageRank sweep's structure: hot vertices
iterate over E_K with the frozen cold contribution ``b_in`` added each
iteration, cold scores carried over.  Every iteration is one
:func:`repro_torch.core.backend.push` on ``plus_times`` (one batched push in
:func:`summarized_katz_batched`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import backend as B
from repro_torch.core.pagerank import (SummaryBuffers, _keep, _power_loop,
                                       _power_loop_batched, _set_drop)
from repro_torch.graph.graph import GraphState


def katz(
    state: GraphState,
    init: Optional[torch.Tensor] = None,
    *,
    alpha: float = 0.05,
    beta: float = 1.0,
    num_iters: int = 30,
    tol: float = 0.0,
    layout: Optional[B.EdgeLayout] = None,
) -> Tuple[torch.Tensor, int]:
    """Full Katz power iteration; returns ``(katz f32[N_cap], iterations)``.

    ``init`` warm-starts; with ``tol > 0`` the loop stops once the L1
    change drops to ``tol``.  ``layout`` is a cached forward
    ``weight="unit"``/``plus_times`` layout; without one the sweep builds
    it on entry.
    """
    B.require_layout(layout, weight="unit", reverse=False, who="katz")
    active = state.node_active
    c0 = torch.where(active, beta if init is None else init, 0.0).to(
        torch.float32)
    if layout is None:
        layout = B.build_layout(state, weight="unit")

    def step(c):
        return torch.where(active, beta + alpha * B.push(c, layout), 0.0)

    return _power_loop(step, c0, num_iters, tol)


def summarized_katz(
    summary: SummaryBuffers,
    katz_prev: torch.Tensor,
    *,
    alpha: float = 0.05,
    beta: float = 1.0,
    num_iters: int = 30,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, int]:
    """Katz iteration restricted to the hot set K over a ``weight="unit"``
    summary frozen from the previous scores: ``c(z) = β + α·(Σ_{E_K} c(u)
    + b_in(z))``, cold scores carried over.  Returns the global score
    vector and the iterations run."""
    n = katz_prev.shape[0]
    k_cap = summary.hot_ids.shape[0]
    local_valid = torch.arange(k_cap, dtype=torch.int32,
                               device=katz_prev.device) < summary.num_hot
    c0 = torch.where(local_valid, katz_prev[summary.hot_ids.clamp(max=n - 1)],
                     0.0)
    layout = B.summary_layout(summary)

    def step(c):
        return torch.where(local_valid, beta + alpha * (
            B.push(c, layout) + summary.b_in), 0.0)

    c_loc, iters = _power_loop(step, c0, num_iters, tol)
    return _set_drop(katz_prev, summary.hot_ids, c_loc), iters


def summarized_katz_batched(
    summary: SummaryBuffers,
    katz_prev: torch.Tensor,
    *,
    alpha: float = 0.05,
    beta: float = 1.0,
    num_iters: int = 30,
    tol: float = 0.0,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Batched :func:`summarized_katz`: ``[B, N]`` scores over one shared
    summary, one batched push per iteration.  ``row_mask`` (bool[B])
    freezes finished or vacant slots: their rows carry over and report zero
    delta.  Returns ``(katz [B, N], iterations, row_delta f32[B])``."""
    batch, n = katz_prev.shape
    k_cap = summary.hot_ids.shape[0]
    dev = katz_prev.device
    local_valid = torch.arange(k_cap, dtype=torch.int32,
                               device=dev) < summary.num_hot
    c0 = torch.where(local_valid,
                     katz_prev[:, summary.hot_ids.clamp(max=n - 1)], 0.0)
    keep = _keep(row_mask, batch, dev)
    layout = B.summary_layout(summary)

    def step(c):
        return torch.where(local_valid, beta + alpha * (
            B.push(c, layout) + summary.b_in), 0.0)

    c_loc, iters, delta = _power_loop_batched(step, c0, num_iters, tol, keep)
    scores = _set_drop(katz_prev, summary.hot_ids, c_loc)
    return torch.where(keep, scores, katz_prev), iters, delta
