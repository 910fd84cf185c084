"""HITS (hubs and authorities), exact and summarized (PyTorch port of
``repro.core.hits``).

The update rules are Kleinberg's mutual recursion

    auth(v) = Σ_{(u,v) ∈ E} hub(u)          (along in-edges)
    hub(u)  = Σ_{(u,v) ∈ E} auth(v)         (along out-edges)

with L1 normalization over the active vertices each half-iteration.  Both
directions are :func:`repro_torch.core.backend.push` on ``plus_times`` with
unit weights: the authority update over a forward layout, the hub update
over a reverse one.

The summarized sweep runs both updates for the hot set K only, against a
forward summary (``b_in`` = the frozen cold hub mass flowing into hot
authorities) and a reverse one (the frozen cold authority mass hot hubs
collect).  Cold scores carry over, and each half-update is normalized by a
global σ estimate anchored to the σ tracked across sweeps (measured by
exact computations, carried in the state), so that with K = V the
summarized sweep is the exact one up to f32 summation order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import backend as B
from repro_torch.core.pagerank import SummaryBuffers, _keep, _set_drop
from repro_torch.graph.graph import GraphState

_EPS = 1e-12


def _l1_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.abs().sum().clamp(min=_EPS)


def hits(
    state: GraphState,
    auth0: Optional[torch.Tensor] = None,
    hub0: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 30,
    tol: float = 0.0,
    fwd_layout: Optional[B.EdgeLayout] = None,
    rev_layout: Optional[B.EdgeLayout] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """Full HITS power iteration; returns ``(auth, hub, iterations,
    sigma)``.

    ``sigma`` f32[2] is the last half-update's L1 normalizer per direction
    ``[σ_auth, σ_hub]``: the growth rate of the raw update, which converges
    to the principal singular value of the unit-weight adjacency operator.
    With ``tol > 0`` the loop stops once the authorities' L1 change drops
    to ``tol``.  ``auth0``/``hub0`` warm-start.  ``fwd_layout``/
    ``rev_layout`` are cached unit-weight layouts (forward and reverse);
    either missing is built on entry.
    """
    B.require_layout(fwd_layout, weight="unit", reverse=False,
                     who="hits fwd_layout")
    B.require_layout(rev_layout, weight="unit", reverse=True,
                     who="hits rev_layout")
    active = state.node_active
    n_active = state.num_active_nodes().to(torch.float32).clamp(min=1.0)
    uniform = torch.where(active, 1.0 / n_active, 0.0)
    a = uniform if auth0 is None else _l1_normalize(
        torch.where(active, auth0, 0.0))
    h = uniform if hub0 is None else _l1_normalize(
        torch.where(active, hub0, 0.0))
    if fwd_layout is None:
        fwd_layout = B.build_layout(state, weight="unit")
    if rev_layout is None:
        rev_layout = B.build_layout(state, weight="unit", reverse=True)

    one = torch.ones((), dtype=torch.float32, device=active.device)
    sig_a = sig_h = one
    i, delta = 0, float("inf")
    while i < num_iters and delta > tol:
        a_raw = torch.where(active, B.push(h, fwd_layout), 0.0)
        sig_a = a_raw.abs().sum()
        a_new = a_raw / sig_a.clamp(min=_EPS)
        h_raw = torch.where(active, B.push(a_new, rev_layout), 0.0)
        sig_h = h_raw.abs().sum()
        h = h_raw / sig_h.clamp(min=_EPS)
        delta = float((a_new - a).abs().sum())
        a, i = a_new, i + 1
    return a, h, i, torch.stack([sig_a, sig_h])


def _summarized_sweep(fwd, rev, auth_prev, hub_prev, sig0, keep, *,
                      num_iters, tol):
    """The summarized HITS sweep over ``[N]`` or ``[B, N]`` scores (sums
    along the last axis); ``keep`` is None or the bool[B, 1] live rows.
    Returns the global ``(auth, hub, iterations, delta, σ̂_a, σ̂_h)``."""
    n = auth_prev.shape[-1]
    k_cap = fwd.hot_ids.shape[0]
    local_valid = torch.arange(k_cap, dtype=torch.int32,
                               device=auth_prev.device) < fwd.num_hot
    hot_c = fwd.hot_ids.clamp(max=n - 1)
    a = torch.where(local_valid, auth_prev[..., hot_c], 0.0)
    h = torch.where(local_valid, hub_prev[..., hot_c], 0.0)
    # the frozen cold L1 mass per direction (per row): constant over the
    # sweep, since cold scores are the boundary
    l1 = lambda x: x.abs().sum(dim=-1)
    cold_a = (l1(auth_prev) - l1(a)).clamp(min=0.0)
    cold_h = (l1(hub_prev) - l1(h)).clamp(min=0.0)
    fwd_layout = B.summary_layout(fwd)
    rev_layout = B.summary_layout(rev)

    def half_step(prev, raw, cold, anchor, sigma_last):
        """Normalize a raw half-update by the anchored global-σ estimate;
        degenerate hot blocks (no internal edge, no boundary inflow) keep
        their scores and the last σ̂."""
        growth = ((l1(raw) + anchor * cold)
                  / (l1(prev) + cold).clamp(min=_EPS))
        ok = l1(raw) + cold > _EPS
        if keep is not None:
            ok = ok & keep[:, 0]
        sigma = torch.where(ok, growth, sigma_last)
        scaled = torch.where(ok[..., None],
                             raw / sigma.clamp(min=_EPS)[..., None], prev)
        return (scaled if keep is None else torch.where(keep, scaled, prev),
                sigma)

    sig_a, sig_h = sig0[..., 0], sig0[..., 1]
    i, worst = 0, float("inf")
    delta = torch.full(auth_prev.shape[:-1], float("inf"),
                       device=auth_prev.device)
    while i < num_iters and worst > tol:
        a_new, sig_a = half_step(
            a, torch.where(local_valid, B.push(h, fwd_layout) + fwd.b_in,
                           0.0), cold_a, sig0[..., 0], sig_a)
        h, sig_h = half_step(
            h, torch.where(local_valid, B.push(a_new, rev_layout) + rev.b_in,
                           0.0), cold_h, sig0[..., 1], sig_h)
        delta = l1(a_new - a)
        worst = float(delta.max())
        a, i = a_new, i + 1
    auth = _set_drop(auth_prev, fwd.hot_ids, a)
    hub = _set_drop(hub_prev, fwd.hot_ids, h)
    if keep is not None:
        auth = torch.where(keep, auth, auth_prev)
        hub = torch.where(keep, hub, hub_prev)
    return auth, hub, i, delta, sig_a, sig_h


def summarized_hits(
    fwd: SummaryBuffers,
    rev: SummaryBuffers,
    auth_prev: torch.Tensor,
    hub_prev: torch.Tensor,
    sigma_prev: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 30,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """HITS iteration restricted to the hot set K over a forward and a
    reverse unit summary of one hot mask.

    Each half-update is normalized by the anchored global-σ estimate

        σ̂ = (Σ|raw_hot| + σ_tracked·cold) / (Σ|prev_hot| + cold)

    with ``cold = Σ|prev_global| − Σ|prev_hot|`` and ``σ_tracked`` from
    ``sigma_prev`` (f32[2], None = ones); a degenerate half-update (no
    internal edge, no boundary inflow) keeps the previous scores and σ̂.
    Returns the global ``(auth, hub, iterations, sigma)``, ``sigma`` being
    the final σ̂ per direction, to track into the next sweep.
    """
    sig0 = (torch.ones(2, dtype=torch.float32, device=auth_prev.device)
            if sigma_prev is None else sigma_prev.to(torch.float32))
    auth, hub, i, _, sig_a, sig_h = _summarized_sweep(
        fwd, rev, auth_prev, hub_prev, sig0, None, num_iters=num_iters,
        tol=tol)
    return auth, hub, i, torch.stack([sig_a, sig_h])


def summarized_hits_batched(
    fwd: SummaryBuffers,
    rev: SummaryBuffers,
    auth_prev: torch.Tensor,
    hub_prev: torch.Tensor,
    sigma_prev: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 30,
    tol: float = 0.0,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """Batched :func:`summarized_hits`: ``[B, N]`` authorities and hubs
    over one shared summary pair, with the single sweep's anchored-σ
    normalization per row (cold masses and σ̂ are ``[B]``; ``sigma_prev``
    is the ``[B, 2]`` tracked anchor, None = ones).  Each half-iteration is
    one batched push.  ``row_mask`` (bool[B]) freezes finished or vacant
    slots, their scores and their tracked σ.  Returns ``(auth [B, N], hub
    [B, N], iterations, row_delta f32[B], sigma [B, 2])``.
    """
    batch = auth_prev.shape[0]
    dev = auth_prev.device
    sig0 = (torch.ones((batch, 2), dtype=torch.float32, device=dev)
            if sigma_prev is None else sigma_prev.to(torch.float32))
    auth, hub, i, delta, sig_a, sig_h = _summarized_sweep(
        fwd, rev, auth_prev, hub_prev, sig0, _keep(row_mask, batch, dev),
        num_iters=num_iters, tol=tol)
    return auth, hub, i, delta, torch.stack([sig_a, sig_h], dim=1)
