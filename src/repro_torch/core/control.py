"""Closed-loop quality control: the drift estimate and the controller that
steers the hot-set knobs to an accuracy target (PyTorch port of
``repro.core.control``).

Two pieces:

- :func:`drift_signals` turns one per-vertex fixed-point residual into two
  relative-error scalars, on the residual's device, with gathers and
  reductions only (no host read): ``drift_probe``, the residual sampled on
  a fixed probe set and extrapolated to the active set, and
  ``drift_cold``, the residual mass outside the hot set K (what a
  summarized sweep chose to freeze).  The fused query step computes them
  under ``with_drift=True`` and they reach the host in the query's one
  stats read.
- :class:`QualityController` is host arithmetic on Python floats: it turns
  ``quality_target`` into an error budget ``1 - quality_target``,
  accumulates the cold drift until a refresh, asks for an exact refresh
  when the estimate leaves the budget, and tightens or relaxes the
  effective ``r`` and ``Δ`` multiplicatively around a deadband.

Knob precedence: an explicitly passed ``r``/``delta`` is pinned
(``adjust_r=False`` / ``adjust_delta=False``, see
:func:`repro_torch.api.session`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def default_probe_ids(node_capacity: int, num_probes: int = 64,
                      device=None) -> torch.Tensor:
    """A fixed probe set: ``num_probes`` vertex ids (at most
    ``node_capacity``) strided evenly across the id space, int32 on
    ``device``.  The same vertices are probed every query, so successive
    readings compare."""
    num = max(1, min(int(num_probes), int(node_capacity)))
    stride = max(node_capacity // num, 1)
    ids = (np.arange(num, dtype=np.int64) * stride) % node_capacity
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def drift_signals(
    resid: torch.Tensor,
    result: torch.Tensor,
    hot: torch.Tensor,
    active: torch.Tensor,
    probe_ids: torch.Tensor,
    *,
    normalize: str = "mass",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(drift_probe, drift_cold)`` from one residual.

    ``resid`` is the per-vertex fixed-point residual and ``result`` the
    result view (any dtype), both ``[N]`` or ``[B, N]`` (then each row gives
    its own pair, f32[B]); ``hot``/``active`` are the bool[N] hot and active
    masks and ``probe_ids`` the int32 probe set.  Both scalars read as
    relative L1 errors: ``normalize="mass"`` divides by the total |result|
    mass, ``"count"`` by the active-vertex count (0/1 change indicators,
    e.g. connected components' label flips).  Non-finite entries (the ±∞
    sentinels of the min/max workloads) drop out of the residual and the
    mass.
    """
    res_f = result.to(torch.float32)
    resid = resid.to(torch.float32)
    finite = active & torch.isfinite(res_f) & torch.isfinite(resid)
    resid = torch.where(finite, resid.clamp(min=0.0), 0.0)
    n_active = active.sum(dtype=torch.float32).clamp(min=1.0)
    if normalize == "count":
        mass = n_active
    else:
        mass = torch.where(finite, res_f.abs(), 0.0).sum(-1).clamp(min=1e-30)

    # the residual mass the hot-set selection froze this query
    drift_cold = torch.where(hot, 0.0, resid).sum(-1) / mass

    # the mean residual on the probes, extrapolated to the active set
    probes = probe_ids.long()
    p_resid = resid[..., probes]
    p_live = finite[..., probes].to(torch.float32)
    p_mean = (p_resid * p_live).sum(-1) / p_live.sum(-1).clamp(min=1.0)
    drift_probe = p_mean * n_active / mass
    return drift_probe, drift_cold


@dataclass
class ControlDecision:
    """One controller step: the knobs for the next query, the error
    estimate, and whether an exact refresh is needed to stay in budget."""

    refresh: bool
    r_eff: float
    delta_eff: float
    err_est: float
    quality_est: float


class QualityController:
    """Drift in, effective knobs and refresh decisions out; Python floats
    only, never the device.

    Per observation (one query, or one serving wave of a lane) it

    1. adds ``drift_cold`` to the drift accumulated since the last refresh
       and estimates ``err = gain · max(drift_probe, accum)``;
    2. asks for a **refresh** when ``err`` exceeds the budget
       ``1 − quality_target`` (the caller recomputes exactly and calls
       :meth:`refreshed`);
    3. tightens both knobs (×``tighten``: a bigger hot set) when this
       query's own ``gain · max(probe, cold)`` is above ``tighten_at`` of
       the budget, relaxes them (×``relax``) below ``relax_at`` of it,
       clamped to ``r_bounds``/``delta_bounds``; ``adjust_r`` /
       ``adjust_delta`` False pin a knob.

    ``gain``: an explicit value wins; else a declared ``contraction`` c
    gives ``1 / (1 − c)``; else 3.0 (the damped ranking algebras).
    """

    def __init__(
        self,
        quality_target: float,
        *,
        r0: float,
        delta0: float,
        adjust_r: bool = True,
        adjust_delta: bool = True,
        gain: Optional[float] = None,
        contraction: Optional[float] = None,
        tighten: float = 0.5,
        relax: float = 1.35,
        tighten_at: float = 0.5,
        relax_at: float = 0.125,
        r_bounds: Tuple[float, float] = (1e-3, 4.0),
        delta_bounds: Tuple[float, float] = (1e-4, 16.0),
    ):
        if not 0.0 < quality_target < 1.0:
            raise ValueError(
                f"quality_target must be in (0, 1); got {quality_target}")
        self.quality_target = float(quality_target)
        self.budget = 1.0 - self.quality_target
        self.adjust_r = bool(adjust_r)
        self.adjust_delta = bool(adjust_delta)
        if gain is not None:
            self.gain = float(gain)
        elif contraction is not None:
            c = float(contraction)
            if not 0.0 <= c < 1.0:
                raise ValueError(
                    f"contraction must be in [0, 1); got {contraction}")
            self.gain = 1.0 / max(1.0 - c, 1e-6)
        else:
            self.gain = 3.0
        self.tighten = float(tighten)
        self.relax = float(relax)
        self.tighten_at = float(tighten_at)
        self.relax_at = float(relax_at)
        self.r_bounds = (float(r_bounds[0]), float(r_bounds[1]))
        self.delta_bounds = (float(delta_bounds[0]), float(delta_bounds[1]))
        self.r_eff = min(max(float(r0), self.r_bounds[0]), self.r_bounds[1])
        self.delta_eff = min(max(float(delta0), self.delta_bounds[0]),
                             self.delta_bounds[1])
        # cold drift accumulated since the last refresh, the last error
        # estimate, and counters for the stats rows
        self.accum = 0.0
        self.last_err = 0.0
        self.refreshes = 0
        self.observations = 0

    def observe(self, drift_probe: float,
                drift_cold: float) -> ControlDecision:
        """Fold one reading in: this query's own estimate steers the
        knobs, the accumulated one decides the refresh (only an exact
        recompute pays off frozen error)."""
        self.observations += 1
        probe = max(float(drift_probe), 0.0)
        cold = max(float(drift_cold), 0.0)
        self.accum += cold
        inst = self.gain * max(probe, cold)
        err = self.gain * max(probe, self.accum)
        self.last_err = err
        refresh = err > self.budget

        if inst > self.tighten_at * self.budget:
            if self.adjust_r:
                self.r_eff = max(self.r_eff * self.tighten,
                                 self.r_bounds[0])
            if self.adjust_delta:
                self.delta_eff = max(self.delta_eff * self.tighten,
                                     self.delta_bounds[0])
        elif inst < self.relax_at * self.budget:
            if self.adjust_r:
                self.r_eff = min(self.r_eff * self.relax, self.r_bounds[1])
            if self.adjust_delta:
                self.delta_eff = min(self.delta_eff * self.relax,
                                     self.delta_bounds[1])

        return ControlDecision(refresh=refresh, r_eff=self.r_eff,
                               delta_eff=self.delta_eff, err_est=err,
                               quality_est=max(0.0, 1.0 - err))

    def refreshed(self) -> None:
        """The caller recomputed exactly (or served a full-coverage wave):
        the accumulated drift resets."""
        self.accum = 0.0
        self.refreshes += 1
