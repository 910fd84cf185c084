"""Multi-tenant graph-query serving: slot-based continuous batching (PyTorch
port of ``repro.serve.graph``).

- A :class:`GraphServingEngine` wraps one started
  :class:`~repro_torch.core.engine.VeilGraphEngine`: one shared graph, one
  shared hot set and summary per wave, many concurrent queries.
- :meth:`GraphServingEngine.submit` enqueues a request (e.g. B
  personalized-PageRank seed sets, B SSSP sources) and returns a
  :class:`QueryTicket` at once.
- Queries of one algorithm family share a **lane**: a bank of ``slots``
  state rows (``[S, ...]`` tensors, the algorithm's ``init_state`` dict with
  a leading slot axis).  Per-query identity (teleport vectors, source
  masks) lives in the rows, never in the algorithm instance
  (``StreamingAlgorithm.per_query_params``).
- Each :meth:`~GraphServingEngine.step` (wave) applies pending graph
  updates, seats queued requests in vacant slots (writing their rows into
  the bank in place), runs one batched fused step per non-empty lane with a
  ``row_mask`` that freezes vacant rows, and harvests rows whose
  convergence signal reached the request's tolerance or whose wave budget
  is spent.  Every push of a wave is one launch of a batched kernel, one
  per edge shard on a mesh engine (``EngineConfig.mesh``), whose applied
  updates may also recut the shard partition at the wave boundary.
- Summary overflow keeps the engine's contract: the wave's batch result is
  discarded and every live row is recomputed exactly, row by row.

- Under ``quality_target`` each lane runs its own
  :class:`~repro_torch.core.control.QualityController` (lanes disagree on
  residual scale): the wave's per-slot drift rides the ``row_delta`` read,
  and a refresh re-marks the lane's live slots cold, so the next wave
  covers their seeds' reach again.
- Under ``async_rebuild`` a wave promotes the finished epoch build, serves
  every lane from that snapshot, and only then integrates the buffered
  updates and dispatches the next epoch's build.

Usage::

    srv = repro_torch.serve_session((src, dst), slots=4)
    t1 = srv.submit("personalized-pagerank", seeds=(3,))
    t2 = srv.submit("sssp", sources=(17,))
    srv.run()
    t1.result, t2.result, srv.stats.queries_per_s
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core.algorithm import (AlgoState, StreamingAlgorithm,
                                        make_algorithm)
from repro_torch.core.control import QualityController
from repro_torch.core.engine import VeilGraphEngine
from repro_torch.core.fused import fused_query_step_batched


@dataclass
class QueryTicket:
    """Handle of one submitted query, returned by ``submit`` at once.

    ``tol`` is the completion threshold on the per-slot convergence signal
    (L1 change of the last iteration for the ranking family, changed
    entries for the min/max relaxations); ``max_waves`` bounds the waves
    the query may hold a slot.  The defaults (``tol=0.0, max_waves=1``)
    complete every query after one summarized sweep, the batched
    counterpart of one ``engine.query()``.  ``result`` is the algorithm's
    ``result_view`` row as a host array once ``done``; ``converged`` says
    whether the tolerance was met (False when the wave budget ran out or
    the exact fallback served it).
    """

    ticket_id: int
    algorithm: str
    params: Dict
    tol: float = 0.0
    max_waves: int = 1
    # filled in by the engine
    done: bool = False
    converged: bool = False
    exact_fallback: bool = False
    waves_run: int = 0
    last_delta: float = float("inf")
    result: Optional[np.ndarray] = None
    _instance: Optional[StreamingAlgorithm] = None


@dataclass
class ServeStats:
    """Serving metrics, updated once per wave: queries served per second of
    wave wall time, mean slot occupancy over all lanes, and nearest-rank
    p50/p95 wave latency."""

    queries_submitted: int = 0
    queries_completed: int = 0
    waves: int = 0
    wall_s: float = 0.0
    overflow_fallbacks: int = 0
    occupancy_sum: float = 0.0
    wave_latencies_s: List[float] = field(default_factory=list)
    # quality_target engines: refreshes over all lanes, the last lane-wave's
    # worst-slot drift, the controller's last and lowest quality estimate
    refreshes: int = 0
    last_drift: float = 0.0
    quality_est: float = 1.0
    min_quality_est: float = 1.0
    # async_rebuild engines: the epoch the last wave served, and how far it
    # trailed the newest dispatched build (0 or 1)
    epoch: int = 0
    snapshot_lag: int = 0

    @property
    def queries_per_s(self) -> float:
        """Completed queries per second of wave wall time; 0.0 with no wall
        time (no wave, or waves too fast for the clock)."""
        return self.queries_completed / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_occupancy(self) -> float:
        """Mean fraction of slots occupied per wave, in [0, 1]; 0.0 before
        the first wave."""
        return self.occupancy_sum / self.waves if self.waves else 0.0

    def _latency_quantile(self, q: float) -> float:
        """Nearest-rank quantile of the wave latencies: the
        ``ceil(q·n)``-th order statistic (1-indexed), q clamped into [0, 1];
        0.0 with no sample."""
        lat = sorted(self.wave_latencies_s)
        if not lat:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        idx = min(max(math.ceil(q * len(lat)) - 1, 0), len(lat) - 1)
        return lat[idx]

    @property
    def p50_wave_latency_s(self) -> float:
        """Median wall-clock latency of one wave, in seconds."""
        return self._latency_quantile(0.50)

    @property
    def p95_wave_latency_s(self) -> float:
        """95th-percentile wall-clock latency of one wave, in seconds."""
        return self._latency_quantile(0.95)


@dataclass
class LaneWave:
    """What one lane's batched step did in one wave (the shared hot set
    and summary sizes, read back in the wave's one stats transfer), and
    under ``quality_target`` each slot's ``(drift_probe, drift_cold)`` and
    whether the lane's controller asked for a refresh."""

    wave: int
    algorithm: str
    occupied: int
    cold: int
    num_hot: int
    num_ek: int
    num_eb: int
    iterations: int
    overflow_fallback: bool
    row_drift: Optional[List[Tuple[float, float]]] = None
    refreshed: bool = False


@dataclass
class _Lane:
    """One algorithm family's slot bank: ``template`` is the instance
    shared by its requests, ``bank`` the ``[S, ...]`` state, ``tickets[i]``
    slot i's occupant (None = vacant), ``waves[i]`` the waves it has run and
    ``cold[i]`` whether it has yet to converge once (its waves then cover
    its seeds' reach, see :func:`fused_query_step_batched`);
    ``controller`` is the lane's own under ``quality_target``."""

    template: StreamingAlgorithm
    bank: AlgoState
    tickets: List[Optional[QueryTicket]]
    waves: List[int]
    cold: List[bool]
    queue: List[QueryTicket] = field(default_factory=list)
    controller: Optional[QualityController] = None

    @property
    def occupied(self) -> int:
        return sum(t is not None for t in self.tickets)

    def row_mask(self, device) -> torch.Tensor:
        return torch.tensor([t is not None for t in self.tickets],
                            dtype=torch.bool, device=device)


def _lane_key(algo: StreamingAlgorithm) -> Tuple:
    """Requests share a lane when they differ only in the knobs their
    algorithm declares state-carried (``per_query_params``); every other
    field, and the algorithm itself, is part of the key."""
    skip = set(algo.per_query_params)
    knobs = tuple((f.name, getattr(algo, f.name))
                  for f in dataclasses.fields(algo) if f.name not in skip)
    return (type(algo).__name__, algo.name) + knobs


class GraphServingEngine:
    """Continuous-batching front door over one VeilGraph engine.

    ``slots`` is the batch width per lane (one lane per algorithm family
    over the same shared graph).  Graph updates stream through
    :meth:`add_edges` / :meth:`remove_edges`, buffered in the wrapped
    engine and applied at the next wave boundary, so every query of a wave
    sees one graph.  ``wave_log`` keeps one :class:`LaneWave` per lane and
    wave.
    """

    def __init__(self, engine: VeilGraphEngine, *, slots: int = 4):
        if slots < 1:
            raise ValueError(f"slots must be >= 1; got {slots}")
        if not getattr(engine, "_started", False):
            raise ValueError(
                "GraphServingEngine wraps a *started* engine: call "
                "engine.start(...) (or build it with "
                "repro_torch.serve_session)")
        self.engine = engine
        self.slots = slots
        # the lanes push [slots, N] banks: tune their tiles for that batch
        engine.autotune_batch_hint = slots
        self.stats = ServeStats()
        self.wave_log: List[LaneWave] = []
        self._lanes: Dict[Tuple, _Lane] = {}
        # layouts shared by the lanes, keyed by normalized (weight,
        # reverse, semiring); cleared when an update batch is applied
        self._layouts: Dict[Tuple, B.EdgeLayout] = {}
        self._next_ticket = 0

    # ---- submission ------------------------------------------------------
    def submit(self, algorithm: Union[StreamingAlgorithm, str], *,
               tol: float = 0.0, max_waves: int = 1,
               **params) -> QueryTicket:
        """Enqueue one query and return its :class:`QueryTicket`.

        ``algorithm`` is a registry name with factory kwargs (e.g.
        ``submit("personalized-pagerank", seeds=(3,))``) or an instance; it
        must implement ``summarized_batched`` (every shipped algorithm
        does).  The request joins its family's lane and starts at the next
        wave with a free slot."""
        if max_waves < 1:
            raise ValueError(f"max_waves must be >= 1; got {max_waves}")
        algo = make_algorithm(algorithm, **params)
        if (type(algo).summarized_batched
                is StreamingAlgorithm.summarized_batched):
            raise TypeError(
                f"algorithm {algo.name!r} does not implement "
                "summarized_batched: it cannot be served in a batched lane "
                "(run it through engine.query() instead)")
        ticket = QueryTicket(ticket_id=self._next_ticket,
                             algorithm=algo.name, params=dict(params),
                             tol=float(tol), max_waves=int(max_waves),
                             _instance=algo)
        self._next_ticket += 1
        self.stats.queries_submitted += 1
        self._lane_for(algo).queue.append(ticket)
        return ticket

    @property
    def pending(self) -> int:
        """Queries submitted but not done (queued or in a slot)."""
        return sum(len(lane.queue) + lane.occupied
                   for lane in self._lanes.values())

    # ---- streaming passthrough -------------------------------------------
    def add_edges(self, src, dst, weights=None) -> "GraphServingEngine":
        """Buffer edge additions (optionally with a per-edge length
        column); applied at the next wave boundary."""
        self.engine.register_add_edges(
            np.asarray(src), np.asarray(dst),
            None if weights is None else np.asarray(weights))
        return self

    def remove_edges(self, src, dst) -> "GraphServingEngine":
        """Buffer edge removals; applied at the next wave boundary."""
        self.engine.register_remove_edges(np.asarray(src), np.asarray(dst))
        return self

    # ---- internals -------------------------------------------------------
    def _served_state(self):
        """The graph the next wave serves: the engine's, or under
        ``async_rebuild`` the served snapshot's (the live state may be
        under construction on the build stream)."""
        pipe = self.engine._pipeline
        return self.engine.state if pipe is None else pipe.current.state

    def _lane_for(self, algo: StreamingAlgorithm) -> _Lane:
        key = _lane_key(algo)
        lane = self._lanes.get(key)
        if lane is None:
            proto = algo.init_state(self._served_state())
            bank = {k: v[None].expand((self.slots,) + v.shape).clone()
                    for k, v in proto.items()}
            algo.validate_batch_state(bank, self.slots)
            cfg = self.engine.config
            controller = None
            if cfg.quality_target is not None:
                controller = QualityController(
                    cfg.quality_target, r0=cfg.r, delta0=cfg.delta,
                    adjust_r=cfg.control_r, adjust_delta=cfg.control_delta,
                    contraction=algo.drift_contraction)
            lane = _Lane(template=algo, bank=bank,
                         tickets=[None] * self.slots,
                         waves=[0] * self.slots, cold=[False] * self.slots,
                         controller=controller)
            self._lanes[key] = lane
        return lane

    def _spec_layouts(self, algo: StreamingAlgorithm, snap=None) -> Tuple:
        """The layouts of ``algo.layout_specs``, built once per applied
        update batch and shared by every lane that declares the same
        spec.  With ``snap`` (the async path's served snapshot) they are the
        snapshot's own, and each spec is registered with the engine so that
        every later snapshot sorts it at build time."""
        eng = self.engine
        out = []
        for spec in map(B.normalize_layout_spec, algo.layout_specs):
            if snap is not None:
                eng._async_specs[spec] = True
                out.append(snap.layout_for(spec, eng._build_spec_layout))
                continue
            layout = self._layouts.get(spec)
            if layout is None:
                layout = eng._build_spec_layout(eng.state, spec)
                self._layouts[spec] = layout
            out.append(layout)
        return tuple(out)

    def _apply_updates(self) -> None:
        """Wave-boundary ApplyUpdates: integrate buffered updates and drop
        the cached layouts (the engine drops its own)."""
        eng = self.engine
        if not eng._pending_count:
            return
        applied, _, _ = eng._apply_pending()
        if applied:
            eng._maybe_rebalance()
            self._layouts.clear()

    def _refill(self, lane: _Lane, state) -> None:
        """Seat queued requests in vacant slots: each newcomer's rows come
        from its own instance (its seeds or sources) over ``state`` (the
        wave's graph) and are written into the bank in place, so the bank
        keeps its shapes."""
        for i in range(self.slots):
            if lane.tickets[i] is not None or not lane.queue:
                continue
            ticket = lane.queue.pop(0)
            row = ticket._instance.init_state(state)
            for k, v in lane.bank.items():
                v[i] = row[k]
            lane.tickets[i] = ticket
            lane.waves[i] = 0
            lane.cold[i] = True

    def _harvest(self, lane: _Lane, row_delta: np.ndarray, *,
                 force: bool = False) -> None:
        """Complete finished occupants and free their slots: a row finishes
        when its signal reached the tolerance, its wave budget is spent, or
        ``force`` (the exact fallback answered it).  The results come to
        the host in one transfer per harvesting wave."""
        results = None
        for i, ticket in enumerate(lane.tickets):
            if ticket is None:
                continue
            ticket.waves_run = lane.waves[i]
            ticket.last_delta = float(row_delta[i])
            # a forced harvest answers exactly but never observed the
            # tolerance being met
            converged = (not force) and ticket.last_delta <= ticket.tol
            if converged or force:
                lane.cold[i] = False
            if not (converged or lane.waves[i] >= ticket.max_waves or force):
                continue
            if results is None:
                results = lane.template.result_view(lane.bank).cpu().numpy()
            ticket.result = results[i].copy()
            ticket.converged = converged
            ticket.done = True
            lane.tickets[i] = None
            lane.waves[i] = 0
            lane.cold[i] = False
            self.stats.queries_completed += 1

    def _exact_fallback(self, lane: _Lane, state, snap=None) -> None:
        """Summary overflow: serve every live row with an exact recompute
        of its own (single pushes) over the wave's graph ``state`` (and
        snapshot ``snap`` under ``async_rebuild``), then harvest them
        all."""
        for i, ticket in enumerate(lane.tickets):
            if ticket is None:
                continue
            row = {k: v[i] for k, v in lane.bank.items()}
            new_row, _ = ticket._instance.exact(
                row, state,
                layouts=self._spec_layouts(ticket._instance, snap))
            for k, v in lane.bank.items():
                v[i] = new_row[k]
            ticket.exact_fallback = True
        self.stats.overflow_fallbacks += 1
        if lane.controller is not None:
            # exact answers: the accumulated drift resets
            lane.controller.refreshed()
        self._harvest(lane, np.zeros(self.slots, np.float32), force=True)

    # ---- the wave loop ---------------------------------------------------
    def step(self) -> int:
        """Run one wave: apply updates, refill, one batched fused step per
        non-empty lane, harvest.  Returns the queries completed.

        Under ``async_rebuild`` the wave promotes the finished epoch build
        first, serves every lane from that snapshot, and integrates the
        buffered updates last, dispatching the next epoch's build behind
        the wave's work."""
        eng = self.engine
        cfg = eng.config
        pipe = eng._pipeline
        t0 = time.perf_counter()
        completed_before = self.stats.queries_completed
        snap = None
        if pipe is not None:
            promoted = pipe.promote()
            if promoted is not None:
                eng._finalize_promotion(promoted)
            snap = pipe.current
            state = snap.state
            self.stats.epoch = snap.epoch
        else:
            self._apply_updates()
            state = eng.state
        occupied = 0
        for lane in self._lanes.values():
            self._refill(lane, state)
            occupied += lane.occupied

        for lane in self._lanes.values():
            if lane.occupied == 0:
                continue
            row_mask = lane.row_mask(eng.device)
            ctl = lane.controller
            r_now = ctl.r_eff if ctl is not None else cfg.r
            delta_now = ctl.delta_eff if ctl is not None else cfg.delta
            cold = [c and t is not None
                    for c, t in zip(lane.cold, lane.tickets)]
            out = fused_query_step_batched(
                state, lane.bank, eng.deg_prev, eng.active_prev,
                eng._scalar(r_now), eng._scalar(delta_now), row_mask,
                torch.tensor(cold, dtype=torch.bool, device=eng.device),
                probe_ids=eng._probe_ids, algo=lane.template,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity, n=cfg.n,
                delta_hop_cap=cfg.delta_hop_cap, degree_mode=cfg.degree_mode,
                expand_both=cfg.expand_both,
                layouts=self._spec_layouts(lane.template, snap),
                shard_bucket_capacity=cfg.shard_hot_edge_capacity,
                with_drift=ctl is not None)
            new_bank, qs, row_delta = out[:3]
            # one transfer: the overflow flag and the wave's sizes
            num_hot, num_ek, num_eb, overflow = torch.stack([
                qs.num_hot.to(torch.int64), qs.num_ek.to(torch.int64),
                qs.num_eb.to(torch.int64),
                qs.used_fallback.to(torch.int64)]).tolist()
            self.wave_log.append(LaneWave(
                wave=self.stats.waves, algorithm=lane.template.name,
                occupied=lane.occupied, cold=sum(cold), num_hot=num_hot,
                num_ek=num_ek, num_eb=num_eb, iterations=int(qs.iterations),
                overflow_fallback=bool(overflow)))
            if overflow:
                # the batch result is invalid: discard it, serve rows exactly
                self._exact_fallback(lane, state, snap)
                continue
            lane.bank = new_bank
            for i in range(self.slots):
                if lane.tickets[i] is not None:
                    lane.waves[i] += 1
            if ctl is None:
                self._harvest(lane, row_delta.cpu().numpy())
                continue
            # the slots' drift rides the row_delta read
            vals = torch.cat([row_delta[:, None], out[3]], dim=1).cpu().numpy()
            drift = vals[:, 1:]
            probe = float(drift[:, 0].max(initial=0.0))
            cold_d = float(drift[:, 1].max(initial=0.0))
            dec = ctl.observe(probe, cold_d)
            self.stats.last_drift = max(probe, cold_d)
            self.stats.quality_est = dec.quality_est
            self.stats.min_quality_est = min(self.stats.min_quality_est,
                                             dec.quality_est)
            self.wave_log[-1].row_drift = [tuple(map(float, d))
                                           for d in drift]
            if dec.refresh:
                # out of budget: the live slots go cold again, so the next
                # wave covers them in full (the batched analogue of an
                # exact refresh), and the accumulated drift resets
                for i, t in enumerate(lane.tickets):
                    if t is not None:
                        lane.cold[i] = True
                self.stats.refreshes += 1
                self.wave_log[-1].refreshed = True
                ctl.refreshed()
            self._harvest(lane, vals[:, 0])

        if pipe is not None:
            # every lane's answer is read: integrate the buffered updates
            # and dispatch epoch N+1's build behind this wave's work
            if eng._pending_count:
                eng._async_integrate()
            self.stats.snapshot_lag = pipe.snapshot_lag
            # the served epoch's baselines become the next wave's
            eng.deg_prev, eng.active_prev = snap.deg, snap.active
        else:
            # the hot-set baselines advance as after engine.query()
            eng._refresh_baselines()
        wave_s = time.perf_counter() - t0
        self.stats.waves += 1
        self.stats.wall_s += wave_s
        self.stats.wave_latencies_s.append(wave_s)
        total_slots = max(len(self._lanes) * self.slots, 1)
        self.stats.occupancy_sum += occupied / total_slots
        return self.stats.queries_completed - completed_before

    def run(self, max_steps: int = 10_000) -> ServeStats:
        """Drive waves until every submitted query is done; raises after
        ``max_steps`` waves.  Returns the :class:`ServeStats`."""
        steps = 0
        while self.pending:
            if steps >= max_steps:
                raise RuntimeError(
                    f"serving did not drain after {max_steps} waves "
                    f"({self.pending} queries still pending)")
            self.step()
            steps += 1
        return self.stats

    # ---- lifecycle -------------------------------------------------------
    def close(self) -> None:
        """Fire the wrapped engine's OnStop UDF (``with``-exit calls it)."""
        self.engine.stop()

    def __enter__(self) -> "GraphServingEngine":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
