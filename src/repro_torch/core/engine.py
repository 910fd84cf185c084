"""VeilGraph execution engine, the paper's Alg. 1 (PyTorch port of the
synchronous path of ``repro.core.engine``).

The engine ingests stream messages (add / remove edges, query), buffers
updates until a query arrives, and serves each query through the five UDFs:

    OnStart -> [BeforeUpdates -> ApplyUpdates -> OnQuery ->
                {repeat-last | approximate | exact} -> OnQueryResult]* -> OnStop

Graph state, layouts and algorithm state live on ``EngineConfig.device``
(the card unless the config names another device); the UDFs are host
callbacks.  Sharding, autotuning, compressed weights, closed-loop quality
control and the async rebuild are not ported yet: their knobs raise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core.algorithm import (Action, AlgoState, PageRankAlgorithm,
                                        StreamingAlgorithm, make_algorithm,
                                        summaries_overflow)
from repro_torch.core.hotset import select_hot_set
from repro_torch.device import resolve_device
from repro_torch.graph import graph as G


@dataclass
class EngineConfig:
    """Engine configuration: buffer capacities, the paper's hot-set knobs
    (r, n, Δ) and where it runs.  The fields mirror the JAX package's
    ``EngineConfig`` so one set of values configures both; the ones whose
    slice has not landed must keep their defaults."""

    node_capacity: int
    edge_capacity: int
    hot_node_capacity: int
    hot_edge_capacity: int
    # PageRank knobs for the default algorithm (no algorithm passed)
    beta: float = 0.85
    num_iters: int = 30
    tol: float = 0.0
    # hot-set parameters (r, n, Δ): the paper's model knobs
    r: float = 0.2
    n: int = 1
    delta: float = 0.1
    delta_hop_cap: int = 4
    degree_mode: str = "out"
    expand_both: bool = False
    # update chunks are applied in pieces of at most this many edges
    update_pad: int = 1024
    # True runs the approximate action as one fused step; False runs
    # selection, summary and iteration as separate engine steps
    fused: bool = True
    # "auto" only: the port dispatches on the device of the tensors
    backend: str = "auto"
    # where the engine's tensors live; None = the card (raises without one)
    device: Optional[str] = None
    # not ported yet (ROADMAP queue 1): must keep these defaults
    autotune: str = "off"
    weight_dtype: Optional[str] = None
    mesh: Optional[object] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    num_shards: Optional[int] = None
    shard_hot_edge_capacity: Optional[int] = None
    rebalance_threshold: Optional[float] = 1.0
    quality_target: Optional[float] = None
    control_r: bool = True
    control_delta: bool = True
    drift_probes: int = 64
    async_rebuild: bool = False


#: knobs whose slice has not landed: field -> (value that is accepted,
#: ROADMAP queue 1 entry that ports it)
_NOT_PORTED = {
    "mesh": (None, 15), "num_shards": (None, 15),
    "shard_hot_edge_capacity": (None, 15), "autotune": ("off", 14),
    "weight_dtype": (None, 14), "quality_target": (None, 11),
    "async_rebuild": (False, 13),
}


def _check_config(config: EngineConfig) -> None:
    for name, (ok, entry) in _NOT_PORTED.items():
        if getattr(config, name) != ok:
            raise NotImplementedError(
                f"EngineConfig.{name}={getattr(config, name)!r} is not "
                f"ported to PyTorch yet (ROADMAP queue 1 entry {entry})")
    if config.backend != "auto":
        raise ValueError(
            f"EngineConfig.backend={config.backend!r}: the PyTorch port has "
            f"no backend names; it launches the CUDA kernel for tensors on "
            f"the GPU and the plain version for tensors on the CPU, so only "
            f"'auto' is accepted (choose the device with device=)")


@dataclass
class QueryStats:
    """One row of engine observability per served query: the action, wall
    time, graph / hot-set / summary sizes (``vertex_ratio``/``edge_ratio``
    are the paper's Figs. 4/8 axes), update accounting and the overflow
    flag."""

    query_id: int
    action: str
    wall_time_s: float
    num_nodes: int
    num_edges: int
    num_hot: int = 0
    num_kr: int = 0
    num_kn: int = 0
    num_kdelta: int = 0
    num_ek: int = 0
    num_eb: int = 0
    iterations: int = 0
    overflow_fallback: bool = False
    # additions + resolved removals integrated by this query
    pending_applied: int = 0
    removals_requested: int = 0
    removals_resolved: int = 0
    algorithm: str = "pagerank"

    @property
    def vertex_ratio(self) -> float:
        return self.num_hot / max(self.num_nodes, 1)

    @property
    def edge_ratio(self) -> float:
        # summary graph edges = E_K ∪ E_B, as a fraction of |E|
        return (self.num_ek + self.num_eb) / max(self.num_edges, 1)


def default_before_updates(pending: int, stats: Dict) -> bool:
    """Default BeforeUpdates UDF: always integrate pending updates."""
    return True


def default_on_query(query_id: int, view: Dict) -> Action:
    """Default OnQuery UDF: always take the summarized fast path."""
    return Action.APPROXIMATE


class VeilGraphEngine:
    """Streaming approximate graph-processing engine.

    ``algorithm`` is a :class:`StreamingAlgorithm` instance or registry
    name; omitted, the engine runs PageRank configured from the config's
    ``beta``/``num_iters``/``tol``.
    """

    def __init__(
        self,
        config: EngineConfig,
        algorithm: Union[StreamingAlgorithm, str, None] = None,
        *,
        on_start: Optional[Callable] = None,
        before_updates: Callable[[int, Dict], bool] = default_before_updates,
        on_query: Callable[[int, Dict], Action] = default_on_query,
        on_query_result: Optional[Callable] = None,
        on_stop: Optional[Callable] = None,
    ):
        _check_config(config)
        self.config = config
        self.device = resolve_device(config.device)
        if algorithm is None:
            algorithm = PageRankAlgorithm(
                beta=config.beta, num_iters=config.num_iters, tol=config.tol)
        self.algorithm = make_algorithm(algorithm)
        self._on_start = on_start
        self._before_updates = before_updates
        self._on_query = on_query
        self._on_query_result = on_query_result
        self._on_stop = on_stop

        self.state = G.empty(config.node_capacity, config.edge_capacity,
                             device=self.device)
        self.algo_state: AlgoState = self._init_algo_state()
        # edge layouts, sorted once per applied update batch and reused by
        # every sweep until the next one
        self._edge_layouts: Optional[Tuple[B.EdgeLayout, ...]] = None
        self.layout_builds = 0
        self.deg_prev = torch.zeros(config.node_capacity, dtype=torch.int32,
                                    device=self.device)
        self.active_prev = torch.zeros(config.node_capacity, dtype=torch.bool,
                                       device=self.device)
        self._pending_src: List[np.ndarray] = []
        self._pending_dst: List[np.ndarray] = []
        self._pending_len: List[Optional[np.ndarray]] = []
        self._pending_removals: List = []
        self._pending_count = 0
        self._pending_removal_count = 0
        # updates integrated while serving repeat-last answers
        self._stale_updates = 0
        self.stats_log: List[QueryStats] = []
        self._query_id = 0
        self._started = False

    @property
    def ranks(self) -> torch.Tensor:
        """The algorithm's result vector (PageRank's ranks by default)."""
        return self.algorithm.result_view(self.algo_state)

    def _init_algo_state(self) -> AlgoState:
        """init_state, checked once against the declared ``state_dtypes``."""
        state = self.algorithm.init_state(self.state)
        for key, want in self.algorithm.state_dtypes.items():
            if key not in state:
                raise ValueError(
                    f"{self.algorithm.name}.init_state missing declared "
                    f"state key {key!r}")
            if state[key].dtype != getattr(torch, want):
                raise ValueError(
                    f"{self.algorithm.name} state {key!r} declared "
                    f"{want} but init_state produced {state[key].dtype}")
        return state

    # ---- lifecycle -------------------------------------------------------
    def start(self, init_src: np.ndarray, init_dst: np.ndarray) -> QueryStats:
        """OnStart + load the initial graph G and compute the initial exact
        result (the paper's protocol: results already exist for G)."""
        if self._on_start:
            self._on_start(self)
        self.state = G.from_edges(init_src, init_dst,
                                  self.config.node_capacity,
                                  self.config.edge_capacity,
                                  device=self.device)
        self._edge_layouts = None
        self.algo_state = self._init_algo_state()
        t0 = time.perf_counter()
        self.algo_state, iters = self.algorithm.exact(
            self.algo_state, self.state, layouts=self.edge_layouts())
        self._synchronize()
        wall = time.perf_counter() - t0
        self.deg_prev = self._degree_snapshot()
        self.active_prev = self.state.node_active.clone()
        self._started = True
        num_nodes, num_edges = self._counts()
        st = QueryStats(query_id=-1, action="initial-exact", wall_time_s=wall,
                        num_nodes=num_nodes, num_edges=num_edges,
                        iterations=int(iters), algorithm=self.algorithm.name)
        self.stats_log.append(st)
        return st

    def stop(self):
        """OnStop: fire the shutdown UDF."""
        if self._on_stop:
            self._on_stop(self)

    # ---- stream ingestion ------------------------------------------------
    @staticmethod
    def _check_shapes(src: np.ndarray, dst: np.ndarray):
        if src.ndim != 1 or dst.ndim != 1 or src.shape != dst.shape:
            raise ValueError(
                f"src/dst must be 1-D arrays of equal length; got shapes "
                f"{src.shape} and {dst.shape}")

    def _check_ids(self, src: np.ndarray, dst: np.ndarray):
        # an out-of-range id would index outside the node buffers
        self._check_shapes(src, dst)
        if src.size == 0:
            return
        lo = min(int(src.min()), int(dst.min()))
        hi = max(int(src.max()), int(dst.max()))
        if lo < 0 or hi >= self.config.node_capacity:
            raise ValueError(
                f"edge endpoint id {lo if lo < 0 else hi} outside "
                f"[0, node_capacity={self.config.node_capacity})")

    def register_add_edges(self, src: np.ndarray, dst: np.ndarray,
                           weights: Optional[np.ndarray] = None):
        """Alg. 1 RegisterAddEdge: buffer an edge-addition chunk (validated
        on the host) until the next query's ApplyUpdates stage.  ``weights``
        optionally streams a per-edge length column."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        self._check_ids(src, dst)
        if weights is not None:
            weights = np.asarray(weights, np.float32)
            if weights.shape != src.shape:
                raise ValueError(
                    f"weights must match src/dst shape {src.shape}; got "
                    f"{weights.shape}")
        self._pending_src.append(src)
        self._pending_dst.append(dst)
        self._pending_len.append(weights)
        self._pending_count += src.shape[0]

    def register_remove_edges(self, src: np.ndarray, dst: np.ndarray):
        """Alg. 1 RegisterRemoveEdge: buffered and resolved to buffer slots
        at apply time; a removal matching no live slot counts as requested
        but not resolved."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        self._check_shapes(src, dst)
        self._pending_removals.append((src, dst))
        self._pending_count += len(src)
        self._pending_removal_count += len(src)

    @property
    def pending_updates(self) -> int:
        """Buffered updates (additions + removals) not yet applied."""
        return self._pending_count

    # ---- internals ---------------------------------------------------------
    def edge_layouts(self) -> Tuple[B.EdgeLayout, ...]:
        """Sorted edge layouts per ``algorithm.layout_specs``, built at most
        once per applied update batch."""
        if self._edge_layouts is None:
            self._edge_layouts = tuple(
                self._build_spec_layout(self.state, spec)
                for spec in map(B.normalize_layout_spec,
                                self.algorithm.layout_specs))
            self.layout_builds += 1
        return self._edge_layouts

    def _build_spec_layout(self, state: G.GraphState,
                           spec: Tuple) -> B.EdgeLayout:
        """The sorted layout of one normalized ``(weight, reverse,
        semiring)`` spec over ``state``: the one layout constructor of the
        engine's cache and of the serving engine's spec-keyed cache."""
        w, rev, s = spec
        return B.build_layout(state, weight=w, reverse=rev, semiring=s)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _counts(self) -> Tuple[int, int]:
        """(active vertices, live edges) in one device read."""
        c = torch.stack([self.state.num_active_nodes(),
                         self.state.num_live_edges()]).tolist()
        return c[0], c[1]

    def _degree_snapshot(self) -> torch.Tensor:
        # a copy: updates write the state's degree buffers in place
        if self.config.degree_mode == "out":
            return self.state.out_deg.clone()
        if self.config.degree_mode == "in":
            return self.state.in_deg.clone()
        return self.state.out_deg + self.state.in_deg

    def _apply_pending(self) -> Tuple[int, int, int]:
        """Apply buffered updates.  Returns ``(applied, removals_requested,
        removals_resolved)``; ``applied`` counts additions + resolved
        removals."""
        if not self._pending_count:
            return 0, 0, 0
        removals_requested = self._pending_removal_count
        removals_resolved = 0
        if self._pending_removals:
            r_src = np.concatenate([a for a, _ in self._pending_removals])
            r_dst = np.concatenate([b for _, b in self._pending_removals])
            slots = G.find_edge_slots(self.state, r_src, r_dst)
            self.state = G.remove_edges_by_slot(
                self.state, torch.from_numpy(slots))
            removals_resolved = int((slots >= 0).sum())
            if removals_resolved:
                self._edge_layouts = None
            self._pending_removals.clear()
            self._pending_removal_count = 0
        applied = removals_resolved
        if not self._pending_src:
            self._pending_count = 0
            return applied, removals_requested, removals_resolved
        src = np.concatenate(self._pending_src)
        dst = np.concatenate(self._pending_dst)
        if any(w is not None for w in self._pending_len):
            # unweighted chunks take the unit length explicitly so the
            # concatenation lines up
            lens = np.concatenate([
                w if w is not None else np.ones(s.shape[0], np.float32)
                for s, w in zip(self._pending_src, self._pending_len)])
        else:
            lens = None
        self._edge_layouts = None
        to = lambda a: torch.from_numpy(a).to(self.device)
        pad = self.config.update_pad
        k = src.shape[0]
        for lo in range(0, k, pad):
            hi = min(lo + pad, k)
            self.state = G.add_edges(
                self.state, to(src[lo:hi]), to(dst[lo:hi]),
                None if lens is None else to(lens[lo:hi]))
            applied += hi - lo
        self._pending_src.clear()
        self._pending_dst.clear()
        self._pending_len.clear()
        self._pending_count = 0
        return applied, removals_requested, removals_resolved

    def _stats_view(self, pending: int, applied: int) -> Dict:
        num_nodes, num_edges = self._counts()
        return {
            "pending": pending,
            "applied": applied,
            # everything not reflected in the current scores
            "since_compute": self._stale_updates + applied + pending,
            "num_nodes": num_nodes,
            "num_edges": num_edges,
            "algorithm": self.algorithm.name,
        }

    def _run_exact(self, st: QueryStats):
        self.algo_state, iters = self.algorithm.exact(
            self.algo_state, self.state, layouts=self.edge_layouts())
        st.iterations = int(iters)

    def _take_stats(self, st: QueryStats, stats) -> None:
        """Copy the size counters of a query step into ``st`` with one
        device read."""
        names = ("num_hot", "num_kr", "num_kn", "num_kdelta", "num_ek",
                 "num_eb")
        vals = torch.stack([getattr(stats, k).to(torch.int64)
                            for k in names]).tolist()
        for k, v in zip(names, vals):
            setattr(st, k, int(v))

    # ---- query serving ---------------------------------------------------
    def query(self, msg: Optional[Dict] = None) -> Tuple[np.ndarray, QueryStats]:
        """Serve one query (Alg. 1 lines 6-21).  Returns (scores, stats)."""
        if not self._started:
            raise RuntimeError("call start() first")
        qid = self._query_id
        self._query_id += 1
        cfg = self.config

        applied = removals_requested = removals_resolved = 0
        view = self._stats_view(self._pending_count, 0)
        if self._before_updates(self._pending_count, view):
            applied, removals_requested, removals_resolved = \
                self._apply_pending()
            # the OnQuery policy sees the post-update graph
            view = self._stats_view(self._pending_count, applied)

        action = self._on_query(qid, view)
        t0 = time.perf_counter()
        st = QueryStats(
            query_id=qid, action=action.value, wall_time_s=0.0,
            num_nodes=view["num_nodes"], num_edges=view["num_edges"],
            pending_applied=applied, removals_requested=removals_requested,
            removals_resolved=removals_resolved,
            algorithm=self.algorithm.name)

        if action == Action.REPEAT_LAST:
            self._stale_updates += applied  # previous scores returned as is
        elif action == Action.EXACT:
            self._run_exact(st)
            self._refresh_baselines()
        elif cfg.fused and self.algorithm.supports_fused:
            from repro_torch.core.fused import fused_query_step

            new_state, qs = fused_query_step(
                self.state, self.algo_state, self.deg_prev, self.active_prev,
                self._scalar(cfg.r), self._scalar(cfg.delta),
                algo=self.algorithm,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity, n=cfg.n,
                delta_hop_cap=cfg.delta_hop_cap, degree_mode=cfg.degree_mode,
                expand_both=cfg.expand_both, layouts=self.edge_layouts())
            self._take_stats(st, qs)
            if bool(qs.used_fallback):
                # capacities exceeded: the summarized state is invalid;
                # discard it and recompute exactly
                st.overflow_fallback = True
                self._run_exact(st)
            else:
                self.algo_state = new_state
                st.iterations = int(qs.iterations)
            self._refresh_baselines()
        else:  # APPROXIMATE, unfused: the same stages as separate steps
            hot, hstats = select_hot_set(
                self.state, self.deg_prev,
                self.algorithm.selection_view(self.algo_state),
                self._scalar(cfg.r), self._scalar(cfg.delta),
                active_prev=self.active_prev, n=cfg.n,
                delta_hop_cap=cfg.delta_hop_cap, degree_mode=cfg.degree_mode,
                expand_both=cfg.expand_both,
                normalize_scores=self.algorithm.normalize_selection_scores)
            summaries = self.algorithm.build_summaries(
                self.algo_state, self.state, hot,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity,
                layouts=self.edge_layouts())
            st.num_hot = int(hstats.num_hot)
            st.num_kr = int(hstats.num_kr)
            st.num_kn = int(hstats.num_kn)
            st.num_kdelta = int(hstats.num_kdelta)
            st.num_ek = int(summaries[0].num_ek)
            st.num_eb = int(sum(int(s.num_eb) for s in summaries))
            if bool(summaries_overflow(summaries)):
                st.overflow_fallback = True
                self._run_exact(st)
            else:
                self.algo_state, iters = self.algorithm.summarized(
                    self.algo_state, self.state, summaries)
                st.iterations = int(iters)
            self._refresh_baselines()

        if action != Action.REPEAT_LAST:
            self._stale_updates = 0
        scores = self.ranks.cpu().numpy()  # waits for the query's work
        st.wall_time_s = time.perf_counter() - t0
        self.stats_log.append(st)
        if self._on_query_result:
            self._on_query_result(qid, msg, action, self.ranks, st)
        return scores, st

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=self.device)

    def _refresh_baselines(self) -> None:
        """The current degrees and activity become the next query's t-1."""
        self.deg_prev = self._degree_snapshot()
        self.active_prev = self.state.node_active.clone()


#: EngineConfig field names (the session front door splits overrides on it)
CONFIG_FIELDS = frozenset(f.name for f in fields(EngineConfig))
