"""VeilGraph execution engine, the paper's Alg. 1 (PyTorch port of
``repro.core.engine``).

The engine ingests stream messages (add / remove edges, query), buffers
updates until a query arrives, and serves each query through the five UDFs:

    OnStart -> [BeforeUpdates -> ApplyUpdates -> OnQuery ->
                {repeat-last | approximate | exact} -> OnQueryResult]* -> OnStop

Graph state, layouts and algorithm state live on ``EngineConfig.device``
(the card unless the config names another device); the UDFs are host
callbacks.

``quality_target`` closes the accuracy loop (:mod:`repro_torch.core.
control`): the approximate step also computes a drift estimate, read with
its other stats, and a controller steers the effective r/Δ and asks for
exact refreshes.  ``async_rebuild`` serves queries from epoch snapshots
(:mod:`repro_torch.core.epoch`) while the next epoch's apply and layout
sorts run on a side CUDA stream.  ``autotune`` picks each layout's
merge-path tile (:mod:`repro_torch.kernels.spmv.autotune`) and
``weight_dtype`` stores the f32 semirings' full-graph edge weights as
bfloat16/float16; both are resolved at layout-build time, so every sweep
through a layout inherits them.  ``mesh`` (a ``DeviceMesh``) cuts
every full-graph layout into ``num_shards`` locally sorted edge shards, so
each O(E) sweep and each summary construction runs per shard and meets in
the semiring's all-reduce over the mesh (:mod:`repro_torch.graph.
partition`); ``rebalance_threshold`` recuts the partition when streaming
skews the shards' live edges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import backend as B
from repro_torch.core.algorithm import (Action, AlgoState, PageRankAlgorithm,
                                        StreamingAlgorithm, make_algorithm,
                                        summaries_overflow)
from repro_torch.core.control import QualityController, default_probe_ids
from repro_torch.core.epoch import (AsyncRebuildPipeline, EpochSnapshot,
                                    snapshot_counts)
from repro_torch.core.hotset import select_hot_set
from repro_torch.core.semiring import resolve_semiring
from repro_torch.device import resolve_device
from repro_torch.graph import graph as G
from repro_torch.graph.partition import (balanced_shard_slots,
                                         build_sharded_layout,
                                         mesh_shard_count,
                                         rebalance_decision,
                                         rebalance_sharded_layout,
                                         shard_slots)
from repro_torch.kernels.spmv import autotune as AT


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
    # the kernels' merge-path tile per full-graph layout: "off" (the
    # default tile), "cached" (a cached tuning, else the default) or "full"
    # (time every tile once per key on the first layout built for it, on
    # the card); tuned at the first build of a layout spec, never on an
    # async build's stream; summaries keep the default tile.
    # engine.autotune_runs counts the timed searches.
    autotune: str = "off"
    # the full-graph layouts' edge-weight storage: None (the semiring's
    # dtype) or "bfloat16"/"float16" (f32 semirings only; integer algebras
    # keep theirs).  Accumulation stays f32; summary weights stay f32.
    weight_dtype: Optional[str] = None
    # a torch.distributed DeviceMesh for sharded execution: every
    # full-graph layout is cut into num_shards locally sorted edge shards
    # over the mesh's mesh_axes (every dim by default, flattened into one
    # edge-shard axis), each rank pushes its num_shards / ranks of them in
    # a loop and the partials meet in the semiring's all-reduce over them
    # (graph/partition.py).  Its device type must be the engine's.  None =
    # one layout.
    mesh: Optional[object] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    # edge shards of a mesh engine: None = one per rank; a multiple of the
    # mesh's size runs the surplus shards as a loop on each rank (how one
    # card runs S-way partitioning and rebalancing on a 1-rank mesh)
    num_shards: Optional[int] = None
    # hot-edge slots per (shard, bucket) of the sharded summary: None =
    # ceil(hot_edge_capacity / S); a tighter cap shrinks the exchanged E_K
    # to S * this per shard and relies on the overflow flag (exact
    # fallback) for a skewed batch.  Needs a mesh.
    shard_hot_edge_capacity: Optional[int] = None
    # mesh engines: after each applied update batch, recut the edge
    # partition when the shards' live-edge imbalance ((max - min) / mean)
    # exceeds this; None keeps the contiguous cut.  Counted in
    # engine.rebalances.
    rebalance_threshold: Optional[float] = 1.0
    # closed-loop quality control (core/control.py): an accuracy target in
    # (0, 1), e.g. 0.95.  The approximate step also computes the drift
    # estimate (the fixed-point residual on drift_probes fixed vertices and
    # its mass outside K), and a QualityController steers the effective
    # r/Δ and asks for exact refreshes to keep the estimated error within
    # 1 - quality_target.  control_r/control_delta=False pin a knob (an r
    # or delta passed to the session pins it).  Needs the fused path.
    quality_target: Optional[float] = None
    control_r: bool = True
    control_delta: bool = True
    drift_probes: int = 64
    # epoch-versioned async rebuild (core/epoch.py): queries serve a frozen
    # snapshot N while snapshot N+1's apply and layout sorts run on a side
    # CUDA stream; epochs promote at query or wave boundaries only
    # (snapshot_lag 0 or 1).  Needs the fused path.
    async_rebuild: bool = False


def _check_mesh(config: EngineConfig, device: torch.device) -> None:
    """The mesh knobs: a ``DeviceMesh`` on the engine's device type (its
    ``mesh_axes``, every dim by default, flattened into the edge-shard
    axis), and ``num_shards``/``shard_hot_edge_capacity`` only with
    one."""
    mesh = config.mesh
    if mesh is None:
        for name in ("num_shards", "shard_hot_edge_capacity"):
            if getattr(config, name) is not None:
                # only the mesh layouts read it: accepted without a mesh
                # it would silently run unsharded
                raise ValueError(
                    f"EngineConfig.{name} requires mesh= (sharding and "
                    f"rebalancing are mesh-engine features; one device can "
                    f"pass a 1-rank mesh with num_shards=S)")
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"EngineConfig.mesh must be a torch.distributed "
                        f"DeviceMesh; got {type(mesh).__name__}")
    size = mesh_shard_count(mesh, config.mesh_axes)
    if mesh.device_type != device.type:
        raise ValueError(f"EngineConfig.mesh is a {mesh.device_type!r} mesh; "
                         f"the engine runs on {device}")
    if config.num_shards is not None and (config.num_shards < 1
                                          or config.num_shards % size):
        raise ValueError(f"EngineConfig.num_shards={config.num_shards} must "
                         f"be a positive multiple of the mesh's {size} ranks")


def _check_config(config: EngineConfig) -> None:
    if config.autotune not in AT.MODES:
        raise ValueError(f"EngineConfig.autotune={config.autotune!r}; "
                         f"expected one of {AT.MODES}")
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
    and rebalance flags."""

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
    # mesh engines: this query's applied updates pushed the shards' live
    # edges past rebalance_threshold and the partition was recut
    rebalanced: bool = False
    algorithm: str = "pagerank"
    # quality_target engines: the drift this query observed, the
    # controller's quality estimate, the knobs it ran with, and whether it
    # was refreshed exactly (an exact action and an overflow fallback count)
    drift: float = 0.0
    quality_est: float = 1.0
    r_eff: float = 0.0
    delta_eff: float = 0.0
    refreshed: bool = False
    # async_rebuild engines: the epoch this query was served from, and how
    # far it trailed the newest dispatched build (0 or 1)
    epoch: int = 0
    snapshot_lag: int = 0

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
        _check_mesh(config, self.device)
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
        # the batch rows of this engine's pushes, part of each tuning key:
        # 1 here, the slots under a serving engine
        self.autotune_batch_hint = 1
        # tuned merge tiles by (semiring, batch hint), resolved at the first
        # build of a spec, on the current stream
        self._tiles: Dict[Tuple[str, int], int] = {}
        self._in_build = False
        # mesh engines: the slot→shard assignment (None = the contiguous
        # cut), the recuts so far and the last measured imbalance
        self._shard_slots: Optional[torch.Tensor] = None
        self._contiguous_slots: Optional[torch.Tensor] = None
        self.rebalances = 0
        self.last_imbalance = 0.0
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
        # the state's num_edges, held on the host so that an apply reads
        # nothing from the device
        self._num_edges = 0
        # closed-loop quality control: the controller and the probe set
        self.controller: Optional[QualityController] = None
        self._probe_ids: Optional[torch.Tensor] = None
        if config.quality_target is not None:
            self._require_fused("quality_target")
            self.controller = QualityController(
                config.quality_target, r0=config.r, delta0=config.delta,
                adjust_r=config.control_r,
                adjust_delta=config.control_delta,
                contraction=self.algorithm.drift_contraction)
            self._probe_ids = default_probe_ids(
                config.node_capacity, config.drift_probes, self.device)
        # async rebuild: the pipeline (from start()), the ordered set of
        # layout specs every new snapshot sorts at build time (the
        # algorithm's, and each serving lane's), and the build stream
        self._pipeline: Optional[AsyncRebuildPipeline] = None
        self._async_specs: Dict[Tuple, bool] = {}
        self._build_stream = None
        if config.async_rebuild:
            self._require_fused("async_rebuild")
            for spec in map(B.normalize_layout_spec,
                            self.algorithm.layout_specs):
                self._async_specs[spec] = True
            if self.device.type == "cuda":
                self._build_stream = torch.cuda.Stream(self.device)
        # updates integrated while serving repeat-last answers
        self._stale_updates = 0
        self.stats_log: List[QueryStats] = []
        self._query_id = 0
        self._started = False

    def _require_fused(self, knob: str) -> None:
        if not (self.config.fused and self.algorithm.supports_fused):
            raise ValueError(
                f"{knob} requires the fused query path (fused=True and a "
                f"supports_fused algorithm; got fused={self.config.fused}, "
                f"algorithm={self.algorithm.name!r})")

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
        self._num_edges = int(np.asarray(init_src).shape[0])
        self._edge_layouts = None
        self.algo_state = self._init_algo_state()
        t0 = time.perf_counter()
        self.algo_state, iters = self.algorithm.exact(
            self.algo_state, self.state, layouts=self.edge_layouts())
        self._synchronize()
        wall = time.perf_counter() - t0
        self.deg_prev = self._degree_snapshot()
        self.active_prev = self.state.node_active.clone()
        if self.config.async_rebuild:
            # epoch 0 is the initial graph, its layouts those of the exact
            # pass; it is never promoted, so its counts are read here
            snap0 = self._make_snapshot(0)
            self._finalize_promotion(snap0)
            self._pipeline = AsyncRebuildPipeline(snap0)
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
    def edge_layouts(self) -> Tuple[B.AnyEdgeLayout, ...]:
        """Sorted edge layouts per ``algorithm.layout_specs``, built at most
        once per applied update batch: on a mesh engine, sharded ones, each
        shard sorted on its own."""
        if self._edge_layouts is None:
            self._edge_layouts = tuple(
                self._build_spec_layout(self.state, spec)
                for spec in map(B.normalize_layout_spec,
                                self.algorithm.layout_specs))
            self.layout_builds += 1
        return self._edge_layouts

    def _build_spec_layout(self, state: G.GraphState,
                           spec: Tuple) -> B.AnyEdgeLayout:
        """The sorted layout of one normalized ``(weight, reverse,
        semiring)`` spec over ``state``: the one layout constructor of the
        engine's cache, of the serving engine's spec-keyed cache and of the
        epoch snapshots' builds.  It stamps the tuned merge tile and stores
        the weights in the configured ``weight_dtype``.  A mesh engine gets
        a sharded layout cut at the current slot assignment, holding this
        rank's shards."""
        w, rev, s = spec
        cfg = self.config
        if cfg.mesh is None:
            layout = B.build_layout(state, weight=w, reverse=rev, semiring=s,
                                    weight_dtype=self._weight_dtype_for(s))
        else:
            layout = build_sharded_layout(
                state, mesh=cfg.mesh, axes=cfg.mesh_axes,
                num_shards=self._num_shards(), weight=w, reverse=rev,
                semiring=s, slots=self._shard_slots,
                weight_dtype=self._weight_dtype_for(s), placed=True)
        tile = self._tuned_geometry(s, layout)
        return (layout if tile is None
                else dataclasses.replace(layout, merge_tile=tile))

    def _tuned_geometry(self, semiring,
                        layout: B.AnyEdgeLayout) -> Optional[int]:
        """The merge tile of one layout spec's semiring, resolved at its
        first layout build and kept for the engine's life, so every push
        through its full-graph layouts (exact sweeps, ``b_in``, batched)
        takes it; ``None`` (the kernels' default) when autotuning is off.
        Summaries' E_K layouts keep the default tile.  A ``"full"`` tuning
        times the candidates on ``layout``, the first one built, and on
        the current stream, so it must never first run inside an async
        build (:meth:`_resolve_tiles` runs it before one).  A sharded
        layout is tuned at the per-shard stream length, on its first
        shard."""
        cfg = self.config
        if cfg.autotune == "off":
            return None
        s = resolve_semiring(semiring)
        key = (s.name, self.autotune_batch_hint)
        tile = self._tiles.get(key)
        if tile is None:
            if self._in_build:
                raise RuntimeError(
                    f"merge tile of {s.name!r} at batch "
                    f"{self.autotune_batch_hint} not resolved before an "
                    f"async build")
            e_cap, sample = cfg.edge_capacity, layout
            if isinstance(layout, B.ShardedEdgeLayout):
                e_cap = -(-e_cap // layout.num_shards)
                sample = B._shard_view(layout, 0)
            tile = self._tiles[key] = AT.tune_for_push(
                edge_capacity=e_cap, num_segments=cfg.node_capacity,
                batch=self.autotune_batch_hint, dtype=s.dtype, reduce=s.add,
                weight_dtype=self._weight_dtype_for(s), mode=cfg.autotune,
                device=self.device,
                sample=(sample.src, sample.weight, sample.row_offsets))
        return tile

    def _resolve_tiles(self) -> None:
        """Tune every spec an async build sorts whose tile is not resolved
        yet, here on the current stream and on the served snapshot's
        layout of the spec, before the build's stream takes over."""
        if self.config.autotune == "off":
            return
        snap = self._pipeline.current
        for spec in self._async_specs:
            s = resolve_semiring(spec[2])
            if (s.name, self.autotune_batch_hint) not in self._tiles:
                self._tuned_geometry(
                    s, snap.layout_for(spec, self._build_spec_layout))

    def _weight_dtype_for(self, semiring) -> Optional[str]:
        """The configured weight storage for an f32 semiring; integer
        algebras (``min_min`` labels) keep their own dtype, so that a
        mixed-algebra algorithm is not refused."""
        wd = self.config.weight_dtype
        if wd is None:
            return None
        if resolve_semiring(semiring).dtype != "float32":
            return None
        return wd

    def _num_shards(self) -> int:
        """A mesh engine's edge shards: ``num_shards``, else one a rank."""
        cfg = self.config
        return (cfg.num_shards if cfg.num_shards is not None
                else mesh_shard_count(cfg.mesh, cfg.mesh_axes))

    def _measures_balance(self) -> bool:
        """Whether this engine measures its shards' balance: a mesh engine
        with a ``rebalance_threshold``."""
        cfg = self.config
        return cfg.mesh is not None and cfg.rebalance_threshold is not None

    def _current_slots(self) -> torch.Tensor:
        """The slot assignment the layouts are cut by: the last recut's,
        else the contiguous cut (uploaded once)."""
        if self._shard_slots is not None:
            return self._shard_slots
        if self._contiguous_slots is None:
            self._contiguous_slots = self._to_device(shard_slots(
                self.state.edge_capacity, self._num_shards()))
        return self._contiguous_slots

    def _recut(self, slots: torch.Tensor) -> None:
        """Adopt a rebalanced assignment: the cached layouts go, so the
        next build gathers every stream by it."""
        self._shard_slots = slots
        self.rebalances += 1
        self._edge_layouts = None

    def _maybe_rebalance(self) -> bool:
        """Recut the edge partition when streaming has skewed the shards'
        live edges past ``config.rebalance_threshold``: once per applied
        update batch of the synchronous path, on mesh engines only, by
        :func:`~repro_torch.graph.partition.rebalance_sharded_layout` (its
        one read of the verdict).  ``rebalances`` counts the recuts and
        ``last_imbalance`` keeps the latest measurement."""
        if not self._measures_balance():
            return False
        slots, recut, self.last_imbalance = rebalance_sharded_layout(
            self.state, num_shards=self._num_shards(),
            slots=self._current_slots(),
            threshold=self.config.rebalance_threshold)
        if recut:
            self._recut(slots)
        return recut

    @property
    def autotune_runs(self) -> int:
        """Timed tile searches so far in this process (cache answers and
        ``"cached"`` misses excluded)."""
        return AT.run_count()

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; to the card through pinned
        memory without waiting for the copy (it is ordered on the current
        stream), so an apply makes no host read."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _apply_pending(self, preserve: bool = False) -> Tuple[int, int, int]:
        """Apply buffered updates.  Returns ``(applied, removals_requested,
        removals_resolved)``; ``applied`` counts additions + resolved
        removals.

        ``preserve=True`` (the async rebuild) applies to a clone of the
        state, so the served snapshot's buffers stay as they are.  Removals
        are resolved to slots on the host (one read of the live state);
        additions read nothing from the device."""
        if not self._pending_count:
            return 0, 0, 0
        cloned = not preserve

        def writable():
            nonlocal cloned
            if not cloned:
                self.state = G.clone(self.state)
                cloned = True

        removals_requested = self._pending_removal_count
        removals_resolved = 0
        if self._pending_removals:
            r_src = np.concatenate([a for a, _ in self._pending_removals])
            r_dst = np.concatenate([b for _, b in self._pending_removals])
            slots = G.find_edge_slots(self.state, r_src, r_dst)
            removals_resolved = int((slots >= 0).sum())
            if removals_resolved:
                writable()
                self.state = G.remove_edges_by_slot(self.state,
                                                    self._to_device(slots))
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
        writable()
        to = self._to_device
        pad = self.config.update_pad
        k = src.shape[0]
        for lo in range(0, k, pad):
            hi = min(lo + pad, k)
            self.state = G.add_edges(
                self.state, to(src[lo:hi]), to(dst[lo:hi]),
                None if lens is None else to(lens[lo:hi]),
                num_edges=self._num_edges)
            self._num_edges = min(self._num_edges + hi - lo,
                                  self.config.edge_capacity)
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

    def _take_stats(self, st: QueryStats,
                    stats) -> Optional[Tuple[float, float]]:
        """Copy the size counters and the overflow flag of a query step
        into ``st`` with one device read, and return its drift pair
        ``(drift_probe, drift_cold)`` from the same read (None without
        it).  f64 holds the int32 counts and the f32 drifts exactly."""
        names = ("num_hot", "num_kr", "num_kn", "num_kdelta", "num_ek",
                 "num_eb", "used_fallback")
        parts = [getattr(stats, k) for k in names]
        if isinstance(stats.drift_probe, torch.Tensor):
            parts += [stats.drift_probe, stats.drift_cold]
        vals = torch.stack([t.to(torch.float64) for t in parts]).tolist()
        for k, v in zip(names[:-1], vals):
            setattr(st, k, int(v))
        st.overflow_fallback = bool(vals[len(names) - 1])
        return tuple(vals[len(names):]) or None

    def _observe(self, st: QueryStats, drift, r_now: float,
                 delta_now: float, refresh: Callable[[], None]) -> None:
        """Fold an approximate query's drift reading into the controller:
        knobs for the next query and, when the estimate leaves the budget,
        ``refresh()`` (an exact recompute).  An overflow fallback was a
        refresh already."""
        ctl = self.controller
        if ctl is None:
            return
        st.r_eff, st.delta_eff = float(r_now), float(delta_now)
        if st.overflow_fallback:
            st.quality_est = 1.0
            return
        probe, cold = drift
        dec = ctl.observe(probe, cold)
        st.drift = max(probe, cold)
        st.quality_est = dec.quality_est
        if dec.refresh:
            refresh()
            ctl.refreshed()
            st.refreshed = True
            st.quality_est = 1.0

    def _refreshed(self, st: QueryStats) -> None:
        """An exact answer (action or fallback) resets the controller."""
        if self.controller is not None:
            self.controller.refreshed()
            st.refreshed = True

    def _knobs(self) -> Tuple[float, float]:
        """The (r, Δ) of the next approximate query: the controller's when
        there is one."""
        ctl = self.controller
        if ctl is None:
            return self.config.r, self.config.delta
        return ctl.r_eff, ctl.delta_eff

    # ---- epoch-versioned async rebuild -----------------------------------
    def _make_snapshot(self, epoch: int, *, applied: int = 0,
                       removals_requested: int = 0,
                       removals_resolved: int = 0) -> EpochSnapshot:
        """Freeze the current state as snapshot ``epoch`` and enqueue what
        it serves from: its baselines, its counts and the layout of every
        spec the engine has served so far.  Nothing here reads the
        device."""
        snap = EpochSnapshot(
            epoch=epoch, state=self.state, deg=self._degree_snapshot(),
            active=self.state.node_active.clone(),
            counts=snapshot_counts(self.state), applied=applied,
            removals_requested=removals_requested,
            removals_resolved=removals_resolved,
            rebalance_probe=(self._dispatch_rebalance_probe()
                             if applied else None))
        if self._edge_layouts is not None:
            # start(): the engine's layouts are those of this very state
            for spec, layout in zip(
                    map(B.normalize_layout_spec, self.algorithm.layout_specs),
                    self._edge_layouts):
                snap.layouts[spec] = layout
        built = False
        for spec in self._async_specs:
            if spec not in snap.layouts:
                snap.layout_for(spec, self._build_spec_layout)
                built = True
        if built:
            self.layout_builds += 1
        return snap

    def _snapshot_layouts(self, snap: EpochSnapshot) -> Tuple:
        """The snapshot's layouts per ``algorithm.layout_specs``."""
        return tuple(
            snap.layout_for(spec, self._build_spec_layout)
            for spec in map(B.normalize_layout_spec,
                            self.algorithm.layout_specs))

    def _dispatch_rebalance_probe(self):
        """The shard-rebalance verdict of the state being snapshotted, left
        on the device until promotion (:meth:`_finalize_promotion` reads
        it): the async path's replacement for :meth:`_maybe_rebalance`.
        None on an engine that does not rebalance."""
        if not self._measures_balance():
            return None
        return rebalance_decision(self.state, self._current_slots(),
                                  self.config.rebalance_threshold)

    def _finalize_promotion(self, snap: EpochSnapshot) -> bool:
        """Host bookkeeping of a snapshot about to be served: the current
        stream waits for its build, takes over its tensors (so that the
        allocator reuses none of them while this stream may still read
        them), and its counts are read (the one read per epoch that
        replaces the synchronous path's per-query count read; it waits for
        the build, which the query needs anyway).  On a mesh engine the
        snapshot's rebalance verdict rides that read; a recut applies to
        the next epoch's layouts, never to this sorted snapshot.  Returns
        True on a recut."""
        if snap.events is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(snap.events[1])
            for t in _snapshot_tensors(snap):
                t.record_stream(main)
        probe, snap.rebalance_probe = snap.rebalance_probe, None
        if probe is None:
            snap.num_nodes, snap.num_edges = snap.counts.tolist()
            return False
        # the verdict rides the counts' read: the imbalance as its f32 bits
        vals = torch.cat([snap.counts, probe[0].to(torch.int32)[None],
                          probe[1].view(torch.int32)[None]]).tolist()
        snap.num_nodes, snap.num_edges = vals[0], vals[1]
        self.last_imbalance = float(np.int32(vals[3]).view(np.float32))
        if vals[2]:
            self._recut(balanced_shard_slots(self.state,
                                             num_shards=self._num_shards()))
        return bool(vals[2])

    def _async_integrate(self) -> Tuple[int, int, int]:
        """ApplyUpdates of the async path, after the query's answer is
        read: apply the buffered updates to a clone of the state and
        dispatch the next epoch's snapshot.  On the card the work runs on
        the build stream, after the work enqueued so far on the current
        stream, between two timing events.  An all-unresolved removal
        batch mutates nothing and dispatches no epoch."""
        pipe = self._pipeline
        self._resolve_tiles()
        side, events = self._build_stream, None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            self._in_build = True
            try:
                if events is not None:
                    events[0].record(side)
                applied, requested, resolved = self._apply_pending(
                    preserve=True)
                snap = None
                if applied:
                    snap = self._make_snapshot(
                        pipe.latest_epoch + 1, applied=applied,
                        removals_requested=requested,
                        removals_resolved=resolved)
                if events is not None:
                    events[1].record(side)
            finally:
                self._in_build = False
        if snap is not None:
            snap.events = events
            pipe.dispatch(snap)
        return applied, requested, resolved

    def _run_exact_on(self, snap: EpochSnapshot, st: QueryStats) -> None:
        """An exact recompute on the served snapshot (a refresh or
        fallback of the async path must not see the epoch being built)."""
        self.algo_state, iters = self.algorithm.exact(
            self.algo_state, snap.state, layouts=self._snapshot_layouts(snap))
        st.iterations = int(iters)

    def _query_async(self, msg: Optional[Dict]) -> Tuple[np.ndarray,
                                                         QueryStats]:
        """Serve one query from the epoch pipeline, in four steps: (1)
        promote the finished build; (2) compute on the served snapshot;
        (3) read the stats and the answer; (4) integrate the buffered
        updates and dispatch the next epoch.  The reference integrates
        before its reads, as its dispatch returns at once; here enqueuing
        the build is eager host work, so the answer is read first and
        ``wall_time_s`` ends there.  Updates integrated at
        query q become visible at q+1's promotion and are charged to that
        query's row."""
        from repro_torch.core.fused import fused_query_step

        qid = self._query_id
        self._query_id += 1
        cfg = self.config
        pipe = self._pipeline

        # (1) the boundary: flip in the finished build, if any
        promoted = pipe.promote()
        rebalanced = (promoted is not None
                      and self._finalize_promotion(promoted))
        snap = pipe.current
        applied = promoted.applied if promoted is not None else 0
        view = {
            "pending": self._pending_count,
            "applied": applied,
            "since_compute": (self._stale_updates + applied
                              + self._pending_count),
            "num_nodes": snap.num_nodes,
            "num_edges": snap.num_edges,
            "algorithm": self.algorithm.name,
            "epoch": snap.epoch,
        }
        integrate = self._before_updates(self._pending_count, view)
        action = self._on_query(qid, view)
        t0 = time.perf_counter()
        st = QueryStats(
            query_id=qid, action=action.value, wall_time_s=0.0,
            num_nodes=snap.num_nodes, num_edges=snap.num_edges,
            pending_applied=applied,
            removals_requested=(promoted.removals_requested
                                if promoted is not None else 0),
            removals_resolved=(promoted.removals_resolved
                               if promoted is not None else 0),
            rebalanced=rebalanced, algorithm=self.algorithm.name,
            epoch=snap.epoch)

        # (2) this query's compute on the served snapshot
        new_state = qs = None
        r_now, delta_now = self._knobs()
        if action == Action.APPROXIMATE:
            new_state, qs = fused_query_step(
                snap.state, self.algo_state, self.deg_prev, self.active_prev,
                self._scalar(r_now), self._scalar(delta_now),
                self._probe_ids, algo=self.algorithm,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity, n=cfg.n,
                delta_hop_cap=cfg.delta_hop_cap, degree_mode=cfg.degree_mode,
                expand_both=cfg.expand_both,
                layouts=self._snapshot_layouts(snap),
                shard_bucket_capacity=cfg.shard_hot_edge_capacity,
                with_drift=self.controller is not None)
        elif action == Action.EXACT:
            self._run_exact_on(snap, st)

        # (3) the reads, which wait for step 2's work
        if action == Action.REPEAT_LAST:
            self._stale_updates += applied
        elif action == Action.EXACT:
            self._refreshed(st)
        else:
            drift = self._take_stats(st, qs)
            if st.overflow_fallback:
                self._run_exact_on(snap, st)
                self._refreshed(st)
            else:
                self.algo_state = new_state
                st.iterations = int(qs.iterations)
            self._observe(st, drift, r_now, delta_now,
                          lambda: self._run_exact_on(snap, st))
        if action != Action.REPEAT_LAST:
            # the epoch's own baselines become the next query's, so drift
            # is measured across whole epochs
            self.deg_prev, self.active_prev = snap.deg, snap.active
            self._stale_updates = 0
        scores = self.ranks.cpu().numpy()
        st.wall_time_s = time.perf_counter() - t0

        # (4) integrate and dispatch epoch N+1, behind the answer
        if integrate and self._pending_count:
            _, extra_req, extra_res = self._async_integrate()
            if pipe.building is None and extra_req:
                # nothing mutated (every removal unresolved): no new
                # epoch, so the request shows on this row only
                st.removals_requested += extra_req - extra_res
        st.snapshot_lag = pipe.snapshot_lag
        self.stats_log.append(st)
        if self._on_query_result:
            self._on_query_result(qid, msg, action, self.ranks, st)
        return scores, st

    # ---- query serving ---------------------------------------------------
    def query(self, msg: Optional[Dict] = None) -> Tuple[np.ndarray, QueryStats]:
        """Serve one query (Alg. 1 lines 6-21).  Returns (scores, stats)."""
        if not self._started:
            raise RuntimeError("call start() first")
        if self._pipeline is not None:
            return self._query_async(msg)
        qid = self._query_id
        self._query_id += 1
        cfg = self.config

        applied = removals_requested = removals_resolved = 0
        rebalanced = False
        view = self._stats_view(self._pending_count, 0)
        if self._before_updates(self._pending_count, view):
            applied, removals_requested, removals_resolved = \
                self._apply_pending()
            if applied:
                rebalanced = self._maybe_rebalance()
            # the OnQuery policy sees the post-update graph
            view = self._stats_view(self._pending_count, applied)

        action = self._on_query(qid, view)
        t0 = time.perf_counter()
        st = QueryStats(
            query_id=qid, action=action.value, wall_time_s=0.0,
            num_nodes=view["num_nodes"], num_edges=view["num_edges"],
            pending_applied=applied, removals_requested=removals_requested,
            removals_resolved=removals_resolved, rebalanced=rebalanced,
            algorithm=self.algorithm.name)

        if action == Action.REPEAT_LAST:
            self._stale_updates += applied  # previous scores returned as is
        elif action == Action.EXACT:
            self._run_exact(st)
            self._refreshed(st)
            self._refresh_baselines()
        elif cfg.fused and self.algorithm.supports_fused:
            from repro_torch.core.fused import fused_query_step

            r_now, delta_now = self._knobs()
            new_state, qs = fused_query_step(
                self.state, self.algo_state, self.deg_prev, self.active_prev,
                self._scalar(r_now), self._scalar(delta_now),
                self._probe_ids, algo=self.algorithm,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity, n=cfg.n,
                delta_hop_cap=cfg.delta_hop_cap, degree_mode=cfg.degree_mode,
                expand_both=cfg.expand_both, layouts=self.edge_layouts(),
                shard_bucket_capacity=cfg.shard_hot_edge_capacity,
                with_drift=self.controller is not None)
            drift = self._take_stats(st, qs)
            if st.overflow_fallback:
                # capacities exceeded: the summarized state is invalid;
                # discard it and recompute exactly
                self._run_exact(st)
                self._refreshed(st)
            else:
                self.algo_state = new_state
                st.iterations = int(qs.iterations)
            self._observe(st, drift, r_now, delta_now,
                          lambda: self._run_exact(st))
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
            from repro_torch.core.fused import summary_kwargs

            summaries = self.algorithm.build_summaries(
                self.algo_state, self.state, hot,
                hot_node_capacity=cfg.hot_node_capacity,
                hot_edge_capacity=cfg.hot_edge_capacity,
                layouts=self.edge_layouts(),
                **summary_kwargs(cfg.shard_hot_edge_capacity))
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


def _snapshot_tensors(snap: EpochSnapshot):
    """Every tensor of a snapshot: its graph buffers, baselines, counts and
    layouts."""
    yield from (t for t in snap.state if t is not None)
    yield from (snap.deg, snap.active, snap.counts)
    for layout in snap.layouts.values():
        for f in dataclasses.fields(layout):
            t = getattr(layout, f.name)
            if isinstance(t, torch.Tensor):
                yield t


#: EngineConfig field names (the session front door splits overrides on it)
CONFIG_FIELDS = frozenset(f.name for f in fields(EngineConfig))
