"""The session-style front door (PyTorch port of ``repro.api``).

One call builds a started engine on the card:

    import repro_torch as veilgraph

    with veilgraph.session((src, dst), algorithm="pagerank") as s:
        s.add_edges(new_src, new_dst)
        result = s.query()
        print(result.top(10), result.stats.vertex_ratio)

``graph_source`` may be a ``(src, dst)`` edge-array pair, a named synthetic
dataset (``repro_torch.graph.generators.DATASETS``) or an
:class:`~repro_torch.stream.EdgeStream` (then ``s.play()`` replays its
chunks, one query per chunk).  :func:`serve_session` wraps a session for
slot-batched serving of many concurrent queries.  Both run on the CUDA
device unless ``device=`` names another one; with no device given and no
GPU present they raise.  Capacities are sized from the source when no
:class:`EngineConfig` is given, with hot buffers at full capacity so a
fresh session never falls back to exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np

from repro_torch.core.algorithm import (Action, StreamingAlgorithm,
                                        algorithm_factory,
                                        available_algorithms,
                                        factory_accepts, make_algorithm)
from repro_torch.core.engine import (CONFIG_FIELDS, EngineConfig, QueryStats,
                                     VeilGraphEngine)
from repro_torch.graph.generators import DATASETS, generate
from repro_torch.stream import EdgeStream

GraphSource = Union[str, Tuple[np.ndarray, np.ndarray], EdgeStream]


def _result_valid(scores: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Vertices whose result value is an answer, not padding: active, and
    not a ⊕-identity sentinel (±∞, int extrema)."""
    valid = np.asarray(active, bool).copy()
    if np.issubdtype(scores.dtype, np.floating):
        valid &= np.isfinite(scores)
    elif np.issubdtype(scores.dtype, np.integer):
        info = np.iinfo(scores.dtype)
        valid &= (scores != info.max) & (scores != info.min)
    return valid


def _top_ids(scores: np.ndarray, k: int, *, descending: bool = True,
             valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Ids of the k best-ranked vertices (stable ties), invalid ones
    dropped."""
    order = np.argsort(-scores if descending else scores, kind="stable")
    if valid is not None:
        order = order[valid[order]]
    return order[:k]


@dataclass
class QueryResult:
    """One served query: the result vector (a host array) plus the
    engine's stats row.  ``valid`` masks the entries that are answers."""

    scores: np.ndarray
    stats: QueryStats
    valid: Optional[np.ndarray] = None
    descending: bool = True

    @property
    def action(self) -> str:
        return self.stats.action

    def top(self, k: int = 10) -> np.ndarray:
        return _top_ids(self.scores, k, descending=self.descending,
                        valid=self.valid)


class VeilGraphSession:
    """A started engine plus the streaming conveniences around it; a
    context manager, so OnStop fires on exit.  The engine is at
    ``.engine``."""

    def __init__(self, engine: VeilGraphEngine,
                 stream: Optional[EdgeStream] = None):
        self.engine = engine
        self.stream = stream

    @property
    def algorithm(self) -> StreamingAlgorithm:
        """The :class:`StreamingAlgorithm` instance the engine runs."""
        return self.engine.algorithm

    @property
    def scores(self) -> np.ndarray:
        """Current score vector, copied to the host."""
        return self.engine.ranks.cpu().numpy()

    @property
    def stats_log(self):
        """One :class:`QueryStats` per served query (index 0 = the initial
        exact compute)."""
        return self.engine.stats_log

    def _active(self) -> np.ndarray:
        return self.engine.state.node_active.cpu().numpy()

    def top(self, k: int = 10) -> np.ndarray:
        """Ids of the k best-ranked vertices under the current scores."""
        scores = self.scores
        return _top_ids(scores, k, descending=self.algorithm.rank_descending,
                        valid=_result_valid(scores, self._active()))

    def add_edges(self, src, dst) -> "VeilGraphSession":
        """Buffer edge additions; applied at the next :meth:`query`."""
        self.engine.register_add_edges(np.asarray(src), np.asarray(dst))
        return self

    def remove_edges(self, src, dst) -> "VeilGraphSession":
        """Buffer edge removals (resolved to live slots at apply time)."""
        self.engine.register_remove_edges(np.asarray(src), np.asarray(dst))
        return self

    def query(self, msg: Optional[Dict] = None) -> QueryResult:
        """Serve one query: apply buffered updates, let the OnQuery policy
        pick repeat / approximate / exact, run it and wrap the answer."""
        scores, stats = self.engine.query(msg)
        return QueryResult(
            scores=scores, stats=stats,
            valid=_result_valid(scores, self._active()),
            descending=self.algorithm.rank_descending)

    def play(self) -> Iterator[QueryResult]:
        """Replay the attached stream: one update chunk + one query each."""
        if self.stream is None:
            raise ValueError(
                "session was not built from an EdgeStream; feed updates "
                "with add_edges()/query() instead")
        for s, d in self.stream:
            self.add_edges(s, d)
            yield self.query()

    def close(self):
        """Fire the OnStop UDF (also on ``with``-block exit)."""
        self.engine.stop()

    def __enter__(self) -> "VeilGraphSession":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _resolve_source(graph_source: GraphSource):
    """-> (init_src, init_dst, stream_or_none, node_hint, edge_hint)."""
    if isinstance(graph_source, str):
        try:
            spec = DATASETS[graph_source]
        except KeyError:
            raise KeyError(
                f"unknown dataset {graph_source!r}; available: "
                f"{', '.join(sorted(DATASETS))}") from None
        src, dst = generate(spec)
        return src, dst, None, spec.nodes, src.shape[0]
    if isinstance(graph_source, EdgeStream):
        es = graph_source
        return (es.init_src, es.init_dst, es, es.total_nodes, es.total_edges)
    src, dst = graph_source
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    nodes = 0
    if src.size:
        # raw edge lists carry no node-count bound: leave headroom for ids
        # that later add_edges bring
        nodes = int((int(max(src.max(), dst.max())) + 1) * 1.1) + 16
    return src, dst, None, nodes, src.shape[0]


def session(
    graph_source: GraphSource,
    algorithm: Union[StreamingAlgorithm, str] = "pagerank",
    config: Optional[EngineConfig] = None,
    *,
    on_start: Optional[Callable] = None,
    before_updates: Optional[Callable] = None,
    on_query: Optional[Callable] = None,
    on_query_result: Optional[Callable] = None,
    on_stop: Optional[Callable] = None,
    **overrides,
) -> VeilGraphSession:
    """Build and start a :class:`VeilGraphSession`.

    ``algorithm`` is a registry name or an instance.  Keyword
    ``overrides`` matching :class:`EngineConfig` fields (``device``, the
    capacities, ``r``/``n``/``delta``, ...) override the auto-sized
    config; the rest go to the algorithm factory.  ``device=None`` (the
    default) runs on the card and raises when there is none.

    ``quality_target=`` (e.g. ``0.95``) closes the accuracy loop
    (:mod:`repro_torch.core.control`): the approximate step measures drift
    on the device and a controller steers the effective ``r``/``delta``
    and the exact refreshes to keep the estimated error within ``1 -
    quality_target``.  A knob passed with it (``quality_target=0.95,
    r=0.1``) is pinned at that value; the controller moves only the others.
    ``async_rebuild=True`` serves each query from the last built epoch
    while the next epoch's apply and layout sorts run behind it
    (:mod:`repro_torch.core.epoch`); updates become visible one query
    later.  ``autotune="cached"``/``"full"`` tunes each layout's
    merge-path tile (:mod:`repro_torch.kernels.spmv.autotune`) and
    ``weight_dtype="bfloat16"``/``"float16"`` stores the f32 semirings'
    edge weights narrow (the kernels accumulate in f32).

    ``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh`` on the
    session's device type; the edge shards run over its dims named by
    ``mesh_axes=``, every dim by default, flattened into one) runs
    the engine sharded: every full-graph layout is cut into
    ``num_shards=`` edge shards (default one a rank; a multiple of the
    mesh's size loops the surplus on each rank, so one card runs S-way
    partitioning on a 1-rank mesh), every sweep pushes per shard and the
    partials meet in the semiring's all-reduce, and summaries are built by
    a bucket exchange across the shards (``shard_hot_edge_capacity=``
    caps its per-bucket slots).  ``rebalance_threshold=`` (default 1.0;
    ``None`` keeps the contiguous cut) recuts the partition when
    streaming skews the shards' live edges: ``engine.rebalances``,
    ``QueryStats.rebalanced``.  Every rank of the mesh runs the same
    session on the same stream.
    """
    init_src, init_dst, stream, node_hint, edge_hint = _resolve_source(
        graph_source)
    cfg_over = {k: v for k, v in overrides.items() if k in CONFIG_FIELDS}
    algo_params = {k: v for k, v in overrides.items()
                   if k not in CONFIG_FIELDS}
    if cfg_over.get("quality_target") is not None:
        # knob precedence: an r or delta passed here is pinned, unless the
        # caller set the control_* flag itself
        cfg_over.setdefault("control_r", "r" not in cfg_over)
        cfg_over.setdefault("control_delta", "delta" not in cfg_over)
    # beta/num_iters/tol configure the algorithm itself once one is named
    legacy = [k for k in ("beta", "num_iters", "tol") if k in cfg_over]
    if isinstance(algorithm, StreamingAlgorithm):
        if legacy:
            raise ValueError(
                f"{sorted(legacy)} cannot be applied to an already-"
                f"constructed algorithm — pass them to "
                f"{type(algorithm).__name__}(...) instead")
    elif legacy:
        factory = algorithm_factory(algorithm)
        rejected = [k for k in legacy if not factory_accepts(factory, k)]
        if rejected:
            raise ValueError(
                f"algorithm {algorithm!r} does not accept {sorted(rejected)}")
        for k in legacy:
            algo_params[k] = cfg_over.pop(k)
    algo = make_algorithm(algorithm, **algo_params)

    if config is None:
        node_cap = cfg_over.pop("node_capacity", max(node_hint, 2))
        edge_cap = cfg_over.pop("edge_capacity", int(edge_hint * 1.15) + 1024)
        config = EngineConfig(
            node_capacity=node_cap,
            edge_capacity=edge_cap,
            hot_node_capacity=cfg_over.pop("hot_node_capacity", node_cap),
            hot_edge_capacity=cfg_over.pop("hot_edge_capacity", edge_cap),
            **cfg_over,
        )
    elif cfg_over:
        raise ValueError(
            f"pass either an explicit config or field overrides, not both: "
            f"{sorted(cfg_over)}")

    udfs = {k: v for k, v in (("on_start", on_start),
                              ("before_updates", before_updates),
                              ("on_query", on_query),
                              ("on_query_result", on_query_result),
                              ("on_stop", on_stop)) if v is not None}
    engine = VeilGraphEngine(config, algo, **udfs)
    engine.start(init_src, init_dst)
    return VeilGraphSession(engine, stream)


def serve_session(
    graph_source: GraphSource,
    config: Optional[EngineConfig] = None,
    *,
    slots: int = 4,
    algorithm: Union[StreamingAlgorithm, str] = "pagerank",
    **overrides,
):
    """Build a started session and wrap it for multi-tenant serving: one
    shared graph and engine behind a
    :class:`~repro_torch.serve.graph.GraphServingEngine` with ``slots``
    batch slots per algorithm lane::

        srv = repro_torch.serve_session((src, dst), slots=4)
        t1 = srv.submit("personalized-pagerank", seeds=(3,))
        t2 = srv.submit("sssp", sources=(17,))
        srv.run()
        t1.result, srv.stats.queries_per_s

    ``algorithm``/``config``/``overrides`` configure the engine as in
    :func:`session` (``device``, capacities, hot-set knobs,
    ``quality_target`` with the same knob precedence, ``async_rebuild``,
    ``autotune`` and ``weight_dtype``, the lanes' tiles tuned for
    ``slots`` batch rows, and the mesh knobs, under which every batched
    push of a wave runs per shard);
    ``algorithm`` only sets the workload of the initial exact compute, since
    each served query carries its own.  Under ``quality_target`` each lane
    runs its own controller; under ``async_rebuild`` every wave serves one
    epoch and updates buffered before a wave become visible one wave
    later.  ``device=None`` runs on the card and raises
    when there is none.  The session stays reachable at ``.session`` and
    is closed by the serving engine's ``with``-exit.
    """
    from repro_torch.serve.graph import GraphServingEngine

    base = session(graph_source, algorithm, config, **overrides)
    srv = GraphServingEngine(base.engine, slots=slots)
    srv.session = base
    return srv


__all__ = [
    "Action",
    "QueryResult",
    "VeilGraphSession",
    "available_algorithms",
    "serve_session",
    "session",
]
