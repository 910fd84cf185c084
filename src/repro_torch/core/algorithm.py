"""The pluggable algorithm layer: ``StreamingAlgorithm`` + registry (PyTorch
port of ``repro.core.algorithm``).

The engine owns stream ingestion, update buffering, hot-set selection and
the action policy; everything rank-specific lives behind
:class:`StreamingAlgorithm`:

    init_state(graph)                        -> state dict of tensors
    exact(state, graph)                      -> (state', iterations)
    build_summaries(state, graph, hot, caps) -> (SummaryBuffers, ...)
    summarized(state, graph, summaries)      -> (state', iterations)
    result_view(state)                       -> the query answer
    selection_view(state)                    -> f32 signal for the Δ bound

Only PageRank, the paper's case study, is ported so far; the other
registered names of the JAX package raise until their slice lands.
"""

from __future__ import annotations

import abc
import enum
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.pagerank import SummaryBuffers
from repro_torch.core.pagerank import build_summary as _build_summary
from repro_torch.core.pagerank import pagerank as _pagerank
from repro_torch.core.pagerank import summarized_pagerank as _summarized_pagerank
from repro_torch.graph.graph import GraphState

#: Algorithm state is a flat dict of tensors.
AlgoState = Dict[str, torch.Tensor]


class Action(enum.Enum):
    """The paper's three OnQuery action indicators (Alg. 1 lines 9-19)."""

    REPEAT_LAST = "repeat-last-answer"
    APPROXIMATE = "compute-approximate"
    EXACT = "compute-exact"


class StreamingAlgorithm(abc.ABC):
    """Interface every engine-pluggable algorithm implements.

    Subclasses are frozen dataclasses: numeric knobs are fields, per-vertex
    state lives in the dict :meth:`init_state` returns.
    """

    #: registry key; subclasses override.
    name: str = "abstract"
    #: False runs select / summarize / iterate as separate engine steps.
    supports_fused: bool = True
    #: True rescales selection_view to mean 1 over active vertices inside
    #: the Δ bound (Eqs. 4-5 are calibrated against PageRank-scale scores).
    normalize_selection_scores: bool = False
    #: the (⊕, ⊗) algebra the sweeps run over.
    semiring: str = "plus_times"
    #: True: bigger result values rank first.
    rank_descending: bool = True
    #: weight mode of the default :meth:`build_summaries`.
    summary_weight: str = "inv_out"
    #: declared per-key dtypes of the :meth:`init_state` dict, checked once
    #: by the engine.
    state_dtypes: Dict[str, str] = {}
    #: full-graph edge layouts the sweeps consume, as (weight, reverse,
    #: semiring) triples; the engine caches one layout per entry.
    layout_specs: Tuple[Tuple, ...] = (("inv_out", False, "plus_times"),)

    @abc.abstractmethod
    def init_state(self, graph: GraphState) -> AlgoState:
        """Fresh per-vertex state sized to ``graph.node_capacity``, on the
        graph's device."""

    @abc.abstractmethod
    def exact(self, state: AlgoState, graph: GraphState, *,
              layouts=None) -> Tuple[AlgoState, int]:
        """Full recomputation over the live graph (the exact reference).
        ``layouts`` is the cached tuple matching :attr:`layout_specs`."""

    def build_summaries(
        self,
        state: AlgoState,
        graph: GraphState,
        hot_mask: torch.Tensor,
        *,
        hot_node_capacity: int,
        hot_edge_capacity: int,
        layouts=None,
    ) -> Tuple[SummaryBuffers, ...]:
        """The paper's single forward big-vertex summary over the declared
        :attr:`semiring` and :attr:`summary_weight`, frozen from
        :meth:`result_view`."""
        return (
            _build_summary(
                graph, self.result_view(state), hot_mask,
                hot_node_capacity=hot_node_capacity,
                hot_edge_capacity=hot_edge_capacity,
                weight=self.summary_weight, semiring=self.semiring,
                layout=layouts[0] if layouts else None),
        )

    @abc.abstractmethod
    def summarized(self, state: AlgoState, graph: GraphState,
                   summaries: Tuple[SummaryBuffers, ...]
                   ) -> Tuple[AlgoState, int]:
        """Approximate update restricted to the hot set (§3.1)."""

    @abc.abstractmethod
    def result_view(self, state: AlgoState) -> torch.Tensor:
        """The query answer, one entry per vertex."""

    def selection_view(self, state: AlgoState) -> torch.Tensor:
        """f32 volatility signal for the hot-set Δ bound (Eqs. 4-5);
        ranking algorithms use their scores."""
        return self.result_view(state).to(torch.float32)


def summaries_overflow(summaries: Tuple[SummaryBuffers, ...]) -> torch.Tensor:
    """True if any summary exceeded its capacities (caller must fall back)."""
    flag = summaries[0].overflow
    for s in summaries[1:]:
        flag = flag | s.overflow
    return flag


@dataclass(frozen=True)
class PageRankAlgorithm(StreamingAlgorithm):
    """Gelly-style PageRank (§2) on the five-UDF engine.

    ``warm_start=False`` keeps the paper protocol: every EXACT action
    recomputes from the uniform start.  True seeds the power iteration from
    the previous ranks.
    """

    beta: float = 0.85
    num_iters: int = 30
    tol: float = 0.0
    teleport_by_n: bool = False
    dangling: bool = False
    warm_start: bool = False

    name = "pagerank"
    state_dtypes = {"ranks": "float32"}

    def init_state(self, graph: GraphState) -> AlgoState:
        active = graph.node_active
        if self.teleport_by_n:
            init = 1.0 / graph.num_active_nodes().to(torch.float32).clamp(
                min=1.0)
            return {"ranks": torch.where(active, init, 0.0)}
        return {"ranks": active.to(torch.float32)}

    def exact(self, state, graph, *, layouts=None):
        ranks, iters = _pagerank(
            graph, state["ranks"] if self.warm_start else None,
            beta=self.beta, num_iters=self.num_iters, tol=self.tol,
            teleport_by_n=self.teleport_by_n, dangling=self.dangling,
            layout=layouts[0] if layouts else None)
        return {"ranks": ranks}, iters

    def summarized(self, state, graph, summaries):
        (summary,) = summaries
        ranks, iters = _summarized_pagerank(
            summary, state["ranks"], beta=self.beta,
            num_iters=self.num_iters, tol=self.tol)
        return {"ranks": ranks}, iters

    def result_view(self, state):
        return state["ranks"]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., StreamingAlgorithm]] = {}
_ALIASES: Dict[str, str] = {}
#: names (and aliases) the JAX package registers whose port has not landed
_NOT_PORTED = frozenset((
    "personalized-pagerank", "ppr", "hits", "katz", "connected-components",
    "cc", "wcc", "sssp", "shortest-paths", "widest-path",
    "most-reliable-path"))


def register_algorithm(name: str, factory: Callable[..., StreamingAlgorithm],
                       *, aliases: Tuple[str, ...] = ()) -> None:
    """Register an algorithm factory under ``name`` (latest wins)."""
    _REGISTRY[name] = factory
    for alias in aliases:
        _ALIASES[alias] = name


def available_algorithms() -> Tuple[str, ...]:
    """Canonical registered names (aliases resolve but are not listed)."""
    return tuple(sorted(_REGISTRY))


def algorithm_factory(name: str) -> Callable[..., StreamingAlgorithm]:
    """The registered factory for a name or alias, without instantiating."""
    key = _ALIASES.get(name, name)
    if key in _REGISTRY:
        return _REGISTRY[key]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not yet ported to PyTorch (ROADMAP "
            f"queue 1 entry 10)")
    raise KeyError(f"unknown algorithm {name!r}; registered: "
                   f"{', '.join(available_algorithms())}")


def factory_accepts(factory: Callable, knob: str) -> bool:
    """True if ``factory``'s signature takes ``knob``, directly or via
    ``**kwargs``."""
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False
    return knob in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def make_algorithm(spec, **params) -> StreamingAlgorithm:
    """An instance (returned as is; ``params`` must be empty) or a registry
    name with factory kwargs, as a :class:`StreamingAlgorithm`."""
    if isinstance(spec, StreamingAlgorithm):
        if params:
            raise ValueError(
                "algorithm instance given — pass parameters to its "
                "constructor instead")
        return spec
    return algorithm_factory(spec)(**params)


register_algorithm("pagerank", PageRankAlgorithm)
