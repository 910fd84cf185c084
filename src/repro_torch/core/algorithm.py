"""The pluggable algorithm layer: ``StreamingAlgorithm`` + registry (PyTorch
port of ``repro.core.algorithm``).

The engine owns stream ingestion, update buffering, hot-set selection and
the action policy; everything rank-specific lives behind
:class:`StreamingAlgorithm`:

    init_state(graph)                        -> state dict of tensors
    exact(state, graph)                      -> (state', iterations)
    build_summaries(state, graph, hot, caps) -> (SummaryBuffers, ...)
    summarized(state, graph, summaries)      -> (state', iterations)
    summarized_batched(bank, graph, summaries, row_mask)
                                             -> (bank', iterations, row_delta)
    result_view(state)                       -> the query answer
    selection_view(state)                    -> f32 signal for the Δ bound

All seven algorithms of the JAX package's registry are ported: PageRank
(the paper's case study), personalized PageRank, HITS, Katz, connected
components, SSSP and widest path.  ``summarized_batched`` is the serving
engine's sweep over a bank of B queries (``[B, ...]`` state leaves), and
``drift_residual`` the quality controller's signal (``core/control.py``).
"""

from __future__ import annotations

import abc
import enum
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import backend as B
from repro_torch.core.hits import hits as _hits
from repro_torch.core.hits import summarized_hits as _summarized_hits
from repro_torch.core.hits import \
    summarized_hits_batched as _summarized_hits_batched
from repro_torch.core.katz import katz as _katz
from repro_torch.core.katz import summarized_katz as _summarized_katz
from repro_torch.core.katz import \
    summarized_katz_batched as _summarized_katz_batched
from repro_torch.core.pagerank import SummaryBuffers
from repro_torch.core.pagerank import build_summary as _build_summary
from repro_torch.core.pagerank import pagerank as _pagerank
from repro_torch.core.pagerank import summarized_pagerank as _summarized_pagerank
from repro_torch.core.pagerank import \
    summarized_pagerank_batched as _summarized_pagerank_batched
from repro_torch.core.traversal import LABEL_SENTINEL
from repro_torch.core.traversal import connected_components as _cc
from repro_torch.core.traversal import sssp as _sssp
from repro_torch.core.traversal import \
    summarized_connected_components as _summarized_cc
from repro_torch.core.traversal import \
    summarized_connected_components_batched as _summarized_cc_batched
from repro_torch.core.traversal import summarized_sssp as _summarized_sssp
from repro_torch.core.traversal import \
    summarized_sssp_batched as _summarized_sssp_batched
from repro_torch.core.traversal import \
    summarized_widest_path as _summarized_widest_path
from repro_torch.core.traversal import \
    summarized_widest_path_batched as _summarized_widest_path_batched
from repro_torch.core.traversal import widest_path as _widest_path
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
    #: constructor knobs whose whole effect is :meth:`init_state` (seed and
    #: source sets): the serving engine batches requests that differ only
    #: in these into one lane, whose bank rows carry them.
    per_query_params: Tuple[str, ...] = ()
    #: how the drift estimate normalizes (:func:`repro_torch.core.control.
    #: drift_signals`): ``"mass"`` by the total |result| (scores,
    #: distances), ``"count"`` by the active vertices (0/1 residuals such
    #: as connected components' label flips).
    drift_normalize: str = "mass"
    #: the contraction c of the exact update, from which the controller
    #: takes its drift→error gain 1/(1 − c); None keeps the conservative
    #: gain 3 (damped ranking algebras).  The min/max relaxations settle in
    #: finitely many sweeps and declare 0.0.
    drift_contraction: Optional[float] = None
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
        shard_bucket_capacity: Optional[int] = None,
    ) -> Tuple[SummaryBuffers, ...]:
        """The paper's single forward big-vertex summary over the declared
        :attr:`semiring` and :attr:`summary_weight`, frozen from
        :meth:`result_view`.  ``shard_bucket_capacity`` tightens the
        sharded construction's per-(shard, bucket) slots (see
        :func:`repro_torch.core.pagerank.build_summary`); the engine passes
        it only when set, so an override without the keyword still
        works."""
        return (
            _build_summary(
                graph, self.result_view(state), hot_mask,
                hot_node_capacity=hot_node_capacity,
                hot_edge_capacity=hot_edge_capacity,
                weight=self.summary_weight, semiring=self.semiring,
                layout=layouts[0] if layouts else None,
                shard_bucket_capacity=shard_bucket_capacity),
        )

    @abc.abstractmethod
    def summarized(self, state: AlgoState, graph: GraphState,
                   summaries: Tuple[SummaryBuffers, ...]
                   ) -> Tuple[AlgoState, int]:
        """Approximate update restricted to the hot set (§3.1)."""

    def summarized_batched(
        self,
        batch_state: AlgoState,
        graph: GraphState,
        summaries: Tuple[SummaryBuffers, ...],
        *,
        row_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[AlgoState, int, torch.Tensor]:
        """The summarized sweep of B concurrent queries (serving).

        ``batch_state`` is the :meth:`init_state` dict with a leading batch
        axis on every leaf (see :meth:`validate_batch_state`); the
        summaries share one E_K structure, with ``b_in`` ``[K_cap]`` or
        per query ``[B, K_cap]``.  ``row_mask`` (bool[B], True = live)
        freezes converged or vacant slots: their rows carry over and
        report zero delta.  Returns ``(batch_state', iterations, row_delta
        f32[B])``, ``row_delta`` being each row's convergence signal of the
        last iteration (L1 change for the ranking family, changed entries
        for the min/max relaxations).  Every shipped algorithm implements
        it; the serving engine refuses one that does not.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not implement summarized_batched; "
            "multi-tenant serving needs the batched [B, N] sweep")

    def validate_batch_state(self, batch_state: AlgoState,
                             batch: int) -> None:
        """Check a serving slot bank against :attr:`state_dtypes`: every
        declared key present, in its dtype, with a leading axis of exactly
        ``batch`` rows.  An empty declaration checks nothing."""
        if not self.state_dtypes:
            return
        missing = sorted(set(self.state_dtypes) - set(batch_state))
        if missing:
            raise ValueError(f"{self.name}: batch state is missing declared "
                             f"keys {missing}")
        for key, want in self.state_dtypes.items():
            t = batch_state[key]
            if t.dtype != getattr(torch, want):
                raise ValueError(f"{self.name}: batch state[{key!r}] has "
                                 f"dtype {t.dtype}, declared {want}")
            if t.dim() < 2 or t.shape[0] != batch:
                raise ValueError(
                    f"{self.name}: batch state[{key!r}] must have a leading "
                    f"batch axis of {batch} rows; got shape "
                    f"{tuple(t.shape)}")

    def drift_residual(self, state: AlgoState, graph: GraphState, *,
                       layouts=None) -> Optional[torch.Tensor]:
        """f32[N] fixed-point residual ``|F(x) − x|`` of ``state`` for one
        application F of the exact update over the full graph, the
        controller's drift signal: zero at the fixed point, concentrated
        where a summarized sweep froze vertices or the stream changed their
        inputs.  One full-layout push per query (``layouts`` is the cached
        tuple of :attr:`layout_specs`), no host read; ``[B, N]`` state
        leaves give ``[B, N]``.  None (this default) makes the fused step
        use the churn of :meth:`result_view` instead."""
        return None

    def batched_cold_seeds(
            self, batch_state: AlgoState) -> Optional[torch.Tensor]:
        """bool[B, N] seed masks for the cold-start coverage of freshly
        seated slots, or None.  Algorithms whose answer is non-trivial only
        where a per-query seed reaches (PPR's teleport support, the path
        sources) return them, and the batched step covers their forward
        reachability; None (global algorithms) covers every active
        vertex."""
        return None

    def batched_selection_scores(
            self, batch_state: AlgoState,
            row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f32[N] hot-set signal of a ``[B, ...]`` bank: the element-wise
        maximum of the live rows' :meth:`selection_view`, so a vertex
        volatile for any live query is hot for the wave; all zero when no
        row is live.  ``selection_view`` must take ``[B, ...]`` leaves, as
        every shipped one does."""
        scores = self.selection_view(batch_state).to(torch.float32)
        if row_mask is not None:
            scores = torch.where(row_mask[:, None], scores, float("-inf"))
        agg = scores.max(dim=0).values
        return torch.where(torch.isfinite(agg), agg, 0.0)

    def __init_subclass__(cls, **kwargs):
        """Legacy-plugin dispatch, resolved once at class creation.

        A pre-semiring plugin overrides ``score_view``; the engine reads
        ``result_view``.  Whenever a class (re-)defines ``score_view``
        below the most-derived ``result_view`` in its MRO (a fresh
        old-style plugin, or a subclass of a shipped algorithm that
        customizes only ``score_view``), ``result_view`` is rerouted
        through that override.  The position is the MRO's, not
        ``issubclass``: a mixin's ``score_view`` that precedes the
        algorithm base counts.  Classes defining both at one level are left
        alone.  Rerouted methods are tagged so that the base ``score_view``
        alias skips them when a legacy override chains up through
        ``super().score_view(...)`` (no mutual recursion).  The reroute
        happens before ``__abstractmethods__`` is computed, so a plugin that
        defines only ``score_view`` can be built, and one that defines
        neither view still fails at construction.
        """
        super().__init_subclass__(**kwargs)

        def defining(name):
            for klass in cls.__mro__:
                if name in vars(klass):
                    return klass
            return None

        sv, rv = defining("score_view"), defining("result_view")
        if (sv not in (None, StreamingAlgorithm) and rv is not None
                and sv is not rv
                and cls.__mro__.index(sv) < cls.__mro__.index(rv)):
            orig = vars(sv)["score_view"]

            def _rerouted(self, state, _orig=orig):
                return _orig(self, state)

            _rerouted._legacy_reroute = True
            _rerouted.__doc__ = (f"result_view rerouted through the legacy "
                                 f"{sv.__name__}.score_view override.")
            cls.result_view = _rerouted

    @abc.abstractmethod
    def result_view(self, state: AlgoState) -> torch.Tensor:
        """The query answer, one entry per vertex.  Subclasses override it
        (or, legacy plugins, ``score_view``: see :meth:`__init_subclass__`).
        """

    def selection_view(self, state: AlgoState) -> torch.Tensor:
        """f32 volatility signal for the hot-set Δ bound (Eqs. 4-5);
        ranking algorithms use their scores."""
        return self.result_view(state).to(torch.float32)

    def score_view(self, state: AlgoState) -> torch.Tensor:
        """Deprecated pre-semiring alias of :meth:`result_view`.

        Resolves to the first result_view in the MRO that is not a reroute,
        so a legacy override calling ``super().score_view(...)`` gets its
        parent's answer, not itself back.
        """
        for klass in type(self).__mro__:
            rv = vars(klass).get("result_view")
            if rv is not None and not getattr(rv, "_legacy_reroute", False):
                return rv(self, state)
        raise NotImplementedError(
            f"{type(self).__name__} implements neither result_view nor the "
            "legacy score_view")


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

    def summarized_batched(self, batch_state, graph, summaries, *,
                           row_mask=None):
        (summary,) = summaries
        ranks, iters, row_delta = _summarized_pagerank_batched(
            summary, batch_state["ranks"], beta=self.beta,
            num_iters=self.num_iters, tol=self.tol, row_mask=row_mask)
        return {"ranks": ranks}, iters, row_delta

    def drift_residual(self, state, graph, *, layouts=None):
        # |(1-β)·t + β·push(r) − r|, zero at pagerank()'s fixed point; the
        # dangling redistribution is left out, as in the JAX package
        if layouts is None:
            return None
        r = state["ranks"]
        incoming = B.push(r, layouts[0])
        tele = 1.0 - self.beta
        if self.teleport_by_n:
            tele = tele / graph.num_active_nodes().to(torch.float32).clamp(
                min=1.0)
        new_r = torch.where(graph.node_active, tele + self.beta * incoming,
                            0.0)
        return (new_r - r).abs()

    def result_view(self, state):
        return state["ranks"]


@dataclass(frozen=True)
class PersonalizedPageRankAlgorithm(StreamingAlgorithm):
    """PageRank with the teleport mass on a seed set: ``seeds`` is a tuple
    of vertex ids and the teleport vector, uniform over them, lives in the
    state (it is data, not a knob), so one serving lane holds B seed sets.
    ``warm_start=False`` keeps the protocol's cold exact recompute."""

    seeds: Tuple[int, ...] = (0,)
    beta: float = 0.85
    num_iters: int = 30
    tol: float = 0.0
    warm_start: bool = False

    name = "personalized-pagerank"
    normalize_selection_scores = True
    state_dtypes = {"ranks": "float32", "teleport": "float32"}
    per_query_params = ("seeds",)

    def __post_init__(self):
        if not self.seeds:
            raise ValueError("personalized-pagerank needs >= 1 seed vertex")

    def init_state(self, graph: GraphState) -> AlgoState:
        n = graph.node_capacity
        if min(self.seeds) < 0:
            raise ValueError(f"seed {min(self.seeds)} is negative")
        if max(self.seeds) >= n:
            raise ValueError(f"seed {max(self.seeds)} >= node_capacity {n}")
        seeds = torch.tensor(self.seeds, dtype=torch.long,
                             device=graph.device)
        t = torch.zeros(n, dtype=torch.float32, device=graph.device)
        t.index_add_(0, seeds, torch.full(seeds.shape, 1.0 / len(self.seeds),
                                          device=graph.device))
        return {"ranks": t, "teleport": t.clone()}

    def exact(self, state, graph, *, layouts=None):
        ranks, iters = _pagerank(
            graph, state["ranks"] if self.warm_start else None,
            beta=self.beta, num_iters=self.num_iters, tol=self.tol,
            teleport_v=state["teleport"],
            layout=layouts[0] if layouts else None)
        return {"ranks": ranks, "teleport": state["teleport"]}, iters

    def summarized(self, state, graph, summaries):
        (summary,) = summaries
        ranks, iters = _summarized_pagerank(
            summary, state["ranks"], beta=self.beta,
            num_iters=self.num_iters, tol=self.tol,
            teleport_v=state["teleport"])
        return {"ranks": ranks, "teleport": state["teleport"]}, iters

    def summarized_batched(self, batch_state, graph, summaries, *,
                           row_mask=None):
        (summary,) = summaries
        ranks, iters, row_delta = _summarized_pagerank_batched(
            summary, batch_state["ranks"], beta=self.beta,
            num_iters=self.num_iters, tol=self.tol,
            teleport_v=batch_state["teleport"], row_mask=row_mask)
        return ({"ranks": ranks, "teleport": batch_state["teleport"]}, iters,
                row_delta)

    def drift_residual(self, state, graph, *, layouts=None):
        # |(1-β)·t(v) + β·push(r) − r| for the personalized teleport
        if layouts is None:
            return None
        r = state["ranks"]
        incoming = B.push(r, layouts[0])
        new_r = torch.where(graph.node_active,
                            (1.0 - self.beta) * state["teleport"]
                            + self.beta * incoming, 0.0)
        return (new_r - r).abs()

    def batched_cold_seeds(self, batch_state):
        # ranks are nonzero only where the teleport support reaches
        return batch_state["teleport"] > 0.0

    def result_view(self, state):
        return state["ranks"]


@dataclass(frozen=True)
class HITSAlgorithm(StreamingAlgorithm):
    """Kleinberg's HITS with L1 normalization each half-iteration.  The
    state holds both vectors and the tracked σ (f32[2], one per
    direction); :meth:`result_view` is the authorities (``rank_by="hub"``
    for the hubs).  The summarized sweep freezes the cold contributions in
    both directions, so it needs a forward and a reverse summary.  EXACT
    actions warm-start: HITS converges from any positive start."""

    num_iters: int = 30
    tol: float = 0.0
    rank_by: str = "auth"

    name = "hits"
    normalize_selection_scores = True
    summary_weight = "unit"
    state_dtypes = {"auth": "float32", "hub": "float32", "sigma": "float32"}
    layout_specs = (("unit", False, "plus_times"),
                    ("unit", True, "plus_times"))

    def __post_init__(self):
        if self.rank_by not in ("auth", "hub"):
            raise ValueError(
                f"rank_by must be 'auth' or 'hub', got {self.rank_by!r}")

    def init_state(self, graph: GraphState) -> AlgoState:
        n = graph.num_active_nodes().to(torch.float32).clamp(min=1.0)
        uniform = torch.where(graph.node_active, 1.0 / n, 0.0)
        return {"auth": uniform, "hub": uniform.clone(),
                "sigma": torch.ones(2, dtype=torch.float32,
                                    device=graph.device)}

    def exact(self, state, graph, *, layouts=None):
        auth, hub, iters, sigma = _hits(
            graph, state["auth"], state["hub"], num_iters=self.num_iters,
            tol=self.tol, fwd_layout=layouts[0] if layouts else None,
            rev_layout=layouts[1] if layouts else None)
        return {"auth": auth, "hub": hub, "sigma": sigma}, iters

    def build_summaries(self, state, graph, hot_mask, *, hot_node_capacity,
                        hot_edge_capacity, layouts=None,
                        shard_bucket_capacity=None):
        """A forward unit summary frozen from the hubs and a reverse one
        frozen from the authorities, over one hot mask."""
        common = dict(hot_node_capacity=hot_node_capacity,
                      hot_edge_capacity=hot_edge_capacity, weight="unit",
                      shard_bucket_capacity=shard_bucket_capacity)
        fwd = _build_summary(graph, state["hub"], hot_mask,
                             layout=layouts[0] if layouts else None, **common)
        rev = _build_summary(graph, state["auth"], hot_mask, reverse=True,
                             layout=layouts[1] if layouts else None, **common)
        return (fwd, rev)

    def summarized(self, state, graph, summaries):
        fwd, rev = summaries
        auth, hub, iters, sigma = _summarized_hits(
            fwd, rev, state["auth"], state["hub"], state["sigma"],
            num_iters=self.num_iters, tol=self.tol)
        return {"auth": auth, "hub": hub, "sigma": sigma}, iters

    def summarized_batched(self, batch_state, graph, summaries, *,
                           row_mask=None):
        fwd, rev = summaries
        auth, hub, iters, row_delta, sigma = _summarized_hits_batched(
            fwd, rev, batch_state["auth"], batch_state["hub"],
            batch_state["sigma"], num_iters=self.num_iters, tol=self.tol,
            row_mask=row_mask)
        return {"auth": auth, "hub": hub, "sigma": sigma}, iters, row_delta

    def result_view(self, state):
        return state["auth"] if self.rank_by == "auth" else state["hub"]


@dataclass(frozen=True)
class KatzAlgorithm(StreamingAlgorithm):
    """Katz centrality ``c = Σ_k α^k (Aᵀ)^k β·1``.  The sweep contracts
    only while ``α < 1/σ_max(A)``: keep ``alpha`` small on hub-heavy
    graphs.  EXACT actions warm-start by default (same fixed point, fewer
    iterations)."""

    alpha: float = 0.05
    beta: float = 1.0
    num_iters: int = 30
    tol: float = 0.0
    warm_start: bool = True

    name = "katz"
    normalize_selection_scores = True
    summary_weight = "unit"
    state_dtypes = {"katz": "float32"}
    layout_specs = (("unit", False, "plus_times"),)

    def __post_init__(self):
        if not 0.0 < self.alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")

    def init_state(self, graph: GraphState) -> AlgoState:
        return {"katz": torch.where(graph.node_active, self.beta, 0.0).to(
            torch.float32)}

    def exact(self, state, graph, *, layouts=None):
        c, iters = _katz(
            graph, state["katz"] if self.warm_start else None,
            alpha=self.alpha, beta=self.beta, num_iters=self.num_iters,
            tol=self.tol, layout=layouts[0] if layouts else None)
        return {"katz": c}, iters

    def summarized(self, state, graph, summaries):
        (summary,) = summaries
        c, iters = _summarized_katz(
            summary, state["katz"], alpha=self.alpha, beta=self.beta,
            num_iters=self.num_iters, tol=self.tol)
        return {"katz": c}, iters

    def summarized_batched(self, batch_state, graph, summaries, *,
                           row_mask=None):
        (summary,) = summaries
        c, iters, row_delta = _summarized_katz_batched(
            summary, batch_state["katz"], alpha=self.alpha, beta=self.beta,
            num_iters=self.num_iters, tol=self.tol, row_mask=row_mask)
        return {"katz": c}, iters, row_delta

    def drift_residual(self, state, graph, *, layouts=None):
        # |β + α·push(c) − c|, zero at katz()'s fixed point
        if layouts is None:
            return None
        c = state["katz"]
        incoming = B.push(c, layouts[0])
        new_c = torch.where(graph.node_active,
                            self.beta + self.alpha * incoming, 0.0)
        return (new_c - c).abs()

    def result_view(self, state):
        return state["katz"]


# ---------------------------------------------------------------------------
# Traversal workloads: min/max semirings
# ---------------------------------------------------------------------------


def _finite_churn(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """f32 per-vertex change indicator robust to ±∞/sentinel state:
    |new − old| where both are finite, 1.0 where exactly one is, 0 else."""
    new_f = new.to(torch.float32)
    old_f = old.to(torch.float32)
    both = torch.isfinite(new_f) & torch.isfinite(old_f)
    return torch.where(both, (new_f - old_f).abs(),
                       (new_f != old_f).to(torch.float32))


def _source_mask(sources: Tuple[int, ...], n_cap: int,
                 device) -> torch.Tensor:
    """bool[n_cap] with the source vertices set, checked on the host."""
    if min(sources) < 0:
        raise ValueError(f"source {min(sources)} is negative")
    if max(sources) >= n_cap:
        raise ValueError(f"source {max(sources)} >= node_capacity {n_cap}")
    mask = torch.zeros(n_cap, dtype=torch.bool, device=device)
    mask[torch.tensor(sources, dtype=torch.long, device=device)] = True
    return mask


@dataclass(frozen=True)
class ConnectedComponentsAlgorithm(StreamingAlgorithm):
    """Weakly connected components by min-label propagation over int32
    labels (``min_min``, both edge orientations).

    Every active vertex converges to the least id of its component;
    inactive ones hold the int32-max sentinel.  :meth:`selection_view` is
    the label churn of the last sweep, so the hot set grows around merged
    regions.  EXACT actions recompute from scratch unless ``warm_start``.
    """

    num_iters: int = 30
    warm_start: bool = False

    name = "connected-components"
    normalize_selection_scores = True
    rank_descending = False  # smaller labels first (component min ids)
    semiring = "min_min"
    summary_weight = "unit"
    drift_normalize = "count"  # residual = label flips, not id magnitudes
    drift_contraction = 0.0  # label relaxation has no geometric tail
    state_dtypes = {"labels": "int32", "churn": "float32"}
    layout_specs = (("unit", False, "min_min"), ("unit", True, "min_min"))

    def init_state(self, graph: GraphState) -> AlgoState:
        ids = torch.arange(graph.node_capacity, dtype=torch.int32,
                           device=graph.device)
        return {"labels": torch.where(graph.node_active, ids, LABEL_SENTINEL),
                "churn": torch.zeros(graph.node_capacity,
                                     dtype=torch.float32,
                                     device=graph.device)}

    def _with_churn(self, labels, state) -> AlgoState:
        return {"labels": labels,
                "churn": (labels != state["labels"]).to(torch.float32)}

    def exact(self, state, graph, *, layouts=None):
        labels, iters = _cc(
            graph, state["labels"] if self.warm_start else None,
            num_iters=self.num_iters,
            fwd_layout=layouts[0] if layouts else None,
            rev_layout=layouts[1] if layouts else None)
        return self._with_churn(labels, state), iters

    def build_summaries(self, state, graph, hot_mask, *, hot_node_capacity,
                        hot_edge_capacity, layouts=None,
                        shard_bucket_capacity=None):
        """A forward and a reverse unit ``min_min`` summary of one hot
        mask, frozen from the labels."""
        common = dict(hot_node_capacity=hot_node_capacity,
                      hot_edge_capacity=hot_edge_capacity, weight="unit",
                      semiring="min_min",
                      shard_bucket_capacity=shard_bucket_capacity)
        fwd = _build_summary(graph, state["labels"], hot_mask,
                             layout=layouts[0] if layouts else None,
                             **common)
        rev = _build_summary(graph, state["labels"], hot_mask, reverse=True,
                             layout=layouts[1] if layouts else None,
                             **common)
        return (fwd, rev)

    def summarized(self, state, graph, summaries):
        fwd, rev = summaries
        labels, iters = _summarized_cc(fwd, rev, state["labels"],
                                       num_iters=self.num_iters)
        return self._with_churn(labels, state), iters

    def summarized_batched(self, batch_state, graph, summaries, *,
                           row_mask=None):
        fwd, rev = summaries
        labels, iters, changed = _summarized_cc_batched(
            fwd, rev, batch_state["labels"], num_iters=self.num_iters,
            row_mask=row_mask)
        return (self._with_churn(labels, batch_state), iters,
                changed.to(torch.float32))

    def drift_residual(self, state, graph, *, layouts=None):
        # 1.0 where one more min-label relaxation, both orientations, would
        # still change a vertex
        if layouts is None or len(layouts) < 2:
            return None
        lab = state["labels"]
        relaxed = torch.minimum(lab, torch.minimum(
            B.push(lab, layouts[0], semiring="min_min"),
            B.push(lab, layouts[1], semiring="min_min")))
        return (graph.node_active & (relaxed != lab)).to(torch.float32)

    def result_view(self, state):
        return state["labels"]

    def selection_view(self, state):
        return state["churn"]


@dataclass(frozen=True)
class _PathAlgorithm(StreamingAlgorithm):
    """The body SSSP and widest path share: a relaxation from pinned
    ``sources`` over a ``weight="length"`` layout, with state
    ``{<value key>, "source", "delta"}``.  Lengths are unit unless edges
    were streamed with a ``weights`` column.  :meth:`selection_view` is the
    value change of the last sweep.  EXACT actions recompute from the
    sources unless ``warm_start`` (exact for addition-only streams)."""

    sources: Tuple[int, ...] = (0,)
    num_iters: int = 30
    warm_start: bool = False

    normalize_selection_scores = True
    summary_weight = "length"
    drift_contraction = 0.0  # the relaxation settles, no geometric tail
    # subclasses set (class attributes, not fields): the state key, the
    # value of sources and of unreached vertices, the sweeps, and the
    # relaxation and residual of drift_residual
    per_query_params = ("sources",)
    value_key = ""
    pinned = 0.0
    unreached = 0.0
    exact_sweep = None
    summarized_sweep = None
    summarized_batched_sweep = None
    relax = None
    residual = None

    def __post_init__(self):
        if not self.sources:
            raise ValueError(f"{self.name} needs >= 1 source vertex")

    def init_state(self, graph: GraphState) -> AlgoState:
        n, dev = graph.node_capacity, graph.device
        source = _source_mask(self.sources, n, dev)
        value = torch.full((n,), self.unreached, dtype=torch.float32,
                           device=dev)
        return {self.value_key: value.masked_fill(source, self.pinned),
                "source": source,
                "delta": torch.zeros(n, dtype=torch.float32, device=dev)}

    def _after(self, value, state) -> AlgoState:
        return {self.value_key: value, "source": state["source"],
                "delta": _finite_churn(value, state[self.value_key])}

    def exact(self, state, graph, *, layouts=None):
        value, iters = self.exact_sweep(
            graph, state["source"],
            state[self.value_key] if self.warm_start else None,
            num_iters=self.num_iters,
            layout=layouts[0] if layouts else None)
        return self._after(value, state), iters

    # build_summaries: the inherited default, one forward summary frozen
    # from result_view over summary_weight/semiring

    def summarized(self, state, graph, summaries):
        (summary,) = summaries
        value, iters = self.summarized_sweep(
            summary, state[self.value_key], state["source"],
            num_iters=self.num_iters)
        return self._after(value, state), iters

    def summarized_batched(self, batch_state, graph, summaries, *,
                           row_mask=None):
        # one lane serves B source sets: the pinned masks ride in the bank
        (summary,) = summaries
        value, iters, changed = self.summarized_batched_sweep(
            summary, batch_state[self.value_key], batch_state["source"],
            num_iters=self.num_iters, row_mask=row_mask)
        return (self._after(value, batch_state), iters,
                changed.to(torch.float32))

    def drift_residual(self, state, graph, *, layouts=None):
        # how far one more full-graph relaxation would still move the
        # values (SSSP encodes a reachability flip as 1.0)
        if layouts is None:
            return None
        value = state[self.value_key]
        incoming = B.push(value, layouts[0], semiring=self.semiring)
        relaxed = torch.where(state["source"], self.pinned,
                              self.relax(value, incoming))
        return self.residual(relaxed, value)

    def batched_cold_seeds(self, batch_state):
        # the answer is non-trivial only where the sources reach
        return batch_state["source"]

    def result_view(self, state):
        return state[self.value_key]

    def selection_view(self, state):
        return state["delta"]


@dataclass(frozen=True)
class SSSPAlgorithm(_PathAlgorithm):
    """Streaming single-source shortest paths (Bellman-Ford on
    ``min_plus``): sources hold distance 0, unreachable vertices +∞."""

    name = "sssp"
    rank_descending = False  # nearest vertices first
    semiring = "min_plus"
    state_dtypes = {"dist": "float32", "source": "bool", "delta": "float32"}
    layout_specs = (("length", False, "min_plus"),)
    value_key = "dist"
    unreached = float("inf")
    relax = staticmethod(torch.minimum)
    residual = staticmethod(_finite_churn)
    exact_sweep = staticmethod(_sssp)
    summarized_sweep = staticmethod(_summarized_sssp)
    summarized_batched_sweep = staticmethod(_summarized_sssp_batched)


@dataclass(frozen=True)
class WidestPathAlgorithm(_PathAlgorithm):
    """Streaming widest (most-reliable) paths on ``max_times``: lengths
    are non-negative reliabilities, sources hold width 1 and unreachable
    vertices 0."""

    name = "widest-path"
    semiring = "max_times"
    state_dtypes = {"width": "float32", "source": "bool", "delta": "float32"}
    layout_specs = (("length", False, "max_times"),)
    value_key = "width"
    pinned = 1.0
    relax = staticmethod(torch.maximum)
    residual = staticmethod(lambda relaxed, value: (relaxed - value).abs())
    exact_sweep = staticmethod(_widest_path)
    summarized_sweep = staticmethod(_summarized_widest_path)
    summarized_batched_sweep = staticmethod(_summarized_widest_path_batched)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., StreamingAlgorithm]] = {}
_ALIASES: Dict[str, str] = {}


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
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{', '.join(available_algorithms())}") from None


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
register_algorithm("personalized-pagerank", PersonalizedPageRankAlgorithm,
                   aliases=("ppr",))
register_algorithm("hits", HITSAlgorithm)
register_algorithm("katz", KatzAlgorithm)
register_algorithm("connected-components", ConnectedComponentsAlgorithm,
                   aliases=("cc", "wcc"))
register_algorithm("sssp", SSSPAlgorithm, aliases=("shortest-paths",))
register_algorithm("widest-path", WidestPathAlgorithm,
                   aliases=("most-reliable-path",))
