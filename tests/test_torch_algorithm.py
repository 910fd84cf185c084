"""The legacy ``score_view`` plug-in point of the port's
``StreamingAlgorithm`` against the JAX package's.

A pre-semiring plugin overrides ``score_view``; the engine reads
``result_view``, so ``StreamingAlgorithm.__init_subclass__`` reroutes
``result_view`` through such an override (decided by MRO position, so a
mixin's counts), and ``score_view`` stays an alias that a legacy override
can chain up to with ``super()``.  These cases mirror
``tests/test_traversal.py``'s legacy tests: each plugin is built on each
package's own algorithm classes, both engines (the reference's
``segment_sum`` backend, the port on the CPU) serve the same seeded graph,
and the answers agree at the parity tolerance (f32 sums in another order)
and equal the override's arithmetic at the reference's own rtol 1e-6.
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as JC
from repro.core.engine import EngineConfig as JConfig
from repro.graph.generators import gnm_edges
import repro_torch.core.algorithm as TA
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import VeilGraphEngine as TEngine

TOL = dict(rtol=1e-5, atol=1e-6)
SELF = dict(rtol=1e-6)


def _engines(plugin_of, seed=10):
    """(reference engine, port engine), each serving its package's plugin
    on the same graph, started and queried once."""
    src, dst = gnm_edges(50, 200, seed=seed)
    base = dict(node_capacity=60, edge_capacity=256, hot_node_capacity=60,
                hot_edge_capacity=256, r=0.2, n=1, delta=0.1)
    j = JC.VeilGraphEngine(JConfig(**base, backend="segment_sum"),
                           plugin_of(JC))
    t = TEngine(TConfig(**base, device="cpu"), plugin_of(TA))
    out = []
    for eng in (j, t):
        eng.start(src, dst)
        scores, st = eng.query()
        out.append((eng, np.asarray(scores), st))
    return out


def _ranks(eng, key="ranks"):
    return np.asarray(eng.algo_state[key])


def _old_style(mod):
    @dataclass(frozen=True)
    class OldStyle(mod.PageRankAlgorithm):
        name = "old-style"

        def score_view(self, state):  # the pre-split override point
            return state["ranks"] * 2.0

    return OldStyle()


def _chained(mod):
    @dataclass(frozen=True)
    class Chained(mod.PageRankAlgorithm):
        name = "chained"

        def score_view(self, state):
            return super().score_view(state) * 3.0

    return Chained()


def _mixed(mod):
    class ScoreMixin:
        def score_view(self, state):
            return state["ranks"] * 5.0

    @dataclass(frozen=True)
    class Mixed(ScoreMixin, mod.PageRankAlgorithm):
        name = "mixed"

    return Mixed()


def _new_style(mod):
    @dataclass(frozen=True)
    class NewStyle(mod.PageRankAlgorithm):
        name = "new-style"

        def result_view(self, state):
            return state["ranks"] + 1.0

    return NewStyle()


def _renamed(mod):
    @dataclass(frozen=True)
    class Renamed(mod.PageRankAlgorithm):
        name = "renamed-state"
        state_dtypes = {}

        def init_state(self, graph):
            return {"scores": super().init_state(graph)["ranks"]}

        def exact(self, state, graph, **kw):
            st, it = super().exact({"ranks": state["scores"]}, graph, **kw)
            return {"scores": st["ranks"]}, it

        def summarized(self, state, graph, summaries, **kw):
            st, it = super().summarized({"ranks": state["scores"]}, graph,
                                        summaries, **kw)
            return {"scores": st["ranks"]}, it

        def score_view(self, state):
            return state["scores"]

    return Renamed()


#: name -> (plugin factory, state key, scale, offset): the answer is
#: scale * state[key] + offset
CASES = {
    "score-view-only-subclass": (_old_style, "ranks", 2.0, 0.0),
    "super-score-view-chain": (_chained, "ranks", 3.0, 0.0),
    "score-view-from-a-mixin": (_mixed, "ranks", 5.0, 0.0),
    "result-view-subclass-left-alone": (_new_style, "ranks", 1.0, 1.0),
    "custom-state-keys": (_renamed, "scores", 1.0, 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_plugin_answers_match_the_reference(name):
    plugin_of, key, scale, offset = CASES[name]
    (j, j_scores, j_st), (t, t_scores, t_st) = _engines(plugin_of)
    assert t_st.action == j_st.action == "compute-approximate"
    assert t_scores.dtype == j_scores.dtype and np.isfinite(t_scores).all()
    for eng, scores in ((j, j_scores), (t, t_scores)):
        np.testing.assert_allclose(scores, scale * _ranks(eng, key) + offset,
                                   **SELF)
        # the engine's cached answer is the same view
        np.testing.assert_allclose(np.asarray(eng.ranks), scores, **SELF)
    np.testing.assert_allclose(t_scores, j_scores, **TOL)


def _fresh(mod, with_view):
    """A plugin on the bare base class that defines ``score_view`` (or no
    view at all)."""

    class Fresh(mod.StreamingAlgorithm):
        name = "fresh-legacy"

        def init_state(self, graph):
            return {}

        def exact(self, state, graph, **kw):
            return state, 0

        def summarized(self, state, graph, summaries, **kw):
            return state, 0

        if with_view:
            def score_view(self, state):
                return state["x"] * 7.0

    return Fresh


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_fresh_legacy_plugin_builds_and_plugin_without_view_fails(pkg):
    mod, arr = ((JC, jnp.asarray) if pkg == "reference"
                else (TA, torch.from_numpy))
    x = np.arange(5, dtype=np.float32)
    plugin = _fresh(mod, with_view=True)()
    np.testing.assert_array_equal(
        np.asarray(plugin.result_view({"x": arr(x)})), 7.0 * x)
    np.testing.assert_array_equal(
        np.asarray(plugin.selection_view({"x": arr(x)})), 7.0 * x)
    with pytest.raises(TypeError, match="abstract"):
        _fresh(mod, with_view=False)()


def test_score_view_alias_reports_the_result_view():
    """On a shipped algorithm the alias is the result view, in both
    packages."""
    (j, j_scores, _), (t, t_scores, _) = _engines(
        lambda mod: mod.PageRankAlgorithm())
    for eng, scores in ((j, j_scores), (t, t_scores)):
        alias = np.asarray(eng.algorithm.score_view(eng.algo_state))
        np.testing.assert_array_equal(
            alias, np.asarray(eng.algorithm.result_view(eng.algo_state)))
    np.testing.assert_allclose(t_scores, j_scores, **TOL)
