"""Personalized PageRank, HITS and Katz in the port against the JAX package
(``backend="segment_sum"``, no mesh).

The exact sweeps run over the same graph in both packages, and a session of
each algorithm replays one ``EdgeStream`` query for query: the action, every
hot-set and summary count and the fallback flag must be identical, and the
scores hold rtol 1e-5 / atol 1e-6 (f32 sums in another order).  Iteration
counts are compared where a positive ``tol`` stops the sweep (and for PPR,
whose sweeps run their full budget): with ``tol=0`` a HITS or Katz sweep
stops when its f32 step rounds to exactly zero, which the two summation
orders reach at different iterations of an already converged sweep.  Katz
runs at ``alpha=0.01``, below 1/σ_max(A) of these graphs (0.0169 for the
1200-vertex one), where its sweep is sure to contract; the default 0.05 is
above it.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
from repro.core import policies as jpolicies
from repro.graph import graph as JG
from repro.stream import stream as jstream
import repro_torch
from repro_torch.convert import graph_state_from_numpy
from repro_torch.core import policies as tpolicies
from repro_torch.graph.generators import barabasi_albert_edges
from repro_torch.stream import StreamConfig, build_stream

# repro.core and repro_torch.core re-export functions that shadow these
# modules' names
JH = importlib.import_module("repro.core.hits")
JK = importlib.import_module("repro.core.katz")
TH = importlib.import_module("repro_torch.core.hits")
TK = importlib.import_module("repro_torch.core.katz")

TOL = dict(rtol=1e-5, atol=1e-6)
SAME = ("action", "num_nodes", "num_edges", "num_hot", "num_kr", "num_kn",
        "num_kdelta", "num_ek", "num_eb", "overflow_fallback",
        "pending_applied", "removals_requested", "removals_resolved")
#: the algorithm knobs of each replay
ALGOS = {"personalized-pagerank": dict(seeds=(0, 3)), "ppr": dict(seeds=(7,)),
         "hits": {}, "katz": dict(alpha=0.01)}


def _graphs(n=400, seed=11):
    src, dst = barabasi_albert_edges(n, 4, seed, 0.3)
    js = JG.from_edges(src, dst, n, src.shape[0] + 64)
    ts = graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")
    return js, ts


@pytest.mark.parametrize("tol", [0.0, 1e-6])
def test_exact_hits_matches_reference(tol):
    js, ts = _graphs()
    a, h, it, sigma = JH.hits(js, num_iters=40, tol=tol,
                              backend="segment_sum")
    ta, th, tit, tsigma = TH.hits(ts, num_iters=40, tol=tol)
    assert tit == int(it) if tol else tit > 1
    for out, ref in ((ta, a), (th, h), (tsigma, sigma)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # warm start from perturbed vectors
    rng = np.random.default_rng(0)
    a0 = rng.random(js.node_capacity).astype(np.float32)
    h0 = rng.random(js.node_capacity).astype(np.float32)
    a, h, it, _ = JH.hits(js, jnp.asarray(a0), jnp.asarray(h0), num_iters=5,
                          backend="segment_sum")
    ta, th, tit, _ = TH.hits(ts, torch.from_numpy(a0), torch.from_numpy(h0),
                             num_iters=5)
    assert tit == int(it) == 5
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_exact_katz_matches_reference(tol):
    js, ts = _graphs()
    c, it = JK.katz(js, alpha=0.01, tol=tol, backend="segment_sum")
    tc, tit = TK.katz(ts, alpha=0.01, tol=tol)
    assert tit == int(it) if tol else tit > 1
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), **TOL)
    init = np.linspace(0.5, 2.0, js.node_capacity, dtype=np.float32)
    c, it = JK.katz(js, jnp.asarray(init), alpha=0.01, beta=0.5, num_iters=7,
                    backend="segment_sum")
    tc, tit = TK.katz(ts, torch.from_numpy(init), alpha=0.01, beta=0.5,
                      num_iters=7)
    assert tit == int(it) == 7
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), **TOL)


def _policy(policies, action):
    """Repeat the last answer at query 1, exact every third query, else
    approximate: all three actions in five queries."""
    periodic = policies.periodic_exact(3)
    return lambda qid, view: (action.REPEAT_LAST if qid == 1
                              else periodic(qid, view))


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("knobs", [
    dict(r=0.1),
    dict(fused=False, r=0.1, n=2),
    dict(hot_node_capacity=60, hot_edge_capacity=300, update_pad=100),
], ids=["fused", "unfused", "overflow"])
def test_session_replays_the_reference_query_for_query(algo, knobs):
    src, dst = barabasi_albert_edges(1200, 4, 1, 0.3)
    cfg = dict(stream_size=1200, num_queries=5)
    stream = build_stream(src, dst, StreamConfig(**cfg))
    kw = dict(knobs, **ALGOS[algo])
    js = repro.session(jstream.build_stream(src, dst, jstream.StreamConfig(
        **cfg)), algo, backend="segment_sum",
        on_query=_policy(jpolicies, repro.Action), **kw)
    ts = repro_torch.session(stream, algo, device="cpu",
                             on_query=_policy(tpolicies, repro_torch.Action),
                             **kw)
    assert ts.algorithm.name == js.algorithm.name
    same = SAME + (("iterations",) if "seeds" in kw else ())
    j0, t0 = js.stats_log[0], ts.stats_log[0]
    assert j0.action == t0.action
    np.testing.assert_allclose(ts.scores, js.scores, **TOL)
    for q, (s, d) in enumerate(stream):
        for sess in (js, ts):
            sess.add_edges(s, d)
            if q == 2:  # removals too, one of which matches no edge
                sess.remove_edges(np.append(stream.init_src[1:21], 0),
                                  np.append(stream.init_dst[1:21], 0))
        rj, rt = js.query(), ts.query()
        for k in same:
            assert getattr(rt.stats, k) == getattr(rj.stats, k), (q, k)
        np.testing.assert_allclose(rt.scores, rj.scores, **TOL)
        np.testing.assert_array_equal(rt.valid, rj.valid)
    assert [st.action for st in ts.stats_log[1:]] == [
        "compute-approximate", "repeat-last-answer", "compute-approximate",
        "compute-exact", "compute-approximate"]
    overflow = any(st.overflow_fallback for st in ts.stats_log[1:])
    assert overflow == ("hot_node_capacity" in knobs)
    assert ts.engine.layout_builds == js.engine.layout_builds
