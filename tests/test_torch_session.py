"""The port's front door against the JAX package's, query for query, plus
its import hygiene and the knobs that raise until their slice lands.

One ``EdgeStream`` replays through ``repro.session(...,
backend="segment_sum")`` and ``repro_torch.session(..., device="cpu")``
with the same configuration: per query the action, every hot-set and
summary count, the iterations and the fallback flag must be identical, and
the ranks hold rtol 1e-5.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import policies as jpolicies
from repro.stream import stream as jstream
from repro_torch.core import policies as tpolicies
from repro_torch.core.engine import EngineConfig
from repro_torch.core.pagerank import pagerank
from repro_torch.graph.generators import barabasi_albert_edges
from repro_torch.metrics import rbo_from_scores
from repro_torch.stream import StreamConfig, build_stream

SRC = Path(__file__).resolve().parents[1] / "src"
SAME = ("action", "num_nodes", "num_edges", "num_hot", "num_kr", "num_kn",
        "num_kdelta", "num_ek", "num_eb", "iterations", "overflow_fallback",
        "pending_applied", "removals_requested", "removals_resolved")


def _policy(policies, action):
    """Repeat the last answer at query 1, exact every third query, else
    approximate: all three actions in five queries."""
    periodic = policies.periodic_exact(3)
    return lambda qid, view: (action.REPEAT_LAST if qid == 1
                              else periodic(qid, view))


def _replay(knobs):
    src, dst = barabasi_albert_edges(1500, 4, 0, 0.3)
    stream = build_stream(src, dst, StreamConfig(stream_size=1500,
                                                 num_queries=5))
    js = repro.session(jstream.build_stream(src, dst, jstream.StreamConfig(
        stream_size=1500, num_queries=5)), backend="segment_sum",
                       on_query=_policy(jpolicies, repro.Action), **knobs)
    ts = repro_torch.session(stream, device="cpu",
                             on_query=_policy(tpolicies, repro_torch.Action),
                             **knobs)
    for j_st, t_st in zip(js.stats_log, ts.stats_log):  # the initial exact
        assert (j_st.action, j_st.iterations) == (t_st.action, t_st.iterations)
    np.testing.assert_allclose(ts.scores, js.scores, rtol=1e-5, atol=1e-5)
    actions = []
    for q, (s, d) in enumerate(stream):
        for sess in (js, ts):
            sess.add_edges(s, d)
            if q == 2:  # removals too, one of which matches no edge (slot
                # 0 is left out: see the graph tests for why)
                sess.remove_edges(np.append(stream.init_src[1:21], 0),
                                  np.append(stream.init_dst[1:21], 0))
        rj, rt = js.query(), ts.query()
        for k in SAME:
            assert getattr(rt.stats, k) == getattr(rj.stats, k), (q, k)
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(rt.valid, rj.valid)
        np.testing.assert_array_equal(rt.top(20), rj.top(20))
        actions.append(rt.action)
    return actions, ts, js


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(fused=False, r=0.1, n=2),
    dict(hot_node_capacity=60, hot_edge_capacity=300, update_pad=100),
])
def test_session_replays_the_reference_query_for_query(knobs):
    actions, ts, js = _replay(knobs)
    assert actions == ["compute-approximate", "repeat-last-answer",
                       "compute-approximate", "compute-exact",
                       "compute-approximate"]
    overflow = [st.overflow_fallback for st in ts.stats_log[1:]]
    assert any(overflow) == ("hot_node_capacity" in knobs)
    if not any(overflow):
        # the last (approximate) answer keeps the README's rank similarity
        # against an exact PageRank of the same graph
        exact, _ = pagerank(ts.engine.state)
        rbo = rbo_from_scores(ts.scores.astype(np.float64),
                              exact.numpy().astype(np.float64), depth=200,
                              active=ts.engine.state.node_active.numpy())
        assert rbo >= 0.95, rbo
    assert ts.engine.layout_builds == js.engine.layout_builds
    assert ts.stats_log[3].removals_resolved == 20


def test_session_front_door_conveniences():
    src, dst = barabasi_albert_edges(300, 3, 1, 0.3)
    cfg = EngineConfig(node_capacity=320, edge_capacity=src.shape[0] + 64,
                       hot_node_capacity=320,
                       hot_edge_capacity=src.shape[0] + 64, device="cpu")
    with repro_torch.session((src, dst), config=cfg) as s:
        assert s.algorithm.name == "pagerank"
        assert s.top(5).shape == (5,)
        r = s.add_edges(src[:10], dst[:10]).query()
        assert r.action == "compute-approximate"
        with pytest.raises(ValueError):
            next(s.play())
    with pytest.raises(ValueError):
        repro_torch.session((src, dst), config=cfg, r=0.5)
    with pytest.raises(ValueError):
        repro_torch.session((src, dst), device="cpu",
                            algorithm=repro_torch.core.algorithm
                            .PageRankAlgorithm(), beta=0.9)
    s = repro_torch.session((src, dst), device="cpu", num_iters=5)
    assert s.algorithm.num_iters == 5 and s.stats_log[0].iterations == 5
    with pytest.raises(ValueError):
        s.add_edges(np.array([0], np.int32), np.array([10**6], np.int32))


def test_import_pulls_in_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import sys
        import repro_torch
        assert callable(repro_torch.session)
        import repro_torch.core.engine, repro_torch.convert
        import repro_torch.kernels.spmv.kernel, repro_torch.serve.graph
        import repro_torch.core.hits, repro_torch.core.katz
        import repro_torch.kernels.spmv.autotune, repro_torch.launch.roofline
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
        assert not bad, bad
        assert 'triton' not in sys.modules
    """)
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("knob,value", [
    ("mesh", object()), ("num_shards", 2), ("shard_hot_edge_capacity", 8),
])
def test_unported_knobs_raise(knob, value):
    # the mesh knobs are ported: a mesh must be a DeviceMesh, and the shard
    # knobs need one (tests/test_torch_sharded.py drives them)
    src, dst = barabasi_albert_edges(100, 2, 0, 0.3)
    err, match = ((TypeError, "DeviceMesh") if knob == "mesh"
                  else (ValueError, "requires mesh"))
    with pytest.raises(err, match=match):
        repro_torch.session((src, dst), device="cpu", **{knob: value})


@pytest.mark.parametrize("name", ["personalized-pagerank", "ppr", "hits",
                                  "katz"])
def test_unported_algorithms_raise(name):
    # every registered algorithm is ported, the closed quality loop too:
    # each of these runs under quality_target with the conservative gain
    src, dst = barabasi_albert_edges(100, 2, 0, 0.3)
    s = repro_torch.session((src, dst), name, device="cpu")
    assert s.algorithm.name == {"ppr": "personalized-pagerank"}.get(name,
                                                                    name)
    assert s.algorithm.name in repro_torch.available_algorithms()
    q = repro_torch.session((src, dst), name, device="cpu",
                            quality_target=0.9)
    assert q.engine.controller.gain == 3.0
    st = q.add_edges(src[:5], dst[:5]).query().stats
    assert st.r_eff > 0.0 and 0.0 <= st.quality_est <= 1.0


@pytest.mark.parametrize("name,canonical", [
    ("connected-components", "connected-components"),
    ("cc", "connected-components"), ("wcc", "connected-components"),
    ("sssp", "sssp"), ("shortest-paths", "sssp"),
    ("widest-path", "widest-path"), ("most-reliable-path", "widest-path"),
])
def test_traversal_algorithms_and_aliases_resolve(name, canonical):
    src, dst = barabasi_albert_edges(100, 2, 0, 0.3)
    s = repro_torch.session((src, dst), name, device="cpu")
    assert s.algorithm.name == canonical
    assert canonical in repro_torch.available_algorithms()
    if canonical != "connected-components":
        for bad, match in (((10**6,), "node_capacity"), ((-1,), "negative"),
                           ((), "source")):
            with pytest.raises(ValueError, match=match):
                repro_torch.session((src, dst), name, device="cpu",
                                    sources=bad)


def test_backend_names_and_serving_raise():
    src, dst = barabasi_albert_edges(100, 2, 0, 0.3)
    for name in ("pallas", "segment_sum"):
        with pytest.raises(ValueError, match="device"):
            repro_torch.session((src, dst), device="cpu", backend=name)
    # serving runs; its later-slice knobs raise naming their entries
    with repro_torch.serve_session((src, dst), device="cpu") as srv:
        assert srv.slots == 4 and srv.pending == 0
    for knob, value in (("async_rebuild", True), ("quality_target", 0.9)):
        with repro_torch.serve_session((src, dst), device="cpu",
                                       **{knob: value}) as srv:
            t = srv.submit("sssp", sources=(0,))
            srv.run()
            assert t.done
    with pytest.raises(ValueError, match="num_shards requires mesh"):
        repro_torch.serve_session((src, dst), device="cpu", num_shards=2)
    with pytest.raises(KeyError):
        repro_torch.session((src, dst), "no-such-algorithm", device="cpu")


def test_session_without_a_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = barabasi_albert_edges(100, 2, 0, 0.3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.session((src, dst))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.session((src, dst), config=EngineConfig(
            node_capacity=128, edge_capacity=512, hot_node_capacity=128,
            hot_edge_capacity=512))
