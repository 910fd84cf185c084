"""Parity of the port's hot-set selection and query step with the JAX
package (``backend="segment_sum"``, no mesh), given identical inputs.

The hot mask and every count must match bitwise; the step's ranks hold
rtol 1e-5 (30 f32 sweeps whose sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import backend as JB
from repro.core import fused as JF
from repro.core import hotset as JH
from repro.core.algorithm import PageRankAlgorithm as JPageRank
from repro.graph import graph as JG
from repro_torch.convert import graph_state_from_numpy
from repro_torch.core import backend as TB
from repro_torch.core import fused as TF
from repro_torch.core import hotset as TH
from repro_torch.core.algorithm import PageRankAlgorithm as TPageRank
from repro_torch.graph.generators import barabasi_albert_edges


def _inputs(n=2000, chunk=300, seed=21):
    """One streamed chunk over a scale-free graph: the JAX state after the
    chunk, and as numpy the pre-chunk exact ranks, out- and in-degrees and
    activity.  The chunk also brings vertices never seen before."""
    src, dst = barabasi_albert_edges(n, 4, seed, 0.3)
    e_cap = src.shape[0] + 64
    # hold back the last 100 vertices entirely, so the chunk adds new ones
    old = (src < n - 100) & (dst < n - 100)
    i_src, i_dst = src[old], dst[old]
    s_src = np.concatenate([src[~old][:chunk // 2], i_src[-chunk // 2:]])
    s_dst = np.concatenate([dst[~old][:chunk // 2], i_dst[-chunk // 2:]])
    js = JG.from_edges(i_src[:-chunk // 2], i_dst[:-chunk // 2], n, e_cap)
    ranks = _exact_ranks(js)
    deg_prev = np.asarray(js.out_deg)
    in_prev = np.asarray(js.in_deg)
    active_prev = np.asarray(js.node_active)
    js = JG.add_edges(js, jnp.asarray(s_src), jnp.asarray(s_dst))
    return (js, np.array(ranks), np.array(deg_prev), np.array(in_prev),
            np.array(active_prev))


def _exact_ranks(js):
    state, _ = JPageRank().exact({}, js, layouts=(JB.build_layout(js),),
                                 backend="segment_sum")
    return state["ranks"]


def _port_state(js):
    return graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n=2, r=0.1, delta=0.05),
    dict(n=0, delta=0.5, delta_hop_cap=2),
    dict(degree_mode="total", expand_both=True),
    dict(degree_mode="in", no_active_prev=True),
    dict(normalize_scores=True, delta=1.0),
])
def test_select_hot_set_matches_reference(kw):
    kw = dict(kw)
    js, ranks, deg_prev, in_prev, active_prev = _inputs()
    ts = _port_state(js)
    r, delta = np.float32(kw.pop("r", 0.2)), np.float32(kw.pop("delta", 0.1))
    if kw.get("degree_mode") == "total":
        deg_prev = deg_prev + in_prev
    elif kw.get("degree_mode") == "in":
        deg_prev = in_prev
    act = None if kw.pop("no_active_prev", False) else active_prev
    jhot, jstats = JH.select_hot_set(
        js, jnp.asarray(deg_prev), jnp.asarray(ranks), jnp.asarray(r),
        jnp.asarray(delta),
        active_prev=None if act is None else jnp.asarray(act), **kw)
    thot, tstats = TH.select_hot_set(
        ts, torch.from_numpy(deg_prev), torch.from_numpy(ranks),
        torch.tensor(r), torch.tensor(delta),
        active_prev=None if act is None else torch.from_numpy(act), **kw)
    np.testing.assert_array_equal(thot.numpy(), np.asarray(jhot))
    for k in jstats._fields:
        assert int(getattr(tstats, k)) == int(getattr(jstats, k)), k
    assert 0 < int(tstats.num_hot) < ts.node_capacity


@pytest.mark.parametrize("both", [False, True])
def test_frontier_sweep_matches_reference(both):
    js, _, _, _, active_prev = _inputs(n=500, chunk=100)
    ts = _port_state(js)
    mark = np.random.default_rng(3).random(500) < 0.05
    ref = JH._frontier_sweep(js, jnp.asarray(mark), both=both)
    out = TH._frontier_sweep(ts, torch.from_numpy(mark), both=both)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("caps", [None, (50, 200)])
def test_fused_query_step_matches_reference(caps):
    js, ranks, deg_prev, _, active_prev = _inputs()
    ts = _port_state(js)
    k_cap, h_cap = caps or (js.node_capacity, js.edge_capacity)
    jstate, jst = JF.fused_query_step(
        js, {"ranks": jnp.asarray(ranks)}, jnp.asarray(deg_prev),
        jnp.asarray(active_prev), jnp.float32(0.2), jnp.float32(0.1),
        algo=JPageRank(), hot_node_capacity=k_cap, hot_edge_capacity=h_cap,
        layouts=(JB.build_layout(js),), backend="segment_sum")
    tstate, tst = TF.fused_query_step(
        ts, {"ranks": torch.from_numpy(ranks)}, torch.from_numpy(deg_prev),
        torch.from_numpy(active_prev), torch.tensor(0.2), torch.tensor(0.1),
        algo=TPageRank(), hot_node_capacity=k_cap, hot_edge_capacity=h_cap,
        layouts=(TB.build_layout(ts),))
    for k in TF.QueryStepStats._fields:
        assert int(getattr(tst, k)) == int(getattr(jst, k)), k
    assert bool(tst.used_fallback) == (caps is not None)
    np.testing.assert_allclose(tstate["ranks"].numpy(),
                               np.asarray(jstate["ranks"]),
                               rtol=1e-5, atol=1e-5)
    # the PageRank-specific step is the same computation
    jr, _ = JF.approximate_query_step(
        js, jnp.asarray(ranks), jnp.asarray(deg_prev),
        jnp.asarray(active_prev), jnp.float32(0.2), jnp.float32(0.1),
        hot_node_capacity=k_cap, hot_edge_capacity=h_cap,
        backend="segment_sum")
    tr, tst2 = TF.approximate_query_step(
        ts, torch.from_numpy(ranks), torch.from_numpy(deg_prev),
        torch.from_numpy(active_prev), torch.tensor(0.2), torch.tensor(0.1),
        hot_node_capacity=k_cap, hot_edge_capacity=h_cap)
    assert int(tst2.num_ek) == int(jst.num_ek)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    # the drift estimate rides the same step (core/control.py)
    from repro.core.control import default_probe_ids as jprobes
    from repro_torch.core.control import default_probe_ids as tprobes

    _, jdst = JF.fused_query_step(
        js, {"ranks": jnp.asarray(ranks)}, jnp.asarray(deg_prev),
        jnp.asarray(active_prev), jnp.float32(0.2), jnp.float32(0.1),
        jprobes(js.node_capacity), algo=JPageRank(), hot_node_capacity=k_cap,
        hot_edge_capacity=h_cap, layouts=(JB.build_layout(js),),
        backend="segment_sum", with_drift=True)
    _, tdst = TF.fused_query_step(
        ts, {"ranks": torch.from_numpy(ranks)},
        torch.from_numpy(deg_prev), torch.from_numpy(active_prev),
        torch.tensor(0.2), torch.tensor(0.1), tprobes(ts.node_capacity),
        algo=TPageRank(), hot_node_capacity=k_cap, hot_edge_capacity=h_cap,
        layouts=(TB.build_layout(ts),), with_drift=True)
    for k in ("drift_probe", "drift_cold"):
        np.testing.assert_allclose(float(getattr(tdst, k)),
                                   float(getattr(jdst, k)), rtol=1e-4,
                                   atol=1e-7)
