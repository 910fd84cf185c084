"""Parity of the port's PageRank sweeps and summary construction with the
JAX package (``backend="segment_sum"``, no mesh), given identical inputs.

Structure is bitwise (``hot_ids``, counts, E_K buffers, row offsets,
iteration counts); ``ek_w``/``b_in`` hold 1e-6 and ranks rtol 1e-5 (30 f32
sweeps whose sums run in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import backend as JB
from repro.core import hotset as JH
from repro.graph import graph as JG
from repro_torch.convert import algo_state_from_numpy, graph_state_from_numpy
from repro_torch.core import backend as TB
from repro_torch.graph.generators import barabasi_albert_edges

# repro.core and repro_torch.core re-export the function `pagerank`,
# which shadows the module
JP = importlib.import_module("repro.core.pagerank")
TP = importlib.import_module("repro_torch.core.pagerank")

RANK_TOL = dict(rtol=1e-5, atol=1e-5)
STRUCT = ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_row_offsets",
          "num_ek", "num_eb", "overflow")


def _t(a):
    return torch.from_numpy(np.array(a))


def _streamed(n=800, chunk=400, seed=11):
    """A JAX graph after one streamed chunk, the pre-chunk exact ranks and
    degree/activity snapshots, and the JAX hot mask over them."""
    src, dst = barabasi_albert_edges(n, 4, seed, 0.3)
    e_cap = src.shape[0] + 64
    js = JG.from_edges(src[:-chunk], dst[:-chunk], n, e_cap)
    ranks, _ = JP.pagerank(js, layout=JB.build_layout(js),
                           backend="segment_sum")
    deg_prev, active_prev = np.asarray(js.out_deg), np.asarray(js.node_active)
    js = JG.add_edges(js, jnp.asarray(src[-chunk:]), jnp.asarray(dst[-chunk:]))
    hot, _ = JH.select_hot_set(js, jnp.asarray(deg_prev), ranks,
                               jnp.float32(0.2), jnp.float32(0.1),
                               active_prev=jnp.asarray(active_prev))
    return js, np.asarray(ranks), np.asarray(hot)


def _port_state(js):
    return graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")


@pytest.mark.parametrize("size,density,cap", [
    (1, 1.0, 1), (63, 0.5, 40), (64, 0.3, 64), (1000, 0.1, 200),
    (5000, 0.02, 64), (4099, 0.6, 5000), (300, 0.0, 10),
])
def test_compact_indices_matches_reference(size, density, cap):
    mask = np.random.default_rng(size).random(size) < density
    ref = np.asarray(JP.compact_indices(jnp.asarray(mask), cap))
    out = TP.compact_indices(torch.from_numpy(mask), cap)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kw", [
    dict(), dict(teleport_by_n=True), dict(dangling=True, num_iters=12),
])
def test_pagerank_matches_reference(kw):
    js, ranks, _ = _streamed()
    ts = _port_state(js)
    ref, ref_it = JP.pagerank(js, layout=JB.build_layout(js),
                              backend="segment_sum", **kw)
    out, it = TP.pagerank(ts, layout=TB.build_layout(ts), **kw)
    assert it == int(ref_it)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **RANK_TOL)
    # warm start from the same ranks, and personalized teleport
    tv = np.random.default_rng(0).random(ts.node_capacity).astype(np.float32)
    ref, ref_it = JP.pagerank(js, jnp.asarray(ranks), teleport_v=jnp.asarray(
        tv), backend="segment_sum", **kw)
    out, it = TP.pagerank(ts, _t(ranks), teleport_v=_t(tv), **kw)
    assert it == int(ref_it)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **RANK_TOL)


def test_pagerank_tol_stops_early():
    js, _, _ = _streamed()
    ts = _port_state(js)
    # the L1 step is summed in another order, so a step landing on the
    # tolerance may stop one iteration apart
    ref, ref_it = JP.pagerank(js, backend="segment_sum", num_iters=200,
                              tol=1e-2)
    out, it = TP.pagerank(ts, num_iters=200, tol=1e-2)
    assert 0 < it < 200
    assert abs(it - int(ref_it)) <= 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **RANK_TOL)


def _assert_summaries_match(jsum, tsum):
    for k in STRUCT:
        a, b = np.asarray(getattr(jsum, k)), getattr(tsum, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_allclose(tsum.ek_w.numpy(), np.asarray(jsum.ek_w),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsum.b_in.numpy(), np.asarray(jsum.b_in),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_layout", [True, False])
@pytest.mark.parametrize("caps", [None, (40, 90)])
def test_build_summary_and_summarized_match_reference(use_layout, caps):
    js, ranks, hot = _streamed()
    ts = _port_state(js)
    k_cap, h_cap = caps or (js.node_capacity, js.edge_capacity)
    jl = JB.build_layout(js) if use_layout else None
    tl = TB.build_layout(ts) if use_layout else None
    jsum = JP.build_summary(js, jnp.asarray(ranks), jnp.asarray(hot),
                            hot_node_capacity=k_cap, hot_edge_capacity=h_cap,
                            layout=jl, backend="segment_sum")
    tsum = TP.build_summary(ts, _t(ranks), _t(hot), hot_node_capacity=k_cap,
                            hot_edge_capacity=h_cap, layout=tl)
    _assert_summaries_match(jsum, tsum)
    assert bool(tsum.overflow) == (caps is not None)
    ref, ref_it = JP.summarized_pagerank(jsum, jnp.asarray(ranks),
                                         backend="segment_sum")
    out, it = TP.summarized_pagerank(tsum, _t(ranks))
    assert it == int(ref_it) == 30
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **RANK_TOL)
    # summary layouts over the same buffers match too
    jlay, tlay = JB.summary_layout(jsum), TB.summary_layout(tsum)
    for k in ("src", "dst", "valid", "row_offsets"):
        np.testing.assert_array_equal(getattr(tlay, k).numpy(),
                                      np.asarray(getattr(jlay, k)))


@pytest.mark.parametrize("weight,semiring,reverse", [
    ("unit", "min_min", True), ("length", "min_plus", False),
    ("unit", "plus_times", False),
])
def test_build_summary_other_weightings_match_reference(weight, semiring,
                                                        reverse):
    js, ranks, hot = _streamed(n=400, chunk=200)
    ts = _port_state(js)
    prev = (np.arange(js.node_capacity, dtype=np.int32)
            if semiring == "min_min" else ranks)
    kw = dict(hot_node_capacity=js.node_capacity,
              hot_edge_capacity=js.edge_capacity, weight=weight,
              reverse=reverse, semiring=semiring)
    jsum = JP.build_summary(
        js, jnp.asarray(prev), jnp.asarray(hot),
        layout=JB.build_layout(js, weight=weight, reverse=reverse,
                               semiring=semiring), **kw)
    tsum = TP.build_summary(
        ts, _t(prev), _t(hot),
        layout=TB.build_layout(ts, weight=weight, reverse=reverse,
                               semiring=semiring), **kw)
    _assert_summaries_match(jsum, tsum)


def test_algo_state_converter():
    st = algo_state_from_numpy({"ranks": np.arange(4, dtype=np.float32)},
                               device="cpu")
    assert st["ranks"].dtype == torch.float32
    np.testing.assert_array_equal(st["ranks"].numpy(), [0, 1, 2, 3])
