"""Parity of the PyTorch port's graph substrate with the JAX package.

The same numpy inputs go through ``repro.graph`` and ``repro_torch.graph``;
every buffer must match bitwise.  Also checks that the numpy-only modules
the port copies (generators, stream, metrics) give identical outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.graph import generators as jgen
from repro.graph import graph as JG
from repro.metrics import ranking as jranking
from repro.metrics import rbo as jrbo
from repro.stream import stream as jstream
from repro_torch.convert import (algo_state_from_numpy,
                                 edge_layout_from_numpy,
                                 graph_state_from_numpy)
from repro_torch.graph import generators as tgen
from repro_torch.graph import graph as TG
from repro_torch.metrics import ranking as tranking
from repro_torch.metrics import rbo as trbo
from repro_torch.stream import stream as tstream


def _np_state(state):
    return {k: None if v is None else np.asarray(v)
            for k, v in state._asdict().items()}


def _assert_states_equal(jstate, tstate, *, skip_slots=()):
    j, t = _np_state(jstate), _np_state(tstate)
    assert set(j) == set(t)
    for k in j:
        if j[k] is None or t[k] is None:
            assert j[k] is None and t[k] is None, k
            continue
        a, b = j[k], t[k]
        assert a.dtype == b.dtype, k
        if k in ("src", "dst") and skip_slots:
            keep = np.ones(a.shape[0], bool)
            keep[list(skip_slots)] = False
            a, b = a[keep], b[keep]
        np.testing.assert_array_equal(a, b, err_msg=k)


def _edges(n=300, m=3, seed=0):
    return tgen.barabasi_albert_edges(n, m, seed, 0.3)


def test_from_edges_matches_reference():
    src, dst = _edges()
    w = np.random.default_rng(1).random(src.shape[0]).astype(np.float32)
    for weights in (None, w):
        js = JG.from_edges(src, dst, 400, src.shape[0] + 100, weights=weights)
        ts = TG.from_edges(src, dst, 400, src.shape[0] + 100,
                           weights=weights, device="cpu")
        _assert_states_equal(js, ts)


def test_add_remove_sequence_matches_reference():
    rng = np.random.default_rng(2)
    src, dst = _edges()
    n_cap, e_cap = 400, src.shape[0] + 600
    init = src.shape[0] - 500
    js = JG.from_edges(src[:init], dst[:init], n_cap, e_cap)
    ts = TG.from_edges(src[:init], dst[:init], n_cap, e_cap, device="cpu")
    for lo in (init, init + 250):
        s, d = src[lo:lo + 250], dst[lo:lo + 250]
        js = JG.add_edges(js, jnp.asarray(s), jnp.asarray(d))
        ts = TG.add_edges(ts, torch.from_numpy(s), torch.from_numpy(d))
        _assert_states_equal(js, ts)
        # remove a random sample of present edges plus one absent edge
        pick = rng.choice(lo + 250, size=40, replace=False)
        r_src = np.append(src[pick], np.int32(399))
        r_dst = np.append(dst[pick], np.int32(398))
        j_slots = JG.find_edge_slots(js, r_src, r_dst)
        t_slots = TG.find_edge_slots(ts, r_src, r_dst)
        np.testing.assert_array_equal(j_slots, t_slots)
        js = JG.remove_edges_by_slot(js, jnp.asarray(j_slots))
        ts = TG.remove_edges_by_slot(ts, torch.from_numpy(t_slots))
        _assert_states_equal(js, ts)
    out_deg, in_deg = TG.recompute_degrees(ts)
    np.testing.assert_array_equal(out_deg.numpy(), ts.out_deg.numpy())
    np.testing.assert_array_equal(in_deg.numpy(), ts.in_deg.numpy())
    jo, ji = JG.recompute_degrees(js)
    np.testing.assert_array_equal(np.asarray(jo), out_deg.numpy())
    np.testing.assert_array_equal(np.asarray(ji), in_deg.numpy())
    np.testing.assert_array_equal(np.asarray(JG.inv_out_degree(js)),
                                  TG.inv_out_degree(ts).numpy())
    _assert_states_equal(JG.compact(js), TG.compact(ts))


def test_to_networkx_matches_reference():
    """The live edges (tombstones dropped, duplicates merged) over the
    active vertices, as the reference's export gives them."""
    src, dst = _edges()
    js = JG.from_edges(src, dst, 400, src.shape[0] + 100)
    ts = TG.from_edges(src, dst, 400, src.shape[0] + 100, device="cpu")
    slots = JG.find_edge_slots(js, src[:30], dst[:30])
    js = JG.remove_edges_by_slot(js, jnp.asarray(slots))
    ts = TG.remove_edges_by_slot(ts, torch.from_numpy(slots))
    jg, tg = JG.to_networkx(js), TG.to_networkx(ts)
    assert sorted(tg.nodes) == sorted(jg.nodes)
    assert sorted(tg.edges) == sorted(jg.edges)
    assert tg.number_of_edges() < len(set(zip(src.tolist(), dst.tolist())))


def test_apply_to_a_clone_preserves_the_input_state():
    """The async rebuild's apply: a clone takes the updates (matching the
    reference's non-donating variants), the input state keeps its bytes,
    and a host-held edge count gives the same state as the device's."""
    src, dst = _edges()
    n_cap, e_cap = 400, src.shape[0] + 200
    js = JG.from_edges(src[:-200], dst[:-200], n_cap, e_cap)
    ts = TG.from_edges(src[:-200], dst[:-200], n_cap, e_cap, device="cpu")
    before = {k: None if v is None else v.clone()
              for k, v in ts._asdict().items()}
    s, d = src[-200:], dst[-200:]
    js2 = JG.add_edges_preserving(js, jnp.asarray(s), jnp.asarray(d))
    ts2 = TG.add_edges(TG.clone(ts), torch.from_numpy(s), torch.from_numpy(d),
                       num_edges=src.shape[0] - 200)
    _assert_states_equal(js2, ts2)
    slots = JG.find_edge_slots(js2, s[:20], d[:20])
    js3 = JG.remove_edges_by_slot_preserving(js2, jnp.asarray(slots))
    ts3 = TG.remove_edges_by_slot(TG.clone(ts2), torch.from_numpy(slots))
    _assert_states_equal(js3, ts3)
    _assert_states_equal(js2, ts2)
    _assert_states_equal(js, ts)
    for k, v in ts._asdict().items():
        assert v is None or torch.equal(v, before[k]), k


def test_weighted_chunks_match_reference():
    src, dst = _edges()
    n_cap, e_cap = 400, src.shape[0] + 200
    js = JG.from_edges(src[:-300], dst[:-300], n_cap, e_cap)
    ts = TG.from_edges(src[:-300], dst[:-300], n_cap, e_cap,
                       device="cpu")
    lens = np.linspace(0.5, 2.0, 150).astype(np.float32)
    for lo, w in ((-300, lens), (-150, None)):
        s, d = src[lo:lo + 150 or None], dst[lo:lo + 150 or None]
        js = JG.add_edges(js, jnp.asarray(s), jnp.asarray(d),
                          None if w is None else jnp.asarray(w))
        ts = TG.add_edges(ts, torch.from_numpy(s), torch.from_numpy(d),
                          None if w is None else torch.from_numpy(w))
        _assert_states_equal(js, ts)


def test_add_overrun_drops_edges_past_capacity():
    # 2 free slots, a chunk of 5: the last 3 edges are dropped.  Their
    # endpoints (7, 8, 9 -> 11, 12, 13) appear in no kept edge.
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 3], np.int32)
    new_src = np.array([3, 4, 7, 8, 9], np.int32)
    new_dst = np.array([4, 5, 11, 12, 13], np.int32)
    js = JG.from_edges(src, dst, 16, 5)
    ts = TG.from_edges(src, dst, 16, 5, device="cpu")
    js = JG.add_edges(js, jnp.asarray(new_src), jnp.asarray(new_dst))
    ts = TG.add_edges(ts, torch.from_numpy(new_src), torch.from_numpy(new_dst))
    # the reference's last slot is written by both the kept edge and the
    # clamped dropped ones, in no defined order (ROADMAP queue 3): compare
    # it against the documented drop instead
    _assert_states_equal(js, ts, skip_slots=(4,))
    assert (int(ts.src[4]), int(ts.dst[4])) == (4, 5)
    assert int(ts.num_edges) == 5
    out_deg, in_deg = TG.recompute_degrees(ts)
    np.testing.assert_array_equal(out_deg.numpy(), ts.out_deg.numpy())
    np.testing.assert_array_equal(in_deg.numpy(), ts.in_deg.numpy())
    assert not ts.node_active[[7, 8, 9, 11, 12, 13]].any()


def test_find_edge_slots_first_live_slot_wins():
    src = np.array([0, 1, 0, 2, 0], np.int32)
    dst = np.array([1, 2, 1, 0, 1], np.int32)
    js = JG.from_edges(src, dst, 4, 8)
    ts = TG.from_edges(src, dst, 4, 8, device="cpu")
    js = JG.remove_edges_by_slot(js, jnp.asarray(np.array([0], np.int32)))
    ts = TG.remove_edges_by_slot(ts, torch.tensor([0], dtype=torch.int32))
    q_src = np.array([0, 2, 3, 1], np.int32)
    q_dst = np.array([1, 0, 3, 2], np.int32)
    t_slots = TG.find_edge_slots(ts, q_src, q_dst)
    np.testing.assert_array_equal(JG.find_edge_slots(js, q_src, q_dst),
                                  t_slots)
    np.testing.assert_array_equal(t_slots, [2, 3, -1, 1])
    empty = TG.empty(4, 8, device="cpu")
    np.testing.assert_array_equal(TG.find_edge_slots(empty, q_src, q_dst),
                                  [-1, -1, -1, -1])


def test_absent_removal_leaves_slot_zero_removal_intact():
    # an absent edge resolves to slot -1, which the reference clamps onto
    # slot 0; removing the edge at slot 0 in the same batch then races with
    # that no-op write (ROADMAP queue 3).  The port tombstones slot 0.
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    ts = TG.from_edges(src, dst, 4, 4, device="cpu")
    slots = TG.find_edge_slots(ts, np.array([0, 3], np.int32),
                               np.array([1, 3], np.int32))
    np.testing.assert_array_equal(slots, [0, -1])
    ts = TG.remove_edges_by_slot(ts, torch.from_numpy(slots))
    np.testing.assert_array_equal(ts.edge_alive.numpy(),
                                  [False, True, True, True])
    out_deg, in_deg = TG.recompute_degrees(ts)
    np.testing.assert_array_equal(out_deg.numpy(), ts.out_deg.numpy())
    np.testing.assert_array_equal(in_deg.numpy(), ts.in_deg.numpy())
    assert int(ts.num_live_edges()) == 2


@pytest.mark.parametrize("name,args", [
    ("barabasi_albert_edges", (500, 4, 3, 0.3)),
    ("citation_dag_edges", (400, 5, 1)),
    ("gnm_edges", (300, 2000, 2)),
    ("community_ego_edges", (400, 8, 6.0, 4)),
])
def test_generators_copy_matches_reference(name, args):
    a = getattr(jgen, name)(*args)
    b = getattr(tgen, name)(*args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_stream_and_metrics_copies_match_reference():
    src, dst = _edges(600, 4, 5)
    cfg_j = jstream.StreamConfig(stream_size=300, num_queries=6)
    cfg_t = tstream.StreamConfig(stream_size=300, num_queries=6)
    sj, st = jstream.build_stream(src, dst, cfg_j), \
        tstream.build_stream(src, dst, cfg_t)
    np.testing.assert_array_equal(sj.init_src, st.init_src)
    np.testing.assert_array_equal(sj.init_dst, st.init_dst)
    assert len(sj.chunks) == len(st.chunks)
    for (a, b), (c, d) in zip(sj.chunks, st.chunks):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert (sj.total_nodes, sj.total_edges) == (st.total_nodes,
                                                st.total_edges)
    rng = np.random.default_rng(3)
    x, y = rng.random(500), rng.random(500)
    active = rng.random(500) < 0.8
    assert jrbo.rbo_from_scores(x, y, depth=100, active=active) == \
        trbo.rbo_from_scores(x, y, depth=100, active=active)
    np.testing.assert_array_equal(jranking.top_k_ids(x, 20, active),
                                  tranking.top_k_ids(x, 20, active))
    assert jranking.l1_delta(x, y, active) == tranking.l1_delta(x, y, active)


def test_graph_state_converter_round_trip():
    src, dst = _edges()
    js = JG.from_edges(src, dst, 400, src.shape[0] + 10)
    ts = graph_state_from_numpy(_np_state(js), device="cpu")
    _assert_states_equal(js, ts)
    assert ts.edge_len is None


_ARRAYS = {"src": np.zeros(4, np.int32), "dst": np.zeros(4, np.int32),
           "edge_alive": np.ones(4, bool), "num_edges": np.int32(0),
           "out_deg": np.zeros(2, np.int32), "in_deg": np.zeros(2, np.int32),
           "node_active": np.zeros(2, bool)}


@pytest.mark.parametrize("build", [
    lambda: TG.empty(4, 8),
    lambda: TG.from_edges(np.array([0], np.int32), np.array([1], np.int32),
                          4, 8),
    lambda: graph_state_from_numpy(_ARRAYS),
    lambda: algo_state_from_numpy({"ranks": np.zeros(2, np.float32)}),
    lambda: edge_layout_from_numpy(
        {"src": np.zeros(4, np.int32), "dst": np.zeros(4, np.int32),
         "weight": np.zeros(4, np.float32), "valid": np.zeros(4, bool),
         "row_offsets": np.zeros(3, np.int32)}),
], ids=["empty", "from_edges", "graph_state", "algo_state", "edge_layout"])
def test_constructors_without_a_device_need_a_gpu(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
