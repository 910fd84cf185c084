"""The port's batched serving path against the JAX package's
(``backend="segment_sum"``, no mesh), layer by layer.

- ``summarized_batched`` of all seven algorithms over one shared summary:
  against JAX's on the same slot bank, and against the port's own
  per-query ``summarized`` loop; ``row_mask`` freezes rows.
- ``fused_query_step_batched`` with cold rows (seed-local reachability):
  every hot-set and summary count and the new bank, against JAX's.
- A ``serve_session`` replay: the same graph, submissions and streamed
  updates through ``repro.serve_session`` and ``repro_torch.serve_session``,
  ticket for ticket.
- The engine's behaviour: uneven convergence refills slots, overflow
  falls back to per-row exact, refusals, ``ServeStats``.

Tolerances: integer and boolean outputs, counts and every min/max result
are bitwise; f32 sums (HITS's L1 normalizers included) hold the JAX
serving suite's rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro.core import backend as JB
from repro.core.algorithm import make_algorithm as jmake
from repro.core.fused import fused_query_step_batched as jfused
from repro.graph import graph as JG
from repro.graph.generators import gnm_edges
import repro_torch
from repro_torch.convert import (algo_state_from_numpy, graph_state_from_numpy,
                                 summary_buffers_from_numpy)
from repro_torch.core import backend as TB
from repro_torch.core.algorithm import StreamingAlgorithm
from repro_torch.core.algorithm import make_algorithm as tmake
from repro_torch.core.engine import EngineConfig, VeilGraphEngine
from repro_torch.core.fused import fused_query_step_batched as tfused
from repro_torch.serve.graph import GraphServingEngine, ServeStats

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 3
ALGORITHMS = ("pagerank", "personalized-pagerank", "hits", "katz",
              "connected-components", "sssp", "widest-path")
BITWISE_ALGOS = ("connected-components", "sssp", "widest-path")
SUMMARY_FIELDS = ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_w",
                  "ek_row_offsets", "num_ek", "b_in", "num_eb", "overflow")
STRUCTURE = tuple(f for f in SUMMARY_FIELDS if f != "b_in")
WAVE_STATS = ("num_hot", "num_kr", "num_kn", "num_kdelta", "num_ek",
              "num_eb", "iterations", "used_fallback")


def _match(out, ref, name, what=""):
    """Bitwise for the min/max workloads (and integer leaves), allclose
    for the sums."""
    out, ref = np.asarray(out), np.array(ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape, what
    if name in BITWISE_ALGOS or not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(out, ref, err_msg=what)
    else:
        np.testing.assert_allclose(out, ref, err_msg=what, **TOL)


def _same_iterations(it, ref_it, name):
    """Equal for the min/max workloads; a sum sweep with ``tol=0`` stops
    when its f32 step rounds to exactly zero, which the two packages'
    summation orders may reach one iteration apart."""
    if name in BITWISE_ALGOS:
        assert it == int(ref_it)
    else:
        assert abs(it - int(ref_it)) <= 1, (it, int(ref_it))


def _port_state(js):
    return graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")


def _graph(n=150, m=900, seed=2):
    src, dst = gnm_edges(n, m, seed=seed)
    js = JG.from_edges(src, dst, n, m + 64)
    return js, _port_state(js)


def _params(name, i):
    """Per-query identity of row i (the JAX serving suite's)."""
    if name == "personalized-pagerank":
        return dict(seeds=(i,))
    if name in ("sssp", "widest-path"):
        return dict(sources=(i,))
    return {}


def _bank(name, js, batch=BATCH):
    """A JAX slot bank of ``batch`` rows and the instances behind it; float
    rows of identical instances are scaled apart, as in the JAX suite."""
    insts = [jmake(name, **_params(name, i)) for i in range(batch)]
    rows = []
    for i, inst in enumerate(insts):
        row = inst.init_state(js)
        if name in ("pagerank", "hits", "katz"):
            row = {k: v * (1.0 + 0.05 * i) for k, v in row.items()}
        rows.append(row)
    bank = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rows)
    return insts, rows, bank


def _to_port(bank):
    return algo_state_from_numpy({k: np.asarray(v) for k, v in bank.items()},
                                 device="cpu")


def _layouts(js, ts, algo):
    specs = list(map(JB.normalize_layout_spec, algo.layout_specs))
    return (tuple(JB.build_layout(js, weight=w, reverse=r, semiring=s)
                  for w, r, s in specs),
            tuple(TB.build_layout(ts, weight=w, reverse=r, semiring=s)
                  for w, r, s in specs))


def _summary_from_reference(jsum):
    return summary_buffers_from_numpy(
        {k: np.asarray(getattr(jsum, k)) for k in SUMMARY_FIELDS},
        device="cpu", weight_mode=jsum.weight_mode, semiring=jsum.semiring)


# --------------------------------------------------------------------------
# The batched summarized sweeps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALGORITHMS)
def test_summarized_batched_matches_reference(name):
    js, ts = _graph()
    n = js.node_capacity
    insts, rows, jbank = _bank(name, js)
    jalgo = insts[0]
    talgo = tmake(name, **_params(name, 0))
    tbank = _to_port(jbank)
    talgo.validate_batch_state(tbank, BATCH)
    # a partial hot set, so b_in carries a real cold boundary
    hot = np.asarray(js.node_active) & (np.arange(n) % 3 != 0)
    caps = dict(hot_node_capacity=n, hot_edge_capacity=js.edge_capacity)
    jl, tl = _layouts(js, ts, jalgo)
    jsums = jalgo.build_summaries(jbank, js, jnp.asarray(hot), layouts=jl,
                                  backend="segment_sum", **caps)
    tsums = talgo.build_summaries(tbank, ts, torch.from_numpy(hot),
                                  layouts=tl, **caps)
    for jsum, tsum in zip(jsums, tsums):
        for k in STRUCTURE:
            np.testing.assert_array_equal(getattr(tsum, k).numpy(),
                                          np.asarray(getattr(jsum, k)), k)
        assert tuple(tsum.b_in.shape) == (BATCH, n)
        _match(tsum.b_in.numpy(), jsum.b_in, name, "b_in")

    ref, ref_it, ref_delta = jalgo.summarized_batched(
        jbank, js, jsums, backend="segment_sum")
    for sums in (tsums, tuple(map(_summary_from_reference, jsums))):
        out, it, delta = talgo.summarized_batched(tbank, ts, sums)
        _same_iterations(it, ref_it, name)
        assert set(out) == set(ref)
        for k in ref:
            _match(out[k].numpy(), ref[k], name, k)
        _match(delta.numpy(), ref_delta, name, "row_delta")

    # masked rows carry over bit for bit and report zero delta
    live = np.array([True, False, True])
    ref_m, ref_mit, ref_mdelta = jalgo.summarized_batched(
        jbank, js, jsums, row_mask=jnp.asarray(live), backend="segment_sum")
    out_m, it_m, delta_m = talgo.summarized_batched(
        tbank, ts, tsums, row_mask=torch.from_numpy(live))
    _same_iterations(it_m, ref_mit, name)
    for k in ref_m:
        np.testing.assert_array_equal(out_m[k][1].numpy(),
                                      tbank[k][1].numpy())
        _match(out_m[k].numpy(), ref_m[k], name, k)
    assert float(delta_m[1]) == 0.0
    _match(delta_m.numpy(), ref_mdelta, name, "row_delta")


@pytest.mark.parametrize("name", ALGORITHMS)
def test_summarized_batched_is_the_per_query_loop(name):
    """The port's batched sweep over one shared summary against its own
    per-query sweep over each row's own summary (bitwise for min/max)."""
    js, ts = _graph(seed=3)
    n = js.node_capacity
    tinsts = [tmake(name, **_params(name, i)) for i in range(BATCH)]
    trows = []
    for i, inst in enumerate(tinsts):
        row = inst.init_state(ts)
        if name in ("pagerank", "hits", "katz"):
            row = {k: v * (1.0 + 0.05 * i) for k, v in row.items()}
        trows.append(row)
    tbank = {k: torch.stack([r[k] for r in trows]) for k in trows[0]}
    hot = ts.node_active & (torch.arange(n) % 4 != 1)
    caps = dict(hot_node_capacity=n, hot_edge_capacity=ts.edge_capacity)
    _, tl = _layouts(js, ts, tinsts[0])
    out, _, _ = tinsts[0].summarized_batched(
        tbank, ts, tinsts[0].build_summaries(tbank, ts, hot, layouts=tl,
                                             **caps))
    for i, (inst, row) in enumerate(zip(tinsts, trows)):
        single, _ = inst.summarized(
            row, ts, inst.build_summaries(row, ts, hot, layouts=tl, **caps))
        for k in single:
            _match(out[k][i].numpy(), single[k].numpy(), name, k)


def test_validate_batch_state_rejects():
    _, ts = _graph()
    algo = tmake("sssp", sources=(0,))
    row = algo.init_state(ts)
    bank = {k: torch.stack([v, v]) for k, v in row.items()}
    algo.validate_batch_state(bank, 2)
    with pytest.raises(ValueError, match="missing declared keys"):
        algo.validate_batch_state(
            {k: v for k, v in bank.items() if k != "dist"}, 2)
    with pytest.raises(ValueError, match="dtype"):
        algo.validate_batch_state(
            dict(bank, dist=bank["dist"].to(torch.int32)), 2)
    with pytest.raises(ValueError, match="leading batch axis"):
        algo.validate_batch_state(bank, 3)
    with pytest.raises(ValueError, match="leading batch axis"):
        algo.validate_batch_state(algo_state_from_numpy(
            {k: v[0].numpy() for k, v in bank.items()}, device="cpu"), 2)


# --------------------------------------------------------------------------
# The batched fused step with cold rows
# --------------------------------------------------------------------------


def _two_components(chunk=60):
    """A 10-vertex path (0 → … → 9) beside a random 120-vertex component
    (ids 20..139), streamed: the JAX state before and after the last
    ``chunk`` edges, and the port's state after them."""
    path = np.arange(9, dtype=np.int32)
    gs, gd = gnm_edges(120, 700, seed=4)
    src = np.concatenate([path, gs.astype(np.int32) + 20])
    dst = np.concatenate([path + 1, gd.astype(np.int32) + 20])
    n, e_cap = 150, src.shape[0] + 64
    js0 = JG.from_edges(src[:-chunk], dst[:-chunk], n, e_cap)
    snap = (np.asarray(js0.out_deg), np.asarray(js0.node_active))
    js = JG.add_edges(JG.from_edges(src[:-chunk], dst[:-chunk], n, e_cap),
                      jnp.asarray(src[-chunk:]), jnp.asarray(dst[-chunk:]))
    return js, _port_state(js), snap


@pytest.mark.parametrize("name,seeds", [
    ("personalized-pagerank", (3, 25, 60)),
    ("sssp", (0, 4, 30)),
    ("widest-path", (2, 22, 90)),
    ("connected-components", None),
    ("pagerank", None),
])
@pytest.mark.parametrize("cold", [(True, False, True), (False, False, False)],
                         ids=["cold", "warm"])
def test_fused_step_batched_matches_reference(name, seeds, cold):
    js, ts, snap = _two_components()
    key = "seeds" if name == "personalized-pagerank" else "sources"
    insts = [jmake(name, **({} if seeds is None else {key: (s,)}))
             for s in (seeds or (0, 0, 0))]
    jbank = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *[i.init_state(js) for i in insts])
    talgo = tmake(name, **({} if seeds is None else {key: (seeds[0],)}))
    live = np.array([True, True, False])
    kw = dict(hot_node_capacity=js.node_capacity,
              hot_edge_capacity=js.edge_capacity, n=1, delta_hop_cap=4)
    jl, tl = _layouts(js, ts, insts[0])
    jnew, jst, jdelta = jfused(
        js, jbank, jnp.asarray(snap[0]), jnp.asarray(snap[1]),
        jnp.float32(0.1), jnp.float32(0.1), jnp.asarray(live),
        jnp.asarray(cold), None, algo=insts[0], layouts=jl,
        backend="segment_sum", **kw)
    tnew, tst, tdelta = tfused(
        ts, _to_port(jbank), torch.tensor(snap[0]), torch.tensor(snap[1]), torch.tensor(0.1), torch.tensor(0.1),
        torch.from_numpy(live), torch.tensor(cold), algo=talgo, layouts=tl,
        **kw)
    for k in WAVE_STATS:
        assert int(getattr(tst, k)) == int(getattr(jst, k)), k
    for k in jnew:
        _match(tnew[k].numpy(), jnew[k], name, k)
    _match(tdelta.numpy(), jdelta, name, "row_delta")
    if cold[0] and name == "sssp":
        # the live cold rows' sources (0 on the path, 4 on it too) reach
        # the path's tail: seed-local coverage, not the whole graph
        assert int(tst.num_hot) < int(ts.num_active_nodes())


def test_cold_coverage_is_seed_local():
    """A cold SSSP row whose source sits on the 10-vertex path covers
    exactly the path; a seedless algorithm covers every active vertex.
    Churn selection is switched off (r, Δ huge; n = 0)."""
    js, ts, snap = _two_components()
    cfg = dict(hot_node_capacity=ts.node_capacity,
               hot_edge_capacity=ts.edge_capacity, n=0)
    big = torch.tensor(1e9)
    counts = []
    for algo in (tmake("sssp", sources=(0,)), tmake("pagerank")):
        row = algo.init_state(ts)
        bank = {k: torch.stack([v, v]) for k, v in row.items()}
        _, st, _ = tfused(ts, bank, ts.out_deg.clone(),
                          ts.node_active.clone(), big, big,
                          torch.tensor([True, True]),
                          torch.tensor([True, False]), algo=algo, **cfg)
        counts.append(int(st.num_hot))
    assert counts == [10, int(ts.num_active_nodes())]


# --------------------------------------------------------------------------
# serve_session, replayed against the reference
# --------------------------------------------------------------------------


def _submit_mix(srv):
    """The JAX suite's 10 PPR seeds + 4 SSSP sources on 4 slots, one
    two-source widest-path lane, and one query each of CC, Katz, HITS and
    a multi-wave PPR."""
    tickets = [srv.submit("personalized-pagerank", seeds=(s,))
               for s in range(10)]
    tickets += [srv.submit("sssp", sources=(s,)) for s in range(4)]
    tickets += [srv.submit("widest-path", sources=(s,)) for s in (5, 9)]
    tickets += [srv.submit("cc"), srv.submit("katz"), srv.submit("hits")]
    tickets.append(srv.submit("ppr", seeds=(11, 12), tol=1e-6,
                              max_waves=3))
    return tickets


def test_serve_session_replays_the_reference_ticket_for_ticket():
    src, dst = gnm_edges(150, 1000, seed=4)
    init = 900
    jsrv = repro.serve_session((src[:init], dst[:init]), slots=4,
                               backend="segment_sum")
    tsrv = repro_torch.serve_session((src[:init], dst[:init]), slots=4,
                                     device="cpu")
    jt, tt = _submit_mix(jsrv), _submit_mix(tsrv)
    assert jsrv.pending == tsrv.pending == len(tt)
    wave = 0
    while jsrv.pending or tsrv.pending:
        # a chunk of the stream between waves, removals at wave 2
        lo = init + 30 * wave
        for srv in (jsrv, tsrv):
            if lo < src.shape[0]:
                srv.add_edges(src[lo:lo + 30], dst[lo:lo + 30])
            if wave == 2:
                srv.remove_edges(src[10:20], dst[10:20])
        assert jsrv.step() == tsrv.step(), wave
        wave += 1
        assert wave < 20
    for a, b in zip(jt, tt):
        assert (b.algorithm, b.done, b.waves_run, b.converged,
                b.exact_fallback) == (a.algorithm, a.done, a.waves_run,
                                      a.converged, a.exact_fallback), a
        name = b.algorithm
        _match(b.result, a.result, name, f"ticket {a.ticket_id} {name}")
    js, ts = jsrv.stats, tsrv.stats
    for k in ("queries_submitted", "queries_completed", "waves",
              "overflow_fallbacks"):
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.occupancy_sum == pytest.approx(js.occupancy_sum, rel=1e-12)
    assert ts.queries_per_s > 0 and ts.p95_wave_latency_s > 0
    # every lane-wave logged; the cold waves covered seed-local reach
    assert {w.algorithm for w in tsrv.wave_log} == {
        "personalized-pagerank", "sssp", "widest-path",
        "connected-components", "katz", "hits"}
    jsrv.close()
    tsrv.close()


def test_uneven_convergence_refills_slots():
    """Two slots and three SSSP queries of very different depths on a
    64-vertex path: the shallow query converges and frees its slot for the
    queued one while the deep one keeps iterating."""
    n = 64
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    srv = repro_torch.serve_session((src, dst), slots=2, device="cpu")
    near = srv.submit("sssp", sources=(62,), num_iters=2, max_waves=200)
    far = srv.submit("sssp", sources=(0,), num_iters=2, max_waves=200)
    while not near.done:
        srv.step()
    assert not far.done
    extra = srv.submit("sssp", sources=(50,), num_iters=2, max_waves=200)
    srv.run()
    for t in (near, far, extra):
        assert t.done and t.converged and not t.exact_fallback
    assert near.waves_run < extra.waves_run < far.waves_run
    assert (float(near.result[63]), float(extra.result[63]),
            float(far.result[63])) == (1.0, 13.0, 63.0)
    srv.close()


def test_streamed_weighted_edges_reach_sssp():
    src = np.asarray([0, 1, 2, 4], np.int32)
    dst = np.asarray([1, 2, 3, 0], np.int32)
    srv = repro_torch.serve_session((src, dst), slots=2, edge_capacity=16,
                                    device="cpu")
    srv.add_edges([3], [4], weights=[2.5])
    t = srv.submit("sssp", sources=(0,))
    srv.run()
    assert t.done and t.converged and float(t.result[4]) == 5.5
    srv.close()


@pytest.mark.parametrize("name,params", [
    ("personalized-pagerank", dict(seeds=(7,))),
    ("sssp", dict(sources=(7,))),
])
def test_overflow_falls_back_to_exact(name, params):
    """A summary too small for the cold wave: the batch result is dropped
    and each live row is recomputed exactly, as the reference does."""
    src, dst = gnm_edges(100, 800, seed=5)
    caps = dict(slots=2, hot_node_capacity=128, hot_edge_capacity=16)
    jsrv = repro.serve_session((src, dst), backend="segment_sum", **caps)
    tsrv = repro_torch.serve_session((src, dst), device="cpu", **caps)
    jt, tt = jsrv.submit(name, **params), tsrv.submit(name, **params)
    jsrv.run()
    tsrv.run()
    assert tt.done and tt.exact_fallback and not tt.converged
    assert tsrv.stats.overflow_fallbacks == jsrv.stats.overflow_fallbacks >= 1
    assert tsrv.wave_log[0].overflow_fallback
    _match(tt.result, jt.result, name)


def test_submit_and_wrap_refusals():
    @dataclasses.dataclass(frozen=True)
    class NoBatch(StreamingAlgorithm):
        name = "nobatch"

        def init_state(self, graph):
            return {"x": torch.zeros(graph.node_capacity)}

        def exact(self, state, graph, *, layouts=None):
            return state, 0

        def summarized(self, state, graph, summaries):
            return state, 0

        def result_view(self, state):
            return state["x"]

    src, dst = gnm_edges(50, 200, seed=6)
    srv = repro_torch.serve_session((src, dst), slots=2, device="cpu")
    with pytest.raises(TypeError, match="summarized_batched"):
        srv.submit(NoBatch())
    with pytest.raises(ValueError, match="max_waves"):
        srv.submit("pagerank", max_waves=0)
    with pytest.raises(ValueError, match="slots"):
        GraphServingEngine(srv.engine, slots=0)
    srv.close()
    eng = VeilGraphEngine(EngineConfig(node_capacity=8, edge_capacity=16,
                                       hot_node_capacity=8,
                                       hot_edge_capacity=16, device="cpu"))
    with pytest.raises(ValueError, match="started"):
        GraphServingEngine(eng, slots=2)
    # with_drift adds the per-slot drift, zero on vacant rows
    bank = {"ranks": torch.ones(2, 8)}
    out = tfused(eng.state, bank, eng.deg_prev, eng.active_prev,
                 torch.tensor(0.1), torch.tensor(0.1),
                 torch.tensor([True, False]), probe_ids=torch.arange(
                     4, dtype=torch.int32), algo=tmake("pagerank"),
                 hot_node_capacity=8, hot_edge_capacity=16, with_drift=True)
    assert len(out) == 4 and out[3].shape == (2, 2)
    assert out[3][1].abs().sum() == 0


def test_serve_stats_guards_and_nearest_rank_quantiles():
    empty = ServeStats()
    assert (empty.queries_per_s, empty.mean_occupancy,
            empty.p50_wave_latency_s, empty.p95_wave_latency_s) == (0.0,) * 4
    one = ServeStats(queries_completed=1, waves=1, wall_s=0.25,
                     occupancy_sum=0.5, wave_latencies_s=[0.25])
    assert one.p50_wave_latency_s == one.p95_wave_latency_s == 0.25
    assert (one.queries_per_s, one.mean_occupancy) == (4.0, 0.5)
    assert ServeStats(queries_completed=3, waves=1,
                      wall_s=0.0).queries_per_s == 0.0
    lat = [round(0.01 * k, 2) for k in range(20, 0, -1)]
    s = ServeStats(wave_latencies_s=lat)
    assert (s.p95_wave_latency_s, s.p50_wave_latency_s) == (0.19, 0.10)
    assert s._latency_quantile(0.0) == s._latency_quantile(-3.0) == 0.01
    assert s._latency_quantile(1.0) == s._latency_quantile(7.0) == 0.20


def test_serve_session_without_a_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = gnm_edges(50, 200, seed=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.serve_session((src, dst))
