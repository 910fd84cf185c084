"""The port's closed quality loop against the JAX package's
(``repro.core.control``, ``backend="segment_sum"``, no mesh).

Every input is made with numpy from a seed and handed to both packages:

- ``default_probe_ids``, ``drift_signals`` and ``QualityController``:
  probe ids bitwise, drift scalars at rtol 1e-6, and the controller's
  decisions (refresh, r_eff, delta_eff, the error estimate) exactly, given
  the same readings;
- every algorithm's ``drift_residual`` on the same state and graph: the
  sum algebras (PageRank, PPR, Katz) at rtol/atol 1e-5, the min/max
  workloads (SSSP, widest path, CC) bitwise, HITS defining none in both;
- the fused steps with ``with_drift=True`` (single and batched);
- a ``quality_target`` session and a ``serve_session`` replayed against
  the JAX package's: drift readings at rtol 1e-4 / atol 1e-6 (f32 sums in
  another order), and ``refreshed``/``r_eff``/``delta_eff`` equal query
  for query;
- the port's own loop: knob precedence, the refusal without the fused
  path, exact actions counting as refreshes, the SLO on a drifting stream
  (RBO against an exact replay), and the serving lanes' refresh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
from repro.core import backend as JB
from repro.core import control as JC
from repro.core import fused as JF
from repro.core.algorithm import make_algorithm as jmake
from repro.graph import graph as JG
from repro.graph.generators import gnm_edges
import repro_torch
from repro_torch.convert import algo_state_from_numpy, graph_state_from_numpy
from repro_torch.core import backend as TB
from repro_torch.core import control as TC
from repro_torch.core import fused as TF
from repro_torch.core.algorithm import Action
from repro_torch.core.algorithm import make_algorithm as tmake
from repro_torch.metrics import rbo_from_scores

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
#: drift readings of a whole query: f32 sums over the graph in another
#: order than XLA's
DRIFT_TOL = dict(rtol=1e-4, atol=1e-6)
#: the controller's decision columns, equal query for query
DECISIONS = ("action", "refreshed", "r_eff", "delta_eff", "overflow_fallback",
             "num_hot", "num_ek", "num_eb", "pending_applied")
PARAMS = {"personalized-pagerank": {"seeds": (0, 5)},
          "sssp": {"sources": (0, 7)}, "widest-path": {"sources": (1,)},
          "katz": {"alpha": 0.02}}
ALGORITHMS = ("pagerank", "personalized-pagerank", "hits", "katz",
              "connected-components", "sssp", "widest-path")
MIN_MAX = ("connected-components", "sssp", "widest-path")


def _port_state(js):
    return graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")


def _drifting_stream(n, steps, chunk, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n, chunk).astype(np.int32),
             rng.integers(0, n, chunk).astype(np.int32))
            for _ in range(steps)]


# ---------------------------------------------------------------------------
# the estimator primitives and the controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap,probes", [(1024, 64), (16, 64), (1000, 7),
                                        (5, 1)])
def test_default_probe_ids_match_reference(cap, probes):
    t = TC.default_probe_ids(cap, probes)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(JC.default_probe_ids(cap, probes)))


def _signal_inputs(seed, n=300, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    resid = (rng.random(shape) * 0.1).astype(np.float32)
    result = (rng.random(shape) + 0.5).astype(np.float32)
    result[rng.random(shape) < 0.1] = np.inf     # unreachable sentinels
    resid[rng.random(shape) < 0.05] = -0.2       # clamped to 0
    hot = rng.random(n) < 0.3
    active = rng.random(n) < 0.9
    probes = TC.default_probe_ids(n, 32).numpy()
    return resid, result, hot, active, probes


@pytest.mark.parametrize("normalize", ["mass", "count"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_signals_match_reference(normalize, seed):
    resid, result, hot, active, probes = _signal_inputs(seed)
    jp, jc = JC.drift_signals(*map(jnp.asarray, (resid, result, hot, active,
                                                 probes)),
                              normalize=normalize)
    tp, tc = TC.drift_signals(*map(torch.from_numpy, (resid, result, hot,
                                                      active, probes)),
                              normalize=normalize)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-6)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)


def test_drift_signals_hand_computed_and_batched_rows():
    """The reference suite's hand-checked values, and a ``[B, N]`` residual
    giving each row its own pair."""
    tp, tc = TC.drift_signals(
        torch.tensor([0.1, 0.0, 0.3, 0.0]), torch.tensor([1.0, 2.0, 1.0, 1.0]),
        torch.tensor([True, True, False, False]), torch.ones(4, dtype=bool),
        torch.tensor([0, 2], dtype=torch.int32))
    np.testing.assert_allclose(float(tc), 0.3 / 5.0, rtol=1e-6)
    np.testing.assert_allclose(float(tp), 0.2 * 4 / 5.0, rtol=1e-6)
    resid, result, hot, active, probes = _signal_inputs(4, batch=3)
    args = [torch.from_numpy(a) for a in (hot, active, probes)]
    bp, bc = TC.drift_signals(torch.from_numpy(resid),
                              torch.from_numpy(result), *args)
    assert bp.shape == bc.shape == (3,)
    for i in range(3):
        p, c = TC.drift_signals(torch.from_numpy(resid[i]),
                                torch.from_numpy(result[i]), *args)
        np.testing.assert_allclose(float(bp[i]), float(p), rtol=1e-6)
        np.testing.assert_allclose(float(bc[i]), float(c), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(contraction=0.0),
    dict(contraction=0.5, tighten=0.7),
    dict(gain=5.0, contraction=0.5),
    dict(adjust_r=False),
    dict(adjust_delta=False, r_bounds=(0.05, 1.0)),
])
def test_controller_decisions_match_reference(kw):
    """The same readings through both controllers give the same decisions,
    float for float."""
    rng = np.random.default_rng(len(kw))
    jc = JC.QualityController(0.95, r0=0.2, delta0=0.1, **kw)
    tc = TC.QualityController(0.95, r0=0.2, delta0=0.1, **kw)
    assert tc.gain == jc.gain
    for i in range(60):
        probe, cold = (rng.random(2) * 0.03 * (i % 7 == 0)).tolist()
        jd, td = jc.observe(probe, cold), tc.observe(probe, cold)
        assert (td.refresh, td.r_eff, td.delta_eff, td.err_est,
                td.quality_est) == (jd.refresh, jd.r_eff, jd.delta_eff,
                                    jd.err_est, jd.quality_est)
        if td.refresh:
            jc.refreshed()
            tc.refreshed()
    assert (tc.accum, tc.refreshes, tc.observations) == (
        jc.accum, jc.refreshes, jc.observations)


def test_controller_validates_like_reference():
    for bad in (0.0, 1.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="quality_target"):
            TC.QualityController(bad, r0=0.2, delta0=0.1)
    with pytest.raises(ValueError, match="contraction"):
        TC.QualityController(0.95, r0=0.2, delta0=0.1, contraction=1.0)
    # r0/delta0 outside the bounds clamp into them
    tc = TC.QualityController(0.9, r0=10.0, delta0=0.0)
    jc = JC.QualityController(0.9, r0=10.0, delta0=0.0)
    assert (tc.r_eff, tc.delta_eff) == (jc.r_eff, jc.delta_eff)


# ---------------------------------------------------------------------------
# the residuals and the fused steps
# ---------------------------------------------------------------------------


def _drifted(name, n=200, burst=80, seed=3):
    """Both packages' graphs after a burst of updates, each algorithm's
    exact state of the graph before it, and the layouts after (a sparse
    graph for connected components, whose burst must merge components;
    reliabilities in [0.5, 1) for widest path, whose unit widths would be
    0 or 1)."""
    m = 150 if name == "connected-components" else 1200
    ja, ta = jmake(name, **PARAMS.get(name, {})), tmake(
        name, **PARAMS.get(name, {}))
    src, dst = gnm_edges(n, m, seed=seed)
    rng = np.random.default_rng(seed)
    weighted = name == "widest-path"
    lens = lambda k: (rng.uniform(0.5, 1.0, k).astype(np.float32)
                      if weighted else None)
    js0 = JG.from_edges(src, dst, n, m + 2 * burst, weights=lens(len(src)))
    jstate, _ = ja.exact(ja.init_state(js0), js0, backend="segment_sum")
    new_len = lens(burst)
    js = JG.add_edges(js0, jnp.asarray(rng.integers(0, n, burst), jnp.int32),
                      jnp.asarray(rng.integers(0, n, burst), jnp.int32),
                      None if new_len is None else jnp.asarray(new_len))
    ts = _port_state(js)
    specs = list(map(JB.normalize_layout_spec, ja.layout_specs))
    jl = tuple(JB.build_layout(js, weight=w, reverse=r, semiring=s)
               for w, r, s in specs)
    tl = tuple(TB.build_layout(ts, weight=w, reverse=r, semiring=s)
               for w, r, s in specs)
    tstate = algo_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.items()}, device="cpu")
    return ja, ta, js, ts, jstate, tstate, jl, tl


def _match(out, ref, name):
    if name in MIN_MAX:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)


@pytest.mark.parametrize("name", ALGORITHMS)
def test_drift_residual_matches_reference(name):
    ja, ta, js, ts, jstate, tstate, jl, tl = _drifted(name)
    ref = ja.drift_residual(jstate, js, layouts=jl, backend="segment_sum")
    out = ta.drift_residual(tstate, ts, layouts=tl)
    assert (out is None) == (ref is None) == (name == "hits")
    assert ta.drift_normalize == ja.drift_normalize
    assert ta.drift_contraction == ja.drift_contraction
    if ref is None:
        return
    assert float(out.sum()) > 0.0  # the burst left a residual
    _match(out, ref, name)
    # a [B, N] bank gives each row its own residual
    bank = {k: torch.stack([v, v]) for k, v in tstate.items()}
    rows = ta.drift_residual(bank, ts, layouts=tl)
    assert rows.shape == (2,) + out.shape
    for row in rows:
        _match(row, np.asarray(ref), name)


@pytest.mark.parametrize("name", ALGORITHMS)
def test_fused_step_drift_matches_reference(name):
    ja, ta, js, ts, jstate, tstate, jl, tl = _drifted(name)
    n = js.node_capacity
    rng = np.random.default_rng(5)
    deg_prev = np.asarray(js.out_deg) - (rng.random(n) < 0.1)
    active_prev = np.array(js.node_active)
    common = dict(hot_node_capacity=n, hot_edge_capacity=js.edge_capacity)
    _, jst = JF.fused_query_step(
        js, jstate, jnp.asarray(deg_prev, jnp.int32),
        jnp.asarray(active_prev), jnp.float32(0.2), jnp.float32(0.1),
        JC.default_probe_ids(n, 32), algo=ja, layouts=jl,
        backend="segment_sum", with_drift=True, **common)
    _, tst = TF.fused_query_step(
        ts, tstate, torch.from_numpy(deg_prev.astype(np.int32)),
        torch.from_numpy(active_prev), torch.tensor(0.2), torch.tensor(0.1),
        TC.default_probe_ids(n, 32), algo=ta, layouts=tl, with_drift=True,
        **common)
    assert int(tst.num_hot) == int(jst.num_hot)
    for k in ("drift_probe", "drift_cold"):
        np.testing.assert_allclose(float(getattr(tst, k)),
                                   float(getattr(jst, k)), **DRIFT_TOL)
    assert max(float(tst.drift_probe), float(tst.drift_cold)) > 0.0

    # the batched step: one pair per live slot, zeros on the vacant one
    jbank = {k: jnp.stack([v, v, v]) for k, v in jstate.items()}
    tbank = {k: torch.stack([v, v, v]) for k, v in tstate.items()}
    mask = np.array([True, False, True])
    jout = JF.fused_query_step_batched(
        js, jbank, jnp.asarray(deg_prev, jnp.int32), jnp.asarray(active_prev),
        jnp.float32(0.2), jnp.float32(0.1), jnp.asarray(mask), None,
        JC.default_probe_ids(n, 32), algo=ja, layouts=jl,
        backend="segment_sum", with_drift=True, **common)
    tout = TF.fused_query_step_batched(
        ts, tbank, torch.from_numpy(deg_prev.astype(np.int32)),
        torch.from_numpy(active_prev), torch.tensor(0.2), torch.tensor(0.1),
        torch.from_numpy(mask), probe_ids=TC.default_probe_ids(n, 32),
        algo=ta, layouts=tl, with_drift=True, **common)
    assert len(tout) == len(jout) == 4
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               **DRIFT_TOL)
    assert not tout[3][1].any()
    for k in ("drift_probe", "drift_cold"):
        np.testing.assert_allclose(float(getattr(tout[1], k)),
                                   float(getattr(jout[1], k)), **DRIFT_TOL)


# ---------------------------------------------------------------------------
# the loop through the front doors, against the JAX package's
# ---------------------------------------------------------------------------


def _assert_rows_match(rt, rj, where):
    for k in DECISIONS:
        assert getattr(rt, k) == getattr(rj, k), (where, k)
    np.testing.assert_allclose(rt.drift, rj.drift, **DRIFT_TOL,
                               err_msg=str(where))
    np.testing.assert_allclose(rt.quality_est, rj.quality_est, rtol=1e-4,
                               atol=1e-5, err_msg=str(where))


@pytest.mark.parametrize("name,target", [
    ("pagerank", 0.95), ("personalized-pagerank", 0.95), ("hits", 0.95),
    ("katz", 0.95), ("connected-components", 0.9), ("sssp", 0.9),
    ("widest-path", 0.9)])
def test_quality_session_replays_reference(name, target):
    n, m, steps, chunk = 400, 2_500, 6, 50
    src, dst = gnm_edges(n, m, seed=7)
    stream = _drifting_stream(n, steps, chunk)
    kw = dict(node_capacity=n, edge_capacity=m + steps * chunk + 512,
              quality_target=target, **PARAMS.get(name, {}))
    js = repro.session((src, dst), name, backend="segment_sum", **kw)
    ts = repro_torch.session((src, dst), name, device="cpu", **kw)
    assert ts.engine.controller.gain == js.engine.controller.gain
    for q, (a, b) in enumerate(stream):
        rj = js.add_edges(a, b).query()
        rt = ts.add_edges(a, b).query()
        _assert_rows_match(rt.stats, rj.stats, (name, q))
        if name in MIN_MAX:
            np.testing.assert_array_equal(rt.scores, rj.scores)
        else:
            np.testing.assert_allclose(rt.scores, rj.scores, **SUM_TOL)
    jc, tc = js.engine.controller, ts.engine.controller
    assert (tc.refreshes, tc.observations) == (jc.refreshes, jc.observations)
    assert tc.observations == steps


def _serving_mix(srv):
    tickets = [srv.submit("personalized-pagerank", seeds=(s,))
               for s in range(5)]
    tickets += [srv.submit("sssp", sources=(s,)) for s in range(3)]
    tickets += [srv.submit("hits"), srv.submit("katz", alpha=0.02),
                srv.submit("connected-components")]
    return tickets


def test_serve_session_under_controller_replays_reference():
    n, m = 150, 900
    src, dst = gnm_edges(n, m, seed=4)
    kw = dict(slots=3, quality_target=0.95, edge_capacity=4096)
    jsrv = repro.serve_session((src, dst), backend="segment_sum", **kw)
    tsrv = repro_torch.serve_session((src, dst), device="cpu", **kw)
    jt, tt = _serving_mix(jsrv), _serving_mix(tsrv)
    stream = _drifting_stream(n, 8, 40, seed=2)
    for a, b in stream:
        if not tsrv.pending:
            break
        jsrv.add_edges(a, b).step()
        tsrv.add_edges(a, b).step()
        assert tsrv.stats.refreshes == jsrv.stats.refreshes
        np.testing.assert_allclose(tsrv.stats.last_drift,
                                   jsrv.stats.last_drift, **DRIFT_TOL)
    jsrv.run()
    tsrv.run()
    assert tsrv.stats.waves == jsrv.stats.waves
    np.testing.assert_allclose(tsrv.stats.min_quality_est,
                               jsrv.stats.min_quality_est, rtol=1e-4,
                               atol=1e-5)
    for jl, tl in zip(jsrv._lanes.values(), tsrv._lanes.values()):
        jc, tc = jl.controller, tl.controller
        assert (tc.r_eff, tc.delta_eff, tc.refreshes, tc.observations) == (
            jc.r_eff, jc.delta_eff, jc.refreshes, jc.observations)
    for a, b in zip(tt, jt):
        assert a.done and b.done and a.waves_run == b.waves_run
        if a.algorithm in MIN_MAX:
            np.testing.assert_array_equal(a.result, np.asarray(b.result))
        else:
            np.testing.assert_allclose(a.result, np.asarray(b.result),
                                       **SUM_TOL)
    # each lane-wave of the log carries its slots' drift
    assert all(w.row_drift is not None and len(w.row_drift) == 3
               for w in tsrv.wave_log)
    jsrv.close()
    tsrv.close()


# ---------------------------------------------------------------------------
# the port's own loop
# ---------------------------------------------------------------------------


def test_knob_precedence_explicit_r_wins():
    src, dst = gnm_edges(200, 1200, seed=1)
    with repro_torch.session((src, dst), device="cpu", quality_target=0.95,
                             r=0.3, edge_capacity=4096) as s:
        ctl = s.engine.controller
        assert not ctl.adjust_r and ctl.adjust_delta
        for a, b in _drifting_stream(200, 3, 80):
            s.add_edges(a, b).query()
        assert ctl.r_eff == 0.3
        assert all(st.r_eff == 0.3 for st in s.stats_log[1:])
    with repro_torch.session((src, dst), device="cpu", quality_target=0.95,
                             delta=0.2, control_delta=True,
                             edge_capacity=4096) as s:
        ctl = s.engine.controller
        assert ctl.adjust_r and ctl.adjust_delta
    with repro_torch.serve_session((src, dst), device="cpu",
                                   quality_target=0.95, delta=0.2) as srv:
        srv.submit("sssp", sources=(0,))
        srv.run()
        (lane,) = srv._lanes.values()
        assert lane.controller.adjust_r and not lane.controller.adjust_delta


def test_quality_target_requires_fused():
    src, dst = gnm_edges(50, 200, seed=0)
    with pytest.raises(ValueError, match="quality_target requires"):
        repro_torch.session((src, dst), device="cpu", fused=False,
                            quality_target=0.95)


def test_exact_action_counts_as_refresh():
    src, dst = gnm_edges(100, 600, seed=2)
    actions = iter([Action.APPROXIMATE, Action.EXACT])
    with repro_torch.session((src, dst), device="cpu", quality_target=0.95,
                             edge_capacity=2048,
                             on_query=lambda q, v: next(actions)) as s:
        s.add_edges([1, 2], [3, 4]).query()
        s.engine.controller.accum = 0.123
        res = s.add_edges([5, 6], [7, 8]).query()
        assert res.stats.refreshed
        assert s.engine.controller.accum == 0.0


def test_algorithms_declare_contraction_and_engine_wires_it():
    src, dst = gnm_edges(120, 700, seed=2)
    caps = dict(node_capacity=120, edge_capacity=2048, device="cpu",
                quality_target=0.9)
    with repro_torch.session((src, dst), "sssp", **caps) as s:
        assert s.engine.controller.gain == 1.0
    with repro_torch.session((src, dst), "pagerank", **caps) as s:
        assert s.engine.controller.gain == 3.0
    with repro_torch.session((src, dst), "cc", **caps) as s:
        assert s.algorithm.drift_normalize == "count"


def test_slo_holds_on_a_drifting_stream():
    """quality_target=0.95 on a drifting stream: RBO against an exact
    replay stays >= the target, with less summarized work than the
    open-loop full-accuracy knobs."""
    n, m, steps, chunk = 600, 4_000, 4, 60
    src, dst = gnm_edges(n, m, seed=7)
    stream = _drifting_stream(n, steps, chunk)
    caps = dict(node_capacity=n, edge_capacity=m + steps * chunk + 1024,
                device="cpu")

    def replay(**kw):
        scores, work = [], []
        with repro_torch.session((src, dst), **caps, **kw) as s:
            for a, b in stream:
                st = s.add_edges(a, b).query().stats
                full = (st.action == "compute-exact" or st.overflow_fallback
                        or st.refreshed)
                work.append(st.num_edges if full else st.num_ek + st.num_eb)
                scores.append(s.scores)
        return scores, float(np.mean(work))

    exact, _ = replay(on_query=lambda qid, view: Action.EXACT)
    closed, w_closed = replay(quality_target=0.95)
    _, w_open = replay(r=0.0, delta=1e-6)
    quality = [rbo_from_scores(a.astype(np.float64), e.astype(np.float64),
                               depth=100) for a, e in zip(closed, exact)]
    assert min(quality) >= 0.95
    assert w_closed < w_open


def test_quiet_stream_relaxes_the_knobs():
    src, dst = gnm_edges(400, 2500, seed=13)
    with repro_torch.session((src, dst), device="cpu", quality_target=0.95,
                             node_capacity=400, edge_capacity=8192) as s:
        for a, b in _drifting_stream(400, 4, 120, seed=17):
            s.add_edges(a, b).query()
        r_tight = s.engine.controller.r_eff
        for _ in range(12):
            s.query()
        assert s.engine.controller.r_eff > r_tight
        assert s.stats_log[-1].drift < 1e-3


def test_serving_refresh_remarks_slots_cold():
    """A lane's breach re-marks its live slots cold and resets its loop;
    the long-running occupant still converges to the exact answer."""
    n = 64
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    srv = repro_torch.serve_session((src, dst), slots=2, device="cpu",
                                    quality_target=0.9999)
    far = srv.submit("sssp", sources=(0,), num_iters=2, max_waves=200)
    srv.step()
    assert not far.done
    (lane,) = srv._lanes.values()
    lane.controller.accum = 1.0
    srv.step()
    assert srv.stats.refreshes == 1 and srv.wave_log[-1].refreshed
    assert lane.controller.accum == 0.0
    assert srv.stats.min_quality_est < 1.0
    assert all(c for c, t in zip(lane.cold, lane.tickets) if t is not None)
    srv.run()
    assert far.done and far.converged
    assert float(far.result[n - 1]) == float(n - 1)
    srv.close()
