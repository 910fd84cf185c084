"""The port's async rebuild (``EngineConfig.async_rebuild=True``): the
differential harness and the epoch invariants of
``tests/test_async_pipeline.py``, run on the port.

Every answer the async engine serves must equal what a synchronous oracle
engine computes when fed the same updates and queries aligned at the
served epoch: updates integrated at query q become visible at query q+1's
promotion, so the oracle receives epoch e's batches just before its first
query that serves epoch e.  The port's async engine runs the same torch
operations on the same inputs as its synchronous one, so the match is
bitwise for every case, sum algebras included.  Against the JAX package's
async session the answers hold rtol 1e-5 / atol 1e-7 for the sums and
are bitwise for the min/max workloads; epochs, fallbacks and refreshes
are equal.

Interleavings come from ``np.random.default_rng(seed)``: per query an
optional add batch, an optional remove batch riding it, and the OnQuery
action (approximate, exact or repeat-last).  The seven cases cover every
fused workload family, a tight-capacity case forcing the overflow
fallback, and a closed-loop case whose refreshes must replay too.

The invariants: (a) epoch ids monotone and ``snapshot_lag`` in {0, 1};
(b) a served snapshot's buffers and layouts unchanged while later epochs
build; (c) promotion never skips or overwrites a build; (d) drift
accumulated in epoch N is charged to epoch N's row, never to N+1; then
unresolved removals, the fused requirement and serving promotion.
"""

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core.algorithm import Action
from repro_torch.core.epoch import (AsyncRebuildPipeline, EpochSnapshot,
                                    snapshot_counts)
from repro_torch.graph import graph as G

N_CAP, E_CAP = 48, 768
H_NODE, H_EDGE = 40, 512
INIT_EDGES = 90
UPDATE_PAD = 8
QUERIES = 8

MIN_SEMIRINGS = ("min_plus", "min_min", "max_times")

CASES = {
    "pagerank": dict(algo="pagerank", kw={}),
    "ppr": dict(algo="personalized-pagerank", kw={"seeds": (2, 5)}),
    "sssp": dict(algo="sssp", kw={"sources": (0, 3)}),
    "cc": dict(algo="connected-components", kw={}),
    "widest": dict(algo="widest-path", kw={"sources": (1,)}),
    "pagerank-overflow": dict(algo="pagerank", kw={}, hot=(6, 12)),
    "sssp-quality": dict(algo="sssp", kw={"sources": (0,)}, quality=0.9),
}


def _common(case):
    hot_n, hot_e = case.get("hot", (H_NODE, H_EDGE))
    common = dict(node_capacity=N_CAP, edge_capacity=E_CAP,
                  hot_node_capacity=hot_n, hot_edge_capacity=hot_e,
                  update_pad=UPDATE_PAD, **case["kw"])
    if case.get("quality") is not None:
        common["quality_target"] = case["quality"]
    return common


def _port(case, src, dst, async_rebuild):
    return repro_torch.session((src, dst), case["algo"], device="cpu",
                               async_rebuild=async_rebuild, **_common(case))


def _reference(case, src, dst):
    return repro.session((src, dst), case["algo"], backend="segment_sum",
                         async_rebuild=True, **_common(case))


def _draw(seed):
    """The initial graph and one random interleaving (the reference
    harness's draw)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_CAP, INIT_EDGES).astype(np.int32)
    dst = rng.integers(0, N_CAP, INIT_EDGES).astype(np.int32)
    seen, live_edges = set(), []
    for s, d in zip(src.tolist(), dst.tolist()):
        if (s, d) not in seen:
            seen.add((s, d))
            live_edges.append((s, d))
    script = []
    for _ in range(QUERIES):
        adds, removes = [], []
        if rng.random() < 0.75:
            k = int(rng.choice([4, UPDATE_PAD]))
            adds.append((rng.integers(0, N_CAP, k).astype(np.int32),
                         rng.integers(0, N_CAP, k).astype(np.int32)))
            if live_edges and rng.random() < 0.5:
                take = min(4, len(live_edges))
                picks = [live_edges.pop(int(rng.integers(len(live_edges))))
                         for _ in range(take)]
                while len(picks) < 4:
                    picks.append(picks[-1])
                removes.append((np.asarray([p[0] for p in picks], np.int32),
                                np.asarray([p[1] for p in picks], np.int32)))
        action = [Action.APPROXIMATE, Action.APPROXIMATE, Action.APPROXIMATE,
                  Action.EXACT, Action.REPEAT_LAST][int(rng.integers(5))]
        script.append((adds, removes, action))
    return src, dst, script


def _run_async(engine, script, action=Action):
    """Drive an async engine through the script (``action`` is its
    package's Action enum); returns the served (scores, row) pairs and each
    epoch's update batch."""
    actions = [s[2] for s in script]
    engine._on_query = lambda qid, view: action(actions[qid].value)
    latest, epoch_batches, rows = 0, {}, []
    for adds, removes, _ in script:
        batch = []
        for a, b in adds:
            engine.register_add_edges(a, b)
            batch.append(("add", a, b))
        for a, b in removes:
            engine.register_remove_edges(a, b)
            batch.append(("rm", a, b))
        res, row = engine.query()
        served = latest
        if batch:
            latest += 1
            epoch_batches[latest] = batch
        assert row.epoch == served, (row.epoch, served)
        rows.append((np.array(res), row))
    return rows, epoch_batches


def _replay_oracle(engine, rows, epoch_batches, script):
    """The synchronous oracle fed each epoch's batches just before its
    first query serving that epoch; returns its (scores, row) pairs."""
    actions = [s[2] for s in script]
    engine._on_query = lambda qid, view: actions[qid]
    fed, out = 0, []
    for _, row in rows:
        while fed < row.epoch:
            fed += 1
            for kind, a, b in epoch_batches[fed]:
                if kind == "add":
                    engine.register_add_edges(a, b)
                else:
                    engine.register_remove_edges(a, b)
        out.append(engine.query())
    return out


# ---------------------------------------------------------------------------
# the differential harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case_name", sorted(CASES))
def test_async_engine_matches_sync_oracle_bitwise(case_name, seed):
    case = CASES[case_name]
    src, dst, script = _draw(seed)
    rows, batches = _run_async(_port(case, src, dst, True).engine, script)
    oracle = _replay_oracle(_port(case, src, dst, False).engine, rows,
                            batches, script)
    for q, ((res, row), (ref, ref_row)) in enumerate(zip(rows, oracle)):
        np.testing.assert_array_equal(
            res, ref, err_msg=f"query {q} (epoch {row.epoch}, {row.action})")
        assert row.overflow_fallback == ref_row.overflow_fallback
        assert row.refreshed == ref_row.refreshed
        assert row.drift == ref_row.drift
        assert row.iterations == ref_row.iterations
    if case_name == "pagerank-overflow":
        assert any(r.overflow_fallback for _, r in rows)


@pytest.mark.parametrize("case_name", sorted(CASES))
def test_async_engine_matches_reference_async_session(case_name):
    case = CASES[case_name]
    src, dst, script = _draw(3)
    port = _port(case, src, dst, True)
    ref = _reference(case, src, dst)
    rows, _ = _run_async(port.engine, script)
    ref_rows, _ = _run_async(ref.engine, script, repro.Action)
    bitwise = port.algorithm.semiring in MIN_SEMIRINGS
    for q, ((res, row), (jres, jrow)) in enumerate(zip(rows, ref_rows)):
        for k in ("action", "epoch", "snapshot_lag", "overflow_fallback",
                  "refreshed", "pending_applied", "removals_requested",
                  "removals_resolved", "num_nodes", "num_edges", "num_hot",
                  "num_ek"):
            assert getattr(row, k) == getattr(jrow, k), (q, k)
        if bitwise:
            np.testing.assert_array_equal(res, jres, err_msg=f"query {q}")
        else:
            np.testing.assert_allclose(res, jres, rtol=1e-5, atol=1e-7,
                                       err_msg=f"query {q}")
        np.testing.assert_allclose(row.drift, jrow.drift, rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the epoch invariants
# ---------------------------------------------------------------------------


def _started_async(seed=0, **over):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_CAP, INIT_EDGES).astype(np.int32)
    dst = rng.integers(0, N_CAP, INIT_EDGES).astype(np.int32)
    for k, v in dict(node_capacity=N_CAP, edge_capacity=E_CAP,
                     hot_node_capacity=H_NODE, hot_edge_capacity=H_EDGE,
                     update_pad=UPDATE_PAD).items():
        over.setdefault(k, v)
    return repro_torch.session((src, dst), "pagerank", device="cpu",
                               async_rebuild=True, **over), rng


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_epoch_ids_monotone_and_lag_bounded(seed):
    """(a) Epoch ids never decrease, advance by at most one a query, and
    snapshot_lag is 0 or 1; no buffered mutation, no new epoch."""
    s, rng = _started_async(seed)
    prev = 0
    for _ in range(10):
        if rng.random() < 0.7:
            s.engine.register_add_edges(
                rng.integers(0, N_CAP, UPDATE_PAD).astype(np.int32),
                rng.integers(0, N_CAP, UPDATE_PAD).astype(np.int32))
        _, row = s.engine.query()
        assert prev <= row.epoch <= prev + 1
        assert row.snapshot_lag in (0, 1)
        if row.pending_applied == 0 and row.epoch > 0:
            assert row.epoch == prev
        prev = row.epoch


def _frozen(snap, layouts):
    st = snap.state
    return {k: v.clone() for k, v in (
        ("src", st.src), ("dst", st.dst), ("alive", st.edge_alive),
        ("num_edges", st.num_edges), ("out_deg", st.out_deg),
        ("in_deg", st.in_deg), ("active_state", st.node_active),
        ("deg", snap.deg), ("active", snap.active),
        ("lay_dst", layouts[0].dst), ("lay_w", layouts[0].weight))}


def test_snapshot_immutable_while_next_epoch_builds():
    """(b) The served snapshot's graph buffers, baselines and layouts are
    unchanged while later epochs apply updates and build past it, and its
    layout cache never rebuilds."""
    s, rng = _started_async(3)
    eng = s.engine
    snap = eng._pipeline.current
    layouts = eng._snapshot_layouts(snap)
    frozen = _frozen(snap, layouts)
    for _ in range(4):
        eng.register_add_edges(
            rng.integers(0, N_CAP, UPDATE_PAD).astype(np.int32),
            rng.integers(0, N_CAP, UPDATE_PAD).astype(np.int32))
        eng.register_remove_edges(snap.state.src[:2].numpy().copy(),
                                  snap.state.dst[:2].numpy().copy())
        eng.query()
    for key, was in _frozen(snap, layouts).items():
        assert torch.equal(was, frozen[key]), key
    assert eng._snapshot_layouts(snap)[0] is layouts[0]
    # the live state moved on, into buffers of its own
    assert int(eng.state.num_edges) > int(snap.state.num_edges)
    assert eng.state.src.data_ptr() != snap.state.src.data_ptr()


def test_promotion_never_skips_or_overwrites_a_build():
    """(c) A dispatched build is promoted before the next dispatch, epoch
    ids are successors, and a drained stream has promotions ==
    dispatches."""
    state = G.from_edges(np.asarray([0, 1], np.int32),
                         np.asarray([1, 2], np.int32), 8, 16, device="cpu")

    def snap(epoch):
        return EpochSnapshot(epoch=epoch, state=state, deg=state.out_deg,
                             active=state.node_active,
                             counts=snapshot_counts(state))

    pipe = AsyncRebuildPipeline(snap(0))
    assert pipe.promote() is None
    pipe.dispatch(snap(1))
    assert pipe.snapshot_lag == 1
    with pytest.raises(RuntimeError, match="never +promoted"):
        pipe.dispatch(snap(2))
    promoted = pipe.promote()
    assert promoted is not None and promoted.epoch == 1
    assert pipe.current is promoted and pipe.snapshot_lag == 0
    with pytest.raises(RuntimeError, match="non-monotone"):
        pipe.dispatch(snap(3))
    pipe.dispatch(snap(2))
    pipe.promote()
    assert pipe.promotions == pipe.dispatches == 2
    assert snapshot_counts(state).tolist() == [3, 2]

    s, rng = _started_async(11)
    for _ in range(6):
        s.engine.register_add_edges(
            rng.integers(0, N_CAP, 4).astype(np.int32),
            rng.integers(0, N_CAP, 4).astype(np.int32))
        s.engine.query()
    s.engine.query()
    epipe = s.engine._pipeline
    assert epipe.building is None
    assert epipe.promotions == epipe.dispatches == epipe.current.epoch


def test_drift_charged_to_the_epoch_that_accumulated_it():
    """(d) The query that dispatches a burst still serves the quiet epoch
    with the quiet drift; the burst's churn lands on the next row, stamped
    with the next epoch."""
    s, rng = _started_async(5, quality_target=0.9)
    eng = s.engine
    quiet = [eng.query()[1] for _ in range(3)][-1]
    assert quiet.epoch == 0 and quiet.pending_applied == 0
    burst = 4 * UPDATE_PAD
    eng.register_add_edges(rng.integers(0, N_CAP, burst).astype(np.int32),
                           rng.integers(0, N_CAP, burst).astype(np.int32))
    _, dispatch_row = eng.query()
    _, visible_row = eng.query()
    assert dispatch_row.epoch == quiet.epoch
    assert visible_row.epoch == quiet.epoch + 1
    assert visible_row.pending_applied == burst
    assert dispatch_row.drift == pytest.approx(quiet.drift, abs=1e-6)
    assert not dispatch_row.refreshed
    assert visible_row.refreshed or visible_row.drift > dispatch_row.drift


def test_unresolved_removals_report_on_the_current_row():
    """A removal batch matching no live edge mutates nothing: no epoch is
    dispatched and the request shows on the row that processed it."""
    s, _ = _started_async(9)
    s.engine.register_remove_edges(np.asarray([N_CAP - 1] * 4, np.int32),
                                   np.asarray([N_CAP - 1] * 4, np.int32))
    _, row = s.engine.query()
    assert row.epoch == 0 and row.removals_requested == 4
    assert s.engine._pipeline.building is None
    assert s.engine.query()[1].epoch == 0


def test_async_requires_fused_path():
    with pytest.raises(ValueError, match="async_rebuild requires"):
        _started_async(0, fused=False)


# ---------------------------------------------------------------------------
# serving: the wave loop on the same pipeline
# ---------------------------------------------------------------------------


def _serve(async_rebuild, jax=False):
    rng = np.random.default_rng(0)
    src = rng.integers(0, N_CAP, INIT_EDGES).astype(np.int32)
    dst = rng.integers(0, N_CAP, INIT_EDGES).astype(np.int32)
    kw = dict(slots=2, node_capacity=N_CAP, edge_capacity=E_CAP,
              hot_node_capacity=H_NODE, hot_edge_capacity=H_EDGE,
              update_pad=UPDATE_PAD, async_rebuild=async_rebuild)
    if jax:
        return repro.serve_session((src, dst), backend="segment_sum",
                                   **kw), rng
    return repro_torch.serve_session((src, dst), device="cpu", **kw), rng


def test_serving_waves_promote_at_boundaries_and_match_semantics():
    """Whole waves serve one snapshot: updates buffered before a wave are
    visible one wave later; ServeStats' epoch/lag track the pipeline; each
    answer equals a synchronous serving run fed the updates one wave later,
    and the JAX package's async serving run."""
    srv, rng = _serve(True)
    jsrv, _ = _serve(True, jax=True)
    sync, _ = _serve(False)
    chunk = (rng.integers(0, N_CAP, UPDATE_PAD).astype(np.int32),
             rng.integers(0, N_CAP, UPDATE_PAD).astype(np.int32))
    t0, j0, u0 = (x.submit("personalized-pagerank", seeds=(3,))
                  for x in (srv, jsrv, sync))
    for x in (srv, jsrv, sync):
        x.step()
    assert t0.done and srv.stats.epoch == 0 and srv.stats.snapshot_lag == 0
    srv.add_edges(*chunk)
    jsrv.add_edges(*chunk)
    t1, j1, u1 = (x.submit("personalized-pagerank", seeds=(3,))
                  for x in (srv, jsrv, sync))
    for x in (srv, jsrv, sync):
        x.step()  # the async ones dispatched the build, served epoch 0
    assert t1.done and srv.stats.epoch == 0 and srv.stats.snapshot_lag == 1
    np.testing.assert_array_equal(t0.result, t1.result)
    sync.add_edges(*chunk)  # the oracle sees the chunk one wave later
    t2, j2, u2 = (x.submit("personalized-pagerank", seeds=(3,))
                  for x in (srv, jsrv, sync))
    for x in (srv, jsrv, sync):
        x.step()  # the promotion boundary: the updates are visible
    assert t2.done and srv.stats.epoch == 1 and srv.stats.snapshot_lag == 0
    assert not np.array_equal(t1.result, t2.result)
    assert (jsrv.stats.epoch, jsrv.stats.snapshot_lag) == (1, 0)
    for t, j, u in ((t0, j0, u0), (t1, j1, u1), (t2, j2, u2)):
        np.testing.assert_array_equal(t.result, u.result)
        np.testing.assert_allclose(t.result, np.asarray(j.result),
                                   rtol=1e-5, atol=1e-7)
    # the lanes' specs are registered: the next epoch sorts them at build
    assert srv.engine._async_specs
    srv.add_edges(*chunk)
    srv.submit("sssp", sources=(0,))
    srv.step()
    building = srv.engine._pipeline.building
    assert set(srv.engine._async_specs) <= set(building.layouts)
