"""The port's mesh engine on four real ranks, through both front doors.

One ``torch.multiprocessing.spawn`` of four gloo ranks for the module (the
rank body is ``tests/_mesh_session_ranks.py::run``, which imports no JAX;
a ``file://`` store in the test's tmp dir): each rank builds the same
sessions from the same numpy edges on a 1-D ``("shards",)`` mesh of the
four ranks at eight edge shards, two a rank, and last one PageRank
session on a 2 x 2 ``("data", "model")`` mesh.  The scenarios mirror the
reference's multi-device tests (``tests/test_sharded.py``'s recut, recut
disabled and mesh-session tests, ``tests/test_serving.py``'s mesh serving
with ``shard_hot_edge_capacity``, ``tests/test_async_pipeline.py``'s
async mesh epochs) and the port's 1-rank ones
(``tests/test_torch_sharded.py``).

The oracle is the reference's meshless session (``backend=
"segment_sum"``; its own mesh path raises on this jax), or the port's
unsharded session where the reference has no counterpart (the async
session's answers, the serve session's tickets, the unfused engine).
Answers: integers and min/max bitwise, f32 sums at rtol 1e-5, atol 1e-6;
the action, hot-set and E_K sizes, epochs and layout builds equal.  Every
rank's answers and stats are bitwise every other rank's, since each
all-reduce hands every rank the same bits and every host decision (the
recut verdict, the power loop's step, the Δ-hop expansion, a wave's
reachability) is read from a result all ranks share.
"""

import pickle

import numpy as np
import pytest
import torch.multiprocessing as mp

import repro
from repro_torch.core.algorithm import available_algorithms
from repro_torch.core.semiring import resolve_semiring

import _mesh_session_ranks as R

TOL = dict(rtol=1e-5, atol=1e-6)
SEMIRING = {"pagerank": "plus_times", "personalized-pagerank": "plus_times",
            "katz": "plus_times", "hits": "plus_times",
            "sssp": "min_plus", "widest-path": "max_times",
            "connected-components": "min_min"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' pickled results (one spawn for the module)."""
    d = tmp_path_factory.mktemp("mesh_sessions")
    out = str(d / "res")
    mp.spawn(R.run, args=(f"file://{d / 'store'}", out), nprocs=R.WORLD,
             join=True)
    got = []
    for rank in range(R.WORLD):
        with open(f"{out}.{rank}", "rb") as f:
            got.append(pickle.load(f))
    return got


def _match(out, ref, semiring):
    """Bitwise, but for floats under a sum semiring (at ``TOL``)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if resolve_semiring(semiring).add == "sum" and out.dtype.kind == "f":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        np.testing.assert_array_equal(out, ref)


def _same(a, b, path="") -> None:
    """``a`` and ``b`` equal, arrays bit for bit, at every level."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b or (a != a and b != b), path


def _reference(src, dst, name, batches, **kw):
    """The reference's meshless session over ``batches``: per query its
    stats and scores, and its layout builds."""
    with repro.session((src, dst), algorithm=name, backend="segment_sum",
                       num_iters=R.NUM_ITERS, **R.PARAMS.get(name, {}),
                       **kw) as s:
        out = []
        for batch in batches:
            R.apply(s, batch)
            res = s.query()
            out.append((res.stats, np.asarray(res.scores)))
        return out, s.engine.layout_builds


def _hold(got, want, name, fields=("action", "num_hot", "num_ek")):
    """One rank's session (``R.drive``'s dict) against the reference's
    queries: the stats ``fields`` equal, the answers matched."""
    assert len(got["rows"]) == len(want)
    for q, (row, scores, (st, ref)) in enumerate(zip(
            got["rows"], got["scores"], want)):
        for f in fields:
            assert row[f] == getattr(st, f), (q, f)
        _match(scores, ref, SEMIRING[name])


def test_every_rank_answers_alike(ranks):
    answers = lambda res: {k: v for k, v in res.items() if k != "coordinate"}
    for res in ranks[1:]:
        _same(answers(res), answers(ranks[0]))


@pytest.mark.parametrize("name", sorted(available_algorithms()))
def test_mesh_session_matches_unsharded_reference(ranks, name):
    # adds, adds, then a removal batch: a query after each, on 8 shards
    # over 4 ranks
    src, dst = R.session_graph()
    got = ranks[0]["sessions"][name]
    want, builds = _reference(src, dst, name, R.session_batches(src, dst))
    _hold(got, want, name)
    assert got["rows"][2]["removals_resolved"] > 0
    assert got["rows"][2]["num_hot"] > 0
    assert got["layout_builds"] == builds
    # each rank holds two of the eight shards
    assert set(got["layouts"]) == {(R.SHARDS, R.SHARDS // R.WORLD)}


@pytest.mark.parametrize("async_rebuild", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("name", R.IMBALANCED)
def test_forced_imbalance_recuts_once(ranks, name, async_rebuild):
    # every live slot starts in the head shards: the first applied batch
    # trips exactly one recut, on the query where the 1-rank mesh has it
    # (sync: the query that applied it; async: its promotion)
    src, dst = R.gnm_edges(R.N, R.M, seed=31)
    got = ranks[0]["imbalance"][name, async_rebuild]
    want, _ = _reference(src, dst, name, R.imbalance_batches(),
                         edge_capacity=R.IMBALANCE_CAPACITY,
                         async_rebuild=async_rebuild)
    _hold(got, want, name, ("action", "num_hot", "num_ek", "epoch"))
    assert got["threshold"] == 1.0
    assert got["rebalances"] == 1
    assert [r["rebalanced"] for r in got["rows"]] == (
        [False, True, False] if async_rebuild else [True, False, False])
    assert got["last_imbalance"] < 1.0
    counts = got["live_counts"]
    assert counts.shape == (R.SHARDS,)
    assert counts.max() - counts.min() <= 1


def test_rebalance_threshold_none_keeps_the_cut(ranks):
    got = ranks[0]["no_rebalance"]
    assert not got["rows"][0]["rebalanced"]
    assert got["rebalances"] == 0 and not got["slots_recut"]


@pytest.mark.parametrize("name", R.IMBALANCED)
def test_async_mesh_session_matches_unsharded(ranks, name):
    # the epoch pipeline on the mesh engine: the port's unsharded async
    # session's epochs and answers, and the reference's async session's
    import repro_torch

    src, dst = R.gnm_edges(R.N, R.M, seed=12)
    got = ranks[0]["async"][name]
    with repro_torch.session((src, dst), name, device="cpu",
                             num_iters=R.NUM_ITERS, async_rebuild=True,
                             **R.PARAMS.get(name, {})) as s:
        port = R.drive(s, R.async_batches())
    for row, scores, prow, pscores in zip(got["rows"], got["scores"],
                                          port["rows"], port["scores"]):
        for f in ("action", "epoch", "snapshot_lag", "num_hot", "num_ek",
                  "pending_applied", "removals_resolved"):
            assert row[f] == prow[f], f
        _match(scores, pscores, SEMIRING[name])
    assert max(r["epoch"] for r in got["rows"]) == 3
    want, _ = _reference(src, dst, name, R.async_batches(),
                         async_rebuild=True)
    _hold(got, want, name, ("action", "epoch", "num_hot", "num_ek"))


def test_serve_session_on_mesh_matches_unsharded(ranks):
    want = R.serve_tickets()
    got = ranks[0]["serving"]
    for (name, _), (a, fa), (b, fb) in zip(R.SERVE_PLAN, want, got):
        assert fa == fb
        _match(b, a, SEMIRING[name])


def test_starved_buckets_fall_back_to_the_exact_answer(ranks):
    # the reference's test_serving_on_mesh_with_shard_capacity_knob: a
    # generous per-bucket capacity changes nothing, a starved one falls
    # back to the exact answer, which is right
    src, dst = R.gnm_edges(120, 700, seed=7)
    with repro.session((src, dst), "sssp", backend="segment_sum",
                       **R.TIGHT_SSSP) as ref:
        want = np.asarray(ref.query().scores)
    generous, starved = ranks[0]["tight_serving"]
    assert generous["done"] and not generous["exact_fallback"]
    assert starved["done"] and starved["exact_fallback"]
    assert starved["overflow_fallbacks"] >= 1
    for t in (generous, starved):
        np.testing.assert_array_equal(t["result"], want)


def test_unfused_and_starved_cc_on_mesh(ranks):
    # CC bitwise: the unfused engine on the mesh against the unfused
    # unsharded one, and starved buckets against the exact session
    import repro_torch

    src, dst, batches = R.unfused_graph()
    got = ranks[0]["unfused"]
    with repro_torch.session((src, dst), "connected-components",
                             device="cpu", num_iters=R.NUM_ITERS,
                             fused=False) as s:
        want = R.drive(s, batches)
    row, wrow = got["unfused"]["rows"][0], want["rows"][0]
    assert not row["overflow_fallback"] and row["num_ek"] > 0
    assert (row["num_hot"], row["num_ek"]) == (wrow["num_hot"],
                                               wrow["num_ek"])
    np.testing.assert_array_equal(got["unfused"]["scores"][0],
                                  want["scores"][0])
    tight = got["tight"]
    assert tight["rows"][0]["overflow_fallback"]
    assert tight["rows"][0]["num_ek"] > 0
    np.testing.assert_array_equal(tight["scores"][0],
                                  R.unsharded_exact_cc()["scores"][0])


def test_two_by_two_mesh_session_matches_reference(ranks):
    # the 1-D scenario's PageRank stream on a ("data", "model") mesh: its
    # eight shards over the four ranks of both dims flattened
    src, dst = R.session_graph()
    want, builds = _reference(src, dst, "pagerank",
                              R.session_batches(src, dst))
    for rank, res in enumerate(ranks):
        got = res["two_by_two"]
        assert res["coordinate"] == divmod(rank, 2)
        _hold(got, want, "pagerank")
        assert got["layout_builds"] == builds
        assert set(got["layouts"]) == {(R.SHARDS, R.SHARDS // R.WORLD)}
