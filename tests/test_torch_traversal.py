"""Parity of the port's traversal path (SSSP, widest path, connected
components) with the JAX package (``backend="segment_sum"``, no mesh).

Every input is made with numpy from a seed and handed to both packages.
Min and max give the same answer in any order, and ``+``/``×`` on one pair
of operands round the same way everywhere, so everything here is bitwise:
pushes, summaries (``b_in`` and ``ek_w`` included), sweep results and
iteration counts, and a session replayed query for query.

One difference is the reference's, not the port's: XLA on the CPU flushes
denormal f32 values to zero, while PyTorch (and the CUDA kernel, built
without ``-ftz``) keeps them.  The reduce test pins exactly that difference;
the other inputs stay clear of denormals.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro.core import backend as JB
from repro.core import hotset as JH
from repro.core import policies as jpolicies
from repro.core import traversal as JT
from repro.graph import graph as JG
from repro.stream import stream as jstream
import repro_torch
from repro_torch.convert import (edge_layout_from_numpy,
                                 graph_state_from_numpy,
                                 summary_buffers_from_numpy)
from repro_torch.core import backend as TB
from repro_torch.core import hotset as TH
from repro_torch.core import policies as tpolicies
from repro_torch.core import traversal as TT
from repro_torch.graph.generators import barabasi_albert_edges
from repro_torch.kernels.spmv.kernel import spmv_reduce_push_plain
from repro_torch.stream import StreamConfig, build_stream

# repro.core and repro_torch.core re-export the function `pagerank`,
# which shadows the module
JP = importlib.import_module("repro.core.pagerank")
TP = importlib.import_module("repro_torch.core.pagerank")

INT_MAX = np.iinfo(np.int32).max
SUMMARY_FIELDS = ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_w",
                  "ek_row_offsets", "num_ek", "b_in", "num_eb", "overflow")
STATS = ("action", "num_nodes", "num_edges", "num_hot", "num_kr", "num_kn",
         "num_kdelta", "num_ek", "num_eb", "iterations", "overflow_fallback",
         "pending_applied", "removals_requested", "removals_resolved")
#: (algorithm, semiring, summary weight) of the three workloads
WORKLOADS = {"sssp": ("min_plus", "length"),
             "widest-path": ("max_times", "length"),
             "connected-components": ("min_min", "unit")}


def _t(a):
    return torch.from_numpy(np.array(a))


def _lengths(semiring, e, seed):
    """Edge lengths for ``semiring``: distances in [0.5, 1.5) for
    ``min_plus``, reliabilities in (0.5, 1] for ``max_times`` (no denormal
    widths within the graphs' depth), none for ``min_min``."""
    rng = np.random.default_rng(seed)
    if semiring == "min_plus":
        return (0.5 + rng.random(e)).astype(np.float32)
    if semiring == "max_times":
        return (1.0 - 0.5 * rng.random(e)).astype(np.float32)
    return None


def _graphs(semiring, n=400, chunk=200, seed=11):
    """The same streamed graph in both packages: an initial graph with
    lengths and tombstones, then one chunk of additions with their own
    lengths.  Returns the JAX state before and after the chunk, the port's
    state after it, and the pre-chunk degree/activity snapshots."""
    src, dst = barabasi_albert_edges(n, 4, seed, 0.3)
    e_cap = src.shape[0] + 64
    lens = _lengths(semiring, src.shape[0], seed)

    def initial():
        js = JG.from_edges(src[:-chunk], dst[:-chunk], n, e_cap,
                           weights=None if lens is None else lens[:-chunk])
        slots = np.arange(0, src.shape[0] - chunk, 23, dtype=np.int32)
        return JG.remove_edges_by_slot(js, jnp.asarray(slots))

    js0 = initial()
    snap = (np.asarray(js0.out_deg), np.asarray(js0.node_active))
    # add_edges donates its input state, so it gets a copy of its own
    js = JG.add_edges(initial(), jnp.asarray(src[-chunk:]),
                      jnp.asarray(dst[-chunk:]),
                      None if lens is None else jnp.asarray(lens[-chunk:]))
    return js0, js, _port_state(js), snap


def _port_state(js):
    return graph_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu")


def _source_mask(n, sources=(0, 5)):
    m = np.zeros(n, bool)
    m[list(sources)] = True
    return m


def _same_bits(a, b, what=""):
    """Equal bit for bit (dtype included), NaN matching NaN."""
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=what)


# --------------------------------------------------------------------------
# The kernel's plain version and push
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op,mul,dt", [("min", "plus", np.float32),
                                       ("max", "times", np.float32),
                                       ("min", "min", np.int32)])
@pytest.mark.parametrize("masked", [False, True])
def test_reduce_plain_matches_segment_reduce(op, mul, dt, masked):
    rng = np.random.default_rng(3)
    counts = np.concatenate([[0, 1, 40, 0, 3], rng.integers(0, 9, 195)])
    ro = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    e, n_src = int(ro[-1]), 150
    src = rng.integers(0, n_src, e).astype(np.int32)
    if dt == np.int32:
        values = rng.integers(0, 500, n_src).astype(np.int32)
        values[::5] = INT_MAX
        w = np.where(rng.random(e) < 0.8, INT_MAX,
                     rng.integers(0, 500, e)).astype(np.int32)
    else:
        values = rng.random(n_src).astype(np.float32)
        values[::7] = np.inf if op == "min" else 0.0
        values[1::7] = -np.inf
        if mul == "times":
            values[2::7] = np.float32(1e-38)  # products become denormal
        w = (1.0 - rng.random(e)).astype(np.float32)
    mask = rng.random(e) < 0.6 if masked else None
    out = spmv_reduce_push_plain(
        _t(values), _t(src), _t(w), _t(ro),
        None if mask is None else _t(mask), op=op, mul=mul).numpy()
    contrib = (values[src] + w if mul == "plus" else values[src] * w
               if mul == "times" else np.minimum(values[src], w))
    if mask is not None:
        ident = INT_MAX if dt == np.int32 else (np.inf if op == "min"
                                                else -np.inf)
        contrib = np.where(mask, contrib, dt(ident))
    seg = np.repeat(np.arange(counts.shape[0]), counts).astype(np.int32)
    fn = jax.ops.segment_min if op == "min" else jax.ops.segment_max
    ref = np.asarray(fn(jnp.asarray(contrib), jnp.asarray(seg),
                        num_segments=counts.shape[0]))
    if mul == "times":
        # XLA on the CPU flushes denormals; the port keeps them
        tiny = (out != 0) & (np.abs(out) < np.finfo(np.float32).tiny)
        assert tiny.any()
        out = np.where(tiny, np.float32(0), out)
    _same_bits(out, ref)
    assert (out[counts == 0] == dt(INT_MAX if dt == np.int32 else
                                   np.inf if op == "min" else -np.inf)).all()


@pytest.mark.parametrize("semiring,weight,reverse", [
    ("min_plus", "length", False), ("max_times", "length", False),
    ("min_min", "unit", False), ("min_min", "unit", True),
])
def test_push_over_converted_layouts_bitwise(semiring, weight, reverse):
    _, js, ts, _ = _graphs(semiring)
    jl = JB.build_layout(js, weight=weight, reverse=reverse,
                         semiring=semiring)
    tl = edge_layout_from_numpy(
        {k: None if getattr(jl, k) is None else np.asarray(getattr(jl, k))
         for k in ("src", "dst", "weight", "valid", "row_offsets", "order",
                   "rank")},
        device="cpu", weight_mode=jl.weight_mode, reverse=jl.reverse,
        pad_chunk=jl.pad_chunk, semiring=jl.semiring)
    rng = np.random.default_rng(5)
    n = js.node_capacity
    if semiring == "min_min":
        v = rng.integers(0, n, n).astype(np.int32)
        v[::9] = INT_MAX
    else:
        v = rng.random(n).astype(np.float32)
        v[::9] = np.inf if semiring == "min_plus" else 0.0
    mask = rng.random(jl.dst.shape[0]) < 0.5
    for m in (None, mask):
        ref = JB.push(jnp.asarray(v), jl, semiring=semiring,
                      backend="segment_sum",
                      mask=None if m is None else jnp.asarray(m))
        out = TB.push(_t(v), tl, semiring=semiring,
                      mask=None if m is None else _t(m))
        _same_bits(out.numpy(), ref)
        # the port's own layout gives the same bits
        own = TB.build_layout(ts, weight=weight, reverse=reverse,
                              semiring=semiring)
        _same_bits(TB.push(_t(v), own, semiring=semiring,
                           mask=None if m is None else _t(m)).numpy(), ref)


# --------------------------------------------------------------------------
# Summaries and sweeps
# --------------------------------------------------------------------------


def _exact_reference(algo, js, sources=(0, 5), num_iters=30):
    n = js.node_capacity
    if algo == "connected-components":
        return JT.connected_components(js, num_iters=num_iters,
                                       backend="segment_sum")
    sweep = JT.sssp if algo == "sssp" else JT.widest_path
    return sweep(js, jnp.asarray(_source_mask(n, sources)),
                 num_iters=num_iters, backend="segment_sum")


def _hot(js0, js, prev, snap):
    """The JAX hot mask over the streamed chunk (r = 0.1, normalized)."""
    hot, _ = JH.select_hot_set(
        js, jnp.asarray(snap[0]), jnp.asarray(prev, jnp.float32),
        jnp.float32(0.1), jnp.float32(0.1), active_prev=jnp.asarray(snap[1]),
        normalize_scores=True)
    return np.asarray(hot)


def _summaries(algo, use_layout=True, caps=None, reverse=False):
    """The JAX summary of one streamed chunk (frozen from the pre-chunk
    exact result) and the port's summary of the same inputs."""
    semiring, weight = WORKLOADS[algo]
    js0, js, ts, snap = _graphs(semiring)
    # two sweeps short of converged, so the summarized sweep has work
    prev = np.asarray(_exact_reference(algo, js0, num_iters=2)[0])
    churn = (prev != 0).astype(np.float32)  # any non-trivial signal
    hot = _hot(js0, js, churn, snap)
    k_cap, h_cap = caps or (js.node_capacity, js.edge_capacity)
    kw = dict(hot_node_capacity=k_cap, hot_edge_capacity=h_cap,
              weight=weight, reverse=reverse, semiring=semiring)
    jl = (JB.build_layout(js, weight=weight, reverse=reverse,
                          semiring=semiring) if use_layout else None)
    tl = (TB.build_layout(ts, weight=weight, reverse=reverse,
                          semiring=semiring) if use_layout else None)
    jsum = JP.build_summary(js, jnp.asarray(prev), jnp.asarray(hot),
                            layout=jl, backend="segment_sum", **kw)
    tsum = TP.build_summary(ts, _t(prev), _t(hot), layout=tl, **kw)
    return js, ts, prev, hot, jsum, tsum


def _assert_summaries_equal(jsum, tsum):
    for k in SUMMARY_FIELDS:
        _same_bits(getattr(tsum, k).numpy(), getattr(jsum, k), k)
    assert (tsum.weight_mode, tsum.semiring) == (jsum.weight_mode,
                                                 jsum.semiring)


@pytest.mark.parametrize("algo,reverse", [
    ("sssp", False), ("widest-path", False),
    ("connected-components", False), ("connected-components", True),
])
@pytest.mark.parametrize("use_layout", [True, False])
def test_build_summary_matches_reference_bitwise(algo, reverse, use_layout):
    _, _, _, hot, jsum, tsum = _summaries(algo, use_layout, reverse=reverse)
    assert 0 < int(tsum.num_hot) < hot.shape[0]
    assert int(tsum.num_ek) > 0 and int(tsum.num_eb) > 0
    _assert_summaries_equal(jsum, tsum)


def _port_sweep(algo, ts, sources=(0, 5), warm=None, **kw):
    if algo == "connected-components":
        return TT.connected_components(ts, warm, **kw)
    sweep = TT.sssp if algo == "sssp" else TT.widest_path
    return sweep(ts, _t(_source_mask(ts.node_capacity, sources)), warm, **kw)


@pytest.mark.parametrize("algo", list(WORKLOADS))
def test_exact_sweeps_match_reference_bitwise(algo):
    semiring, weight = WORKLOADS[algo]
    js0, js, ts, _ = _graphs(semiring)
    ref, ref_it = _exact_reference(algo, js)
    out, it = _port_sweep(algo, ts)
    assert it == int(ref_it) > 1
    _same_bits(out.numpy(), ref)
    # warm start from the pre-chunk answer
    prev = np.asarray(_exact_reference(algo, js0)[0])
    if algo == "connected-components":
        ref, ref_it = JT.connected_components(js, jnp.asarray(prev),
                                              backend="segment_sum")
    else:
        sweep = JT.sssp if algo == "sssp" else JT.widest_path
        ref, ref_it = sweep(js, jnp.asarray(_source_mask(js.node_capacity)),
                            jnp.asarray(prev), backend="segment_sum")
    out, it = _port_sweep(algo, ts, warm=_t(prev))
    assert it == int(ref_it)
    _same_bits(out.numpy(), ref)
    # a budget cut short stops at it
    ref, ref_it = (JT.connected_components(js, num_iters=1,
                                           backend="segment_sum")
                   if algo == "connected-components" else
                   (JT.sssp if algo == "sssp" else JT.widest_path)(
                       js, jnp.asarray(_source_mask(js.node_capacity)),
                       num_iters=1, backend="segment_sum"))
    out, it = _port_sweep(algo, ts, num_iters=1)
    assert it == int(ref_it) == 1
    _same_bits(out.numpy(), ref)


@pytest.mark.parametrize("cached", ["fwd", "rev", "both"])
def test_cc_with_one_cached_layout_per_direction(cached):
    _, js, ts, _ = _graphs("min_min")
    ref, ref_it = JT.connected_components(js, backend="segment_sum")
    kw = {}
    if cached in ("fwd", "both"):
        kw["fwd_layout"] = TB.build_layout(ts, weight="unit",
                                           semiring="min_min")
    if cached in ("rev", "both"):
        kw["rev_layout"] = TB.build_layout(ts, weight="unit", reverse=True,
                                           semiring="min_min")
    TB.reset_trace_counts()
    out, it = TT.connected_components(ts, **kw)
    assert TB.trace_count("build_layout") == (cached != "both")
    assert it == int(ref_it)
    _same_bits(out.numpy(), ref)
    with pytest.raises(ValueError):
        TT.connected_components(ts, fwd_layout=kw.get("rev_layout") or
                                TB.build_layout(ts, weight="unit",
                                                reverse=True,
                                                semiring="min_min"))


def _summary_from_reference(jsum):
    return summary_buffers_from_numpy(
        {k: np.asarray(getattr(jsum, k)) for k in SUMMARY_FIELDS},
        device="cpu", weight_mode=jsum.weight_mode, semiring=jsum.semiring)


@pytest.mark.parametrize("algo", list(WORKLOADS))
@pytest.mark.parametrize("carried", [True, False])
def test_summarized_sweeps_match_reference_bitwise(algo, carried):
    """The port's summarized sweeps over the JAX summary carried across
    (``carried``) or over the port's own summary of the same inputs."""
    js, ts, prev, _, jsum, tsum = _summaries(algo)
    if algo == "connected-components":
        _, _, _, _, jrev, trev = _summaries(algo, reverse=True)
        ref, ref_it = JT.summarized_connected_components(
            jsum, jrev, jnp.asarray(prev), backend="segment_sum")
        if carried:
            tsum, trev = map(_summary_from_reference, (jsum, jrev))
        out, it = TT.summarized_connected_components(tsum, trev, _t(prev))
    else:
        mask = _source_mask(js.node_capacity)
        jfn, tfn = ((JT.summarized_sssp, TT.summarized_sssp)
                    if algo == "sssp" else
                    (JT.summarized_widest_path, TT.summarized_widest_path))
        ref, ref_it = jfn(jsum, jnp.asarray(prev), jnp.asarray(mask),
                          backend="segment_sum")
        if carried:
            tsum = _summary_from_reference(jsum)
        out, it = tfn(tsum, _t(prev), _t(mask))
    assert it == int(ref_it) > 1
    _same_bits(out.numpy(), ref)


def test_overflowing_summary_matches_reference():
    _, _, _, _, jsum, tsum = _summaries("sssp", caps=(30, 60))
    assert bool(tsum.overflow)
    _assert_summaries_equal(jsum, tsum)


def test_all_zero_churn_hot_set_matches_reference():
    """The first approximate query after an exact one that changed nothing
    sees an all-zero selection signal: the normalized Δ bound divides by
    the clamped zero total on both sides."""
    js0, js, ts, snap = _graphs("min_plus")
    zero = np.zeros(js.node_capacity, np.float32)
    for r in (0.1, 10.0):  # some degree changes, then none that count
        hot, st = JH.select_hot_set(
            js, jnp.asarray(snap[0]), jnp.asarray(zero), jnp.float32(r),
            jnp.float32(0.1), active_prev=jnp.asarray(snap[1]),
            normalize_scores=True)
        thot, tst = TH.select_hot_set(
            ts, _t(snap[0]), _t(zero), torch.tensor(r, dtype=torch.float32),
            torch.tensor(0.1, dtype=torch.float32), active_prev=_t(snap[1]),
            normalize_scores=True)
        _same_bits(thot.numpy(), hot)
        for k in ("num_hot", "num_kr", "num_kn", "num_kdelta"):
            assert int(getattr(tst, k)) == int(getattr(st, k)), k


# --------------------------------------------------------------------------
# Sessions
# --------------------------------------------------------------------------


def _policy(policies, action):
    """Repeat the last answer at query 1, exact every third query, else
    approximate: all three actions in five queries."""
    periodic = policies.periodic_exact(3)
    return lambda qid, view: (action.REPEAT_LAST if qid == 1
                              else periodic(qid, view))


def _assert_queries_equal(rj, rt, q):
    for k in STATS:
        assert getattr(rt.stats, k) == getattr(rj.stats, k), (q, k)
    _same_bits(rt.scores, rj.scores, f"query {q}")
    np.testing.assert_array_equal(rt.valid, rj.valid)
    np.testing.assert_array_equal(rt.top(20), rj.top(20))


def _sessions(algo, knobs, n=600):
    src, dst = barabasi_albert_edges(n, 4, 2, 0.3)
    cfg = dict(stream_size=600, num_queries=5)
    stream = build_stream(src, dst, StreamConfig(**cfg))
    kw = dict(knobs)
    if algo != "connected-components":
        kw["sources"] = (0, 3)
    js = repro.session(jstream.build_stream(src, dst, jstream.StreamConfig(
        **cfg)), algo, backend="segment_sum",
        on_query=_policy(jpolicies, repro.Action), **kw)
    ts = repro_torch.session(stream, algo, device="cpu",
                             on_query=_policy(tpolicies, repro_torch.Action),
                             **kw)
    return stream, js, ts


@pytest.mark.parametrize("algo", list(WORKLOADS))
@pytest.mark.parametrize("knobs", [
    dict(r=0.05),
    dict(fused=False, r=0.1, n=2),
    dict(hot_node_capacity=40, hot_edge_capacity=150, update_pad=100),
], ids=["fused", "unfused", "overflow"])
def test_session_replays_the_reference_query_for_query(algo, knobs):
    stream, js, ts = _sessions(algo, knobs)
    j0, t0 = js.stats_log[0], ts.stats_log[0]
    assert (j0.action, j0.iterations) == (t0.action, t0.iterations)
    _same_bits(ts.scores, js.scores, "initial exact")
    hot_queries = 0
    for q, (s, d) in enumerate(stream):
        for sess in (js, ts):
            sess.add_edges(s, d)
            if q == 2:  # removals too, one of which matches no edge
                sess.remove_edges(np.append(stream.init_src[1:21], 0),
                                  np.append(stream.init_dst[1:21], 0))
        rj, rt = js.query(), ts.query()
        _assert_queries_equal(rj, rt, q)
        hot_queries += rt.stats.num_ek > 0
    assert [st.action for st in ts.stats_log[1:]] == [
        "compute-approximate", "repeat-last-answer", "compute-approximate",
        "compute-exact", "compute-approximate"]
    overflow = any(st.overflow_fallback for st in ts.stats_log[1:])
    assert overflow == ("hot_node_capacity" in knobs)
    assert hot_queries > 0
    assert ts.engine.layout_builds == js.engine.layout_builds


@pytest.mark.parametrize("algo", ["sssp", "widest-path"])
def test_streamed_lengths_replay_the_reference(algo):
    """Lengths streamed through ``register_add_edges(weights=)`` reach
    every length layout and summary of both engines alike."""
    stream, js, ts = _sessions(algo, dict(r=0.05))
    semiring = WORKLOADS[algo][0]
    for q, (s, d) in enumerate(stream):
        lens = _lengths(semiring, s.shape[0], q)
        for sess in (js, ts):
            sess.engine.register_add_edges(s, d, weights=lens)
        rj, rt = js.query(), ts.query()
        _assert_queries_equal(rj, rt, q)
    assert ts.engine.state.edge_len is not None
    _same_bits(ts.engine.state.edge_len.numpy(), js.engine.state.edge_len)


def test_cc_session_builds_two_layouts_per_applied_batch():
    src, dst = barabasi_albert_edges(300, 3, 4, 0.3)
    e0 = src.shape[0] - 60
    ts = repro_torch.session((src[:e0], dst[:e0]), "cc", device="cpu",
                             r=0.05)
    for lo, repeat in ((e0, False), (e0 + 20, False), (e0 + 40, True)):
        TB.reset_trace_counts()
        ts.add_edges(src[lo:lo + 20], dst[lo:lo + 20])
        ts.query()
        assert TB.trace_count("build_layout") == 2
        if repeat:  # no pending update: the cached pair is reused
            ts.query()
            assert TB.trace_count("build_layout") == 2
    assert ts.engine.layout_builds == 4  # the initial exact + 3 batches
