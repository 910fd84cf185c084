"""The port's sharded graph engine against the JAX package, on the CPU.

The oracle has two parts.  The reference's meshless shard loop
(``repro.graph.partition.build_sharded_layout(..., num_shards=S)`` and the
push, summary and fused step over it, at ``backend="segment_sum"``) holds
the layouts, pushes and summaries; the unsharded reference session holds the
engine end to end.  The port's mesh is a ``torch.distributed`` 1-D
``DeviceMesh`` over gloo: one rank in this process for the sessions, and
two spawned ranks for the collective push and the summary's bucket
exchange.

The contract (the reference's ``tests/test_sharded.py``): layouts bitwise
(``order``, the partition certificate, and ``row_offsets`` included);
min/max pushes, integer and boolean outputs bitwise, f32 sums at rtol
1e-5, atol 1e-6; a bucket over its capacity raises ``overflow``; a
forced-imbalance stream trips exactly one recut to an assignment whose
live counts differ by at most 1.
"""

import pickle
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

import repro
import repro_torch
from repro.core import backend as JB
from repro.core.algorithm import make_algorithm as jmake
from repro.core.fused import fused_query_step as jfused
from repro.core.fused import fused_query_step_batched as jfused_batched
from repro.core.pagerank import build_summary as jbuild_summary
from repro.graph import from_edges as jfrom_edges
from repro.graph import partition as JP
from repro.graph.generators import gnm_edges
from repro_torch.core import backend as TB
from repro_torch.core.algorithm import available_algorithms
from repro_torch.core.algorithm import make_algorithm as tmake
from repro_torch.core.fused import fused_query_step as tfused
from repro_torch.core.fused import fused_query_step_batched as tfused_batched
from repro_torch.core.pagerank import build_summary as tbuild_summary
from repro_torch.core.semiring import resolve_semiring
from repro_torch.graph import partition as TP
from repro_torch.graph.graph import from_edges as tfrom_edges

TOL = dict(rtol=1e-5, atol=1e-6)

#: every registered semiring × a weight mode it supports
SEMIRING_WEIGHTS = [
    ("plus_times", "inv_out"),
    ("plus_times", "unit"),
    ("min_plus", "length"),
    ("min_min", "unit"),
    ("max_times", "unit"),
]
#: (weight, reverse, semiring) of every algorithm's summaries
SUMMARY_SPECS = [
    ("inv_out", False, "plus_times"),   # PageRank
    ("unit", False, "plus_times"),      # HITS forward / Katz
    ("unit", True, "plus_times"),       # HITS reverse
    ("unit", False, "min_min"),         # CC forward
    ("unit", True, "min_min"),          # CC reverse
    ("length", False, "min_plus"),      # SSSP
]
LAYOUT_FIELDS = ("src", "dst", "weight", "valid", "row_offsets", "order",
                 "rank")
SUMMARY_FIELDS = ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_w",
                  "ek_row_offsets", "num_ek", "num_eb", "overflow")
PARAMS = {"sssp": dict(sources=(0,)), "widest-path": dict(sources=(0,)),
          "personalized-pagerank": dict(seeds=(2,))}
SEMIRING = {"pagerank": "plus_times", "personalized-pagerank": "plus_times",
            "sssp": "min_plus", "connected-components": "min_min"}


@pytest.fixture(scope="module")
def mesh():
    """A 1-rank gloo mesh in this process (torn down with the module)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
    dist.destroy_process_group()


def _graphs(n=300, m=1500, seed=0, e_cap=None, lengths=False):
    """The same G(n, m) graph in both packages, with spare edge slots."""
    src, dst = gnm_edges(n, m, seed=seed)
    e_cap = e_cap or m + 64
    w = (np.random.default_rng(seed + 1).uniform(0.5, 2.0, m)
         .astype(np.float32) if lengths else None)
    return (jfrom_edges(src, dst, n, e_cap, weights=w),
            tfrom_edges(src, dst, n, e_cap, weights=w, device="cpu"))


def _values(semiring, n, seed=0, batch=None):
    s = resolve_semiring(semiring)
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    if np.issubdtype(s.np_dtype, np.floating):
        return rng.random(shape).astype(s.np_dtype)
    return rng.integers(0, n, shape).astype(s.np_dtype)


def _match(out, ref, semiring):
    """Bitwise, but for floats under a sum semiring (at ``TOL``)."""
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if resolve_semiring(semiring).add == "sum" and out.dtype.kind == "f":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("num_shards", [4, 8])
@pytest.mark.parametrize("semiring,weight", SEMIRING_WEIGHTS)
def test_sharded_layout_matches_reference(semiring, weight, num_shards):
    jg, tg = _graphs(seed=3, lengths=weight == "length")
    jl = JP.build_sharded_layout(jg, num_shards=num_shards, weight=weight,
                                 semiring=semiring)
    tl = TP.build_sharded_layout(tg, num_shards=num_shards, weight=weight,
                                 semiring=semiring)
    assert tl.num_shards == num_shards and tl.num_segments == 300
    for f in LAYOUT_FIELDS:
        a, b = getattr(jl, f), getattr(tl, f)
        if a is None:
            assert b is None, f
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    # the partition certificate: every live slot in exactly one shard
    order = tl.order.numpy()[tl.valid.numpy()]
    live = np.flatnonzero(tg.edge_mask().numpy())
    np.testing.assert_array_equal(np.sort(order), live)


# -------------------------------------------------------------------- pushes
@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batched"])
@pytest.mark.parametrize("semiring,weight", SEMIRING_WEIGHTS)
def test_sharded_push_matches_reference(semiring, weight, batch):
    jg, tg = _graphs(seed=5, lengths=weight == "length")
    x = _values(semiring, 300, seed=4, batch=batch)
    jl = JP.build_sharded_layout(jg, num_shards=8, weight=weight,
                                 semiring=semiring)
    tl = TP.build_sharded_layout(tg, num_shards=8, weight=weight,
                                 semiring=semiring)
    # batched rows against the reference's single push of each row
    want = np.stack([np.asarray(JB.push(jnp.asarray(row), jl,
                                        semiring=semiring,
                                        backend="segment_sum"))
                     for row in x.reshape(-1, 300)]).reshape(x.shape)
    _match(TB.push(torch.from_numpy(x), tl, semiring=semiring), want,
           semiring)
    # the unsharded push of the port agrees too (bitwise for min/max)
    flat = TB.build_layout(tg, weight=weight, semiring=semiring)
    _match(TB.push(torch.from_numpy(x), tl, semiring=semiring),
           TB.push(torch.from_numpy(x), flat, semiring=semiring), semiring)


def test_sharded_push_with_explicit_lengths_and_mask():
    jg, tg = _graphs(n=200, m=1200, seed=5)
    lengths = np.random.default_rng(6).uniform(
        0.5, 2.0, tg.edge_capacity).astype(np.float32)
    dist_v = _values("min_plus", 200, seed=7)
    kw = dict(weight="length", semiring="min_plus")
    jl = JP.build_sharded_layout(jg, num_shards=4, lengths=jnp.asarray(lengths),
                                 **kw)
    tl = TP.build_sharded_layout(tg, num_shards=4,
                                 lengths=torch.from_numpy(lengths), **kw)
    for mask_of in (lambda d: None, lambda d: d % 2 == 0):
        jm, tm = mask_of(jl.dst), mask_of(tl.dst)
        want = JB.push(jnp.asarray(dist_v), jl, semiring="min_plus", mask=jm,
                       backend="segment_sum")
        got = TB.push(torch.from_numpy(dist_v), tl, semiring="min_plus",
                      mask=tm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_push_guards(mesh):
    _, tg = _graphs(n=64, m=300, seed=8, e_cap=400)
    tl = TP.build_sharded_layout(tg, num_shards=4, weight="unit",
                                 semiring="min_min")
    with pytest.raises(ValueError, match="sharded layout built for"):
        TB.push(torch.ones(64), tl, semiring="plus_times")
    with pytest.raises(ValueError, match="mask must cover"):
        TB.push(torch.zeros(64, dtype=torch.int32), tl, semiring="min_min",
                mask=torch.ones(64, dtype=torch.bool))
    with pytest.raises(ValueError, match="not in mesh"):
        TP.build_sharded_layout(tg, mesh=mesh, axes=("bogus",))
    # a mesh layout is placed before a push or a summary takes it
    unplaced = TP.build_sharded_layout(tg, mesh=mesh, num_shards=4,
                                       weight="unit", semiring="min_min")
    with pytest.raises(ValueError, match="place_sharded_layout"):
        TB.push(torch.zeros(64, dtype=torch.int32), unplaced,
                semiring="min_min")
    with pytest.raises(ValueError, match="place_sharded_layout"):
        tbuild_summary(tg, torch.zeros(64, dtype=torch.int32),
                       torch.ones(64, dtype=torch.bool), hot_node_capacity=64,
                       hot_edge_capacity=400, weight="unit",
                       semiring="min_min", layout=unplaced)
    with pytest.raises(ValueError, match="mesh= or num_shards="):
        TP.build_sharded_layout(tg)
    with pytest.raises(ValueError, match="slots assignment shape"):
        TP.build_sharded_layout(tg, num_shards=4,
                                slots=torch.zeros(3, 100, dtype=torch.int32))
    # a multi-axis mesh: its axes flatten into one edge-shard axis (every
    # axis by default, or the ones named); an unnamed one has none to name
    mesh2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("a", "b"))
    for axes in (None, ("a", "b"), ("b",)):
        flat = TP.build_sharded_layout(tg, mesh=mesh2, axes=axes)
        assert flat.mesh.ndim == 1 and flat.num_shards == 1
    with pytest.raises(ValueError, match="mesh_dim_names"):
        TP.build_sharded_layout(tg, mesh=init_device_mesh("cpu", (1, 1)))


def test_mesh_layout_reduces_over_the_mesh(mesh):
    # a 1-rank mesh: every shard is this rank's, and the push meets in the
    # all-reduce over the mesh's process group
    _, tg = _graphs(seed=9)
    x = torch.from_numpy(_values("plus_times", 300, seed=1))
    tl = TP.place_sharded_layout(TP.build_sharded_layout(
        tg, mesh=mesh, num_shards=4, weight="inv_out"))
    assert tl.mesh is mesh and tl.axes == ("shards",)
    assert tl.num_shards == tl.src.shape[0] == 4
    loop = TP.build_sharded_layout(tg, num_shards=4, weight="inv_out")
    np.testing.assert_array_equal(TB.push(x, tl).numpy(),
                                  TB.push(x, loop).numpy())
    with pytest.raises(ValueError, match="multiple"):
        TP.build_sharded_layout(tg, mesh=mesh, num_shards=0)


# ----------------------------------------------------------------- summaries
@pytest.mark.parametrize("weight,reverse,semiring,batch", [
    *(spec + (None,) for spec in SUMMARY_SPECS),
    # a serving wave's [B, N] frozen vectors: b_in [B, K_cap]
    ("inv_out", False, "plus_times", 2), ("length", False, "min_plus", 2)])
def test_sharded_build_summary_matches_reference(weight, reverse, semiring,
                                                 batch):
    jg, tg = _graphs(n=280, m=1400, seed=21, lengths=weight == "length")
    x = _values(semiring, 280, seed=22, batch=batch)
    hot = np.random.default_rng(23).random(280) < 0.3
    caps = dict(hot_node_capacity=128, hot_edge_capacity=1024)
    kw = dict(weight=weight, reverse=reverse, semiring=semiring)
    want = jbuild_summary(
        jg, jnp.asarray(x), jnp.asarray(hot), **caps, **kw,
        layout=JP.build_sharded_layout(jg, num_shards=4, **kw))
    got = tbuild_summary(
        tg, torch.from_numpy(x), torch.from_numpy(hot), **caps, **kw,
        layout=TP.build_sharded_layout(tg, num_shards=4, **kw))
    assert got.sharded and got.num_shards == 4
    for f in SUMMARY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    _match(got.b_in, want.b_in, semiring)
    # the summarized push consumes the sharded summary per shard
    local = _values(semiring, 128, seed=24)
    _match(TB.push(torch.from_numpy(local),
                   TB.summary_layout(got, semiring=semiring),
                   semiring=semiring),
           JB.push(jnp.asarray(local), JB.summary_layout(want, semiring=semiring),
                   semiring=semiring, backend="segment_sum"), semiring)


def test_sharded_summary_bucket_overflow_flags():
    # a star whose edges all sit in the first slot shard and land on vertex
    # 0: one (source shard, bucket) block must carry every E_K edge
    n, m = 64, 20
    src = np.arange(1, m + 1, dtype=np.int32)
    dst = np.zeros(m, np.int32)
    jg = jfrom_edges(src, dst, n, 512)
    tg = tfrom_edges(src, dst, n, 512, device="cpu")
    hot, ranks = np.ones(n, bool), np.ones(n, np.float32)
    jl = JP.build_sharded_layout(jg, num_shards=8, weight="inv_out")
    tl = TP.build_sharded_layout(tg, num_shards=8, weight="inv_out")
    # H_cap = 64: a block holds ⌈64/8⌉ = 8 < 20, though |E_K| fits H_cap
    for h_cap, over in ((64, True), (8 * m, False)):
        kw = dict(hot_node_capacity=n, hot_edge_capacity=h_cap)
        want = jbuild_summary(jg, jnp.asarray(ranks), jnp.asarray(hot),
                              layout=jl, **kw)
        got = tbuild_summary(tg, torch.from_numpy(ranks),
                             torch.from_numpy(hot), layout=tl, **kw)
        assert bool(got.overflow) is over is bool(want.overflow)
        assert int(got.num_ek) == m
        for f in SUMMARY_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    # shard_bucket_capacity tightens C under the roomy H_cap: 4 slots a
    # block overflow, 20 hold the whole star
    for bucket, over in ((4, True), (m, False)):
        got = tbuild_summary(tg, torch.from_numpy(ranks),
                             torch.from_numpy(hot), layout=tl,
                             hot_node_capacity=n, hot_edge_capacity=8 * m,
                             shard_bucket_capacity=bucket)
        assert bool(got.overflow) is over
        assert got.ek_src.shape == (8, 8 * bucket)
        assert int(got.num_ek) == m and int(got.ek_row_offsets[0, -1]) == (
            min(bucket, m))
    with pytest.raises(ValueError, match="shard_bucket_capacity"):
        tbuild_summary(tg, torch.from_numpy(ranks), torch.from_numpy(hot),
                       layout=tl, hot_node_capacity=n, hot_edge_capacity=64,
                       shard_bucket_capacity=0)


# ----------------------------------------------------------- fused query step
def _algos(name, num_iters=8):
    """The algorithm in both packages, at ``num_iters``."""
    params = {**PARAMS, "personalized-pagerank": dict(seeds=(1, 5))}.get(
        name, {})
    return tuple(
        a.__class__(**{**{f: getattr(a, f) for f in a.__dataclass_fields__},
                       "num_iters": num_iters})
        for a in (jmake(name, **params), tmake(name, **params)))


@pytest.mark.parametrize("name", sorted(available_algorithms()))
def test_sharded_fused_query_step_matches_reference(name):
    # full hot coverage: the summarized answer is the exact one, so no
    # difference can hide behind the approximation
    jg, tg = _graphs(n=250, m=1500, seed=10)
    ja, ta = _algos(name)
    # one exact state (the port's; its parity is test_torch_algorithms')
    # fed to both
    tst, _ = ta.exact(ta.init_state(tg), tg)
    jst = {k: jnp.asarray(v.numpy()) for k, v in tst.items()}
    caps = dict(hot_node_capacity=250, hot_edge_capacity=tg.edge_capacity)
    specs = [JB.normalize_layout_spec(s) for s in ja.layout_specs]
    jl = tuple(JP.build_sharded_layout(jg, num_shards=8, weight=w,
                                       reverse=r, semiring=s)
               for w, r, s in specs)
    tl = tuple(TP.build_sharded_layout(tg, num_shards=8, weight=w,
                                       reverse=r, semiring=s)
               for w, r, s in specs)
    f32 = lambda v: (jnp.float32(v), torch.tensor(v, dtype=torch.float32))
    (jr, tr), (jd, td) = f32(0.0), f32(0.1)
    want, wstats = jfused(jg, jst, jnp.copy(jg.out_deg),
                          jnp.copy(jg.node_active), jr, jd, algo=ja,
                          layouts=jl, backend="segment_sum", **caps)
    got, gstats = tfused(tg, tst, tg.out_deg.clone(),
                         tg.node_active.clone(), tr, td, algo=ta,
                         layouts=tl, **caps)
    assert not bool(gstats.used_fallback) and not bool(wstats.used_fallback)
    for f in ("num_hot", "num_ek", "num_eb"):
        assert int(getattr(gstats, f)) == int(getattr(wstats, f)), f
    assert gstats.iterations == int(wstats.iterations)
    for k in want:
        _match(got[k], want[k], ja.semiring)


@pytest.mark.parametrize("name", ["pagerank", "connected-components"])
def test_fused_steps_build_their_mesh_layouts(mesh, name):
    # no cached layouts, a mesh: the single and the batched step build
    # their placed sharded layouts (one shard a rank, as the reference's
    # cache-less caller) and answer as the reference's meshless loop does
    # (a sum over one layout; min over a forward and a reverse one)
    jg, tg = _graphs(n=250, m=1500, seed=15)
    ja, ta = _algos(name)
    tst, _ = ta.exact(ta.init_state(tg), tg)
    jst = {k: jnp.asarray(v.numpy()) for k, v in tst.items()}
    caps = dict(hot_node_capacity=250, hot_edge_capacity=tg.edge_capacity)
    jl = tuple(JP.build_sharded_layout(jg, num_shards=1, weight=w,
                                       reverse=r, semiring=s)
               for w, r, s in map(JB.normalize_layout_spec,
                                  ja.layout_specs))
    jr, jd = jnp.float32(0.0), jnp.float32(0.1)
    tr, td = torch.tensor(0.0), torch.tensor(0.1)
    # every degree changed since the last query: every vertex is hot
    jdeg, tdeg = jnp.zeros_like(jg.out_deg), torch.zeros_like(tg.out_deg)
    want, wstats = jfused(jg, jst, jdeg,
                          jnp.copy(jg.node_active), jr, jd, algo=ja,
                          layouts=jl, backend="segment_sum", **caps)
    got, gstats = tfused(tg, tst, tdeg, tg.node_active.clone(),
                         tr, td, algo=ta, mesh=mesh, mesh_axes=("shards",),
                         **caps)
    assert int(gstats.num_ek) == int(wstats.num_ek) > 0
    for k in want:
        _match(got[k], want[k], ja.semiring)
    # a two-row wave of the same state, the second row frozen
    jbank = {k: jnp.stack([v, v]) for k, v in jst.items()}
    tbank = {k: torch.stack([v, v]) for k, v in tst.items()}
    live = np.array([True, False])
    want, wstats, wdelta = jfused_batched(
        jg, jbank, jdeg, jnp.copy(jg.node_active), jr, jd,
        jnp.asarray(live), algo=ja, layouts=jl, backend="segment_sum",
        **caps)
    got, gstats, gdelta = tfused_batched(
        tg, tbank, tdeg, tg.node_active.clone(), tr, td,
        torch.from_numpy(live), algo=ta, mesh=mesh, **caps)
    assert int(gstats.num_ek) == int(wstats.num_ek) > 0
    for k in want:
        _match(got[k], want[k], ja.semiring)
    _match(gdelta, wdelta, ja.semiring)


# ------------------------------------------------------------- rebalancing
def test_rebalance_decision_and_balanced_slots_match_reference():
    jg, tg = _graphs(n=120, m=700, seed=30, e_cap=4096)
    for s in (4, 8):
        jslots = JP.balanced_shard_slots(jg, num_shards=s)
        tslots = TP.balanced_shard_slots(tg, num_shards=s)
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        counts = TP.shard_live_counts(tg, tslots).numpy()
        assert counts.max() - counts.min() <= 1
        cut = TP.shard_slots(tg.edge_capacity, s)
        np.testing.assert_array_equal(cut, JP.shard_slots(jg.edge_capacity,
                                                          s))
        for slots in (cut, tslots.numpy()):
            jsh, jimb = JP.rebalance_decision(jg, jnp.asarray(slots),
                                              jnp.float32(1.0))
            tsh, timb = TP.rebalance_decision(tg, torch.from_numpy(slots),
                                              1.0)
            assert bool(tsh) == bool(jsh)
            np.testing.assert_array_equal(timb.numpy(), np.asarray(jimb))
            np.testing.assert_array_equal(
                TP.shard_live_counts(tg, torch.from_numpy(slots)).numpy(),
                np.asarray(JP.shard_live_counts(jg, jnp.asarray(slots))))
        # the recut layout pushes what the contiguous one does
        x = torch.from_numpy(_values("min_plus", 120, seed=2))
        kw = dict(num_shards=s, weight="length", semiring="min_plus")
        np.testing.assert_array_equal(
            TB.push(x, TP.build_sharded_layout(tg, slots=tslots, **kw),
                    semiring="min_plus").numpy(),
            TB.push(x, TP.build_sharded_layout(tg, **kw),
                    semiring="min_plus").numpy())
    assert TP.host_edge_slice(10, 3, 4) == JP.host_edge_slice(10, 3, 4)


@pytest.mark.parametrize("async_rebuild", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("name", ["sssp", "connected-components",
                                  "pagerank"])
def test_forced_imbalance_stream_triggers_rebalance(mesh, name,
                                                    async_rebuild):
    # a huge edge headroom puts every live slot in the head shards: the
    # first applied batch must trip exactly one recut to an even partition,
    # with answers equal to the unsharded reference session's
    src, dst = gnm_edges(220, 1300, seed=31)
    common = dict(num_iters=8, edge_capacity=16384, **PARAMS.get(name, {}))
    ref = repro.session((src, dst), algorithm=name, async_rebuild=async_rebuild,
                        **common)
    sh = repro_torch.session((src, dst), name, device="cpu", mesh=mesh,
                             num_shards=8, async_rebuild=async_rebuild,
                             **common)
    assert sh.engine.config.rebalance_threshold == 1.0  # on by default
    assert sh.engine.rebalances == 0
    semiring = sh.algorithm.semiring
    rebalanced = []
    for batch in ((np.arange(50), np.arange(50) + 100),
                  (np.arange(50) + 60, np.arange(50) + 30), None):
        for s in (ref, sh):
            if batch is not None:
                s.add_edges(*batch)
        want, got = ref.query(), sh.query()
        rebalanced.append(got.stats.rebalanced)
        assert got.stats.action == want.stats.action
        _match(got.scores, np.asarray(want.scores), semiring)
    assert sh.engine.rebalances == 1 and sum(rebalanced) == 1
    # sync: the batch of the query that applied it; async: its promotion
    assert rebalanced[1 if async_rebuild else 0]
    assert sh.engine.last_imbalance < 1.0
    counts = TP.shard_live_counts(sh.engine.state,
                                  sh.engine._shard_slots).numpy()
    assert counts.max() - counts.min() <= 1


def test_rebalance_disabled_and_threshold_none(mesh):
    src, dst = gnm_edges(150, 800, seed=32)
    with repro_torch.session((src, dst), "pagerank", device="cpu",
                             num_iters=6, edge_capacity=8192, mesh=mesh,
                             num_shards=8, rebalance_threshold=None) as s:
        s.add_edges([1, 2, 3], [4, 5, 6])
        assert not s.query().stats.rebalanced
        assert s.engine.rebalances == 0 and s.engine._shard_slots is None


def test_mesh_knob_checks(mesh):
    src, dst = gnm_edges(40, 150, seed=33)
    with pytest.raises(ValueError, match="num_shards requires mesh"):
        repro_torch.session((src, dst), device="cpu", num_shards=8)
    with pytest.raises(ValueError, match="positive multiple"):
        repro_torch.session((src, dst), device="cpu", mesh=mesh,
                            num_shards=0)
    # a card's mesh handed to a CPU engine
    with mock.patch.object(DeviceMesh, "device_type", "cuda"), \
            pytest.raises(ValueError, match="'cuda' mesh"):
        repro_torch.session((src, dst), device="cpu", mesh=mesh)
    # a mesh of more dims shards over their product; it needs dim names
    with pytest.raises(ValueError, match="mesh_dim_names"):
        repro_torch.session((src, dst), device="cpu",
                            mesh=init_device_mesh("cpu", (1, 1)))


# ----------------------------------------------------------------- sessions
@pytest.mark.parametrize("name", sorted(available_algorithms()))
def test_session_mesh_matches_unsharded_reference(mesh, name):
    src, dst = gnm_edges(220, 1300, seed=11)
    kw = dict(num_iters=8, **PARAMS.get(name, {}))
    ref = repro.session((src, dst), algorithm=name, **kw)
    sh = repro_torch.session((src, dst), name, device="cpu", mesh=mesh,
                             num_shards=4, **kw)
    lay = sh.engine.edge_layouts()[0]
    assert isinstance(lay, TB.ShardedEdgeLayout) and lay.num_shards == 4
    for batch in (([1, 2, 3, 7], [4, 5, 6, 9]), ([11, 12, 8, 0],
                                                 [14, 15, 2, 3])):
        for s in (ref, sh):
            s.add_edges(*batch)
        want, got = ref.query(), sh.query()
        assert got.stats.action == want.stats.action
        assert (got.stats.num_hot, got.stats.num_ek) == (want.stats.num_hot,
                                                          want.stats.num_ek)
        _match(got.scores, np.asarray(want.scores), sh.algorithm.semiring)
    assert sh.engine.layout_builds == ref.engine.layout_builds


def test_tight_buckets_and_unfused_mesh_sessions(mesh):
    # shard_hot_edge_capacity under the hot edges a bucket gets: the
    # overflow flag sends the query to the exact sweep; and the unfused
    # engine step on sharded layouts.  Each against the unsharded session,
    # bitwise (CC's labels)
    from repro_torch.core.algorithm import Action

    src, dst = gnm_edges(220, 1300, seed=14)
    kw = dict(num_iters=8, device="cpu")
    cc = "connected-components"
    exact = repro_torch.session((src, dst), cc,
                                on_query=lambda q, v: Action.EXACT, **kw)
    tight = repro_torch.session((src, dst), cc, mesh=mesh, num_shards=4,
                                shard_hot_edge_capacity=2, **kw)
    unfused = repro_torch.session((src, dst), cc, fused=False, **kw)
    unfused_sh = repro_torch.session((src, dst), cc, fused=False,
                                     mesh=mesh, num_shards=4, **kw)
    for s in (exact, tight, unfused, unfused_sh):
        s.add_edges(np.arange(40), np.arange(40) + 1)
    want, got = exact.query(), tight.query()
    assert got.stats.overflow_fallback and got.stats.num_ek > 0
    np.testing.assert_array_equal(got.scores, want.scores)
    want, got = unfused.query(), unfused_sh.query()
    assert not got.stats.overflow_fallback and got.stats.num_ek > 0
    assert (got.stats.num_hot, got.stats.num_ek) == (want.stats.num_hot,
                                                      want.stats.num_ek)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("name", ["pagerank", "sssp", "connected-components"])
def test_async_session_mesh_matches_unsharded(mesh, name):
    # the async epoch pipeline on a mesh engine: its answers are those of
    # the port's unsharded async session (bitwise for min/max)
    src, dst = gnm_edges(220, 1300, seed=12)
    kw = dict(num_iters=8, async_rebuild=True, device="cpu",
              **PARAMS.get(name, {}))
    un = repro_torch.session((src, dst), name, **kw)
    sh = repro_torch.session((src, dst), name, mesh=mesh, num_shards=4, **kw)
    for batch in (([1, 2, 3], [4, 5, 6]), ([9, 10], [11, 12]), None):
        for s in (un, sh):
            if batch is not None:
                s.add_edges(*batch)
        want, got = un.query(), sh.query()
        assert (got.stats.epoch, got.stats.num_ek) == (want.stats.epoch,
                                                       want.stats.num_ek)
        _match(got.scores, want.scores, sh.algorithm.semiring)


def test_serve_session_mesh_matches_unsharded(mesh):
    src, dst = gnm_edges(200, 1200, seed=13)
    plan = [("personalized-pagerank", dict(seeds=(3,))),
            ("sssp", dict(sources=(5,))), ("pagerank", {}),
            ("connected-components", {})]
    results = []
    for extra in ({}, dict(mesh=mesh, num_shards=4)):
        with repro_torch.serve_session((src, dst), device="cpu", slots=2,
                                       **extra) as srv:
            tickets = [srv.submit(n, **p) for n, p in plan]
            srv.add_edges([1, 2, 3], [7, 8, 9])
            srv.run()
            results.append([(t.result, t.exact_fallback) for t in tickets])
    for (name, _), (a, fa), (b, fb) in zip(plan, *results):
        assert fa == fb
        _match(b, a, SEMIRING[name])


# --------------------------------------------------------------- two ranks
def test_two_rank_push_and_summary_exchange(tmp_path):
    # two gloo ranks, two shards each: every rank's push is the all-reduced
    # whole, and its E_K rows after the all_to_all bucket exchange are the
    # reference's meshless shard loop's rows of its shards
    import _sharded_ranks as R

    out = str(tmp_path / "res")
    mp.spawn(R.run, args=(f"file://{tmp_path / 'store'}", out), nprocs=2,
             join=True)
    got = []
    for rank in (0, 1):
        with open(f"{out}.{rank}", "rb") as f:
            got.append(pickle.load(f))
    src, dst, lengths, x, hot = R.arrays()
    for weight, semiring in R.CASES:
        jg = jfrom_edges(src, dst, R.N, R.E_CAP,
                         weights=lengths if weight == "length" else None)
        jl = JP.build_sharded_layout(jg, num_shards=4, weight=weight,
                                     semiring=semiring)
        sm = jbuild_summary(jg, jnp.asarray(x), jnp.asarray(hot), **R.CAPS,
                            weight=weight, semiring=semiring, layout=jl)
        want = {"push": JB.push(jnp.asarray(x), jl, semiring=semiring,
                                backend="segment_sum"),
                **{f: getattr(sm, f) for f in R.SUMMARY_FIELDS}}
        assert np.asarray(want["ek_src"]).shape[0] == 4
        for rank in (0, 1):
            one = got[rank][semiring]
            assert one["rows"] == 2
            for f in ("push", "b_in"):
                _match(one[f], want[f], semiring)
            for f in R.SUMMARY_FIELDS[:-1]:
                w = np.asarray(want[f])
                if w.ndim == 2:  # this rank's two E_K shards
                    w = w[2 * rank:2 * rank + 2]
                np.testing.assert_array_equal(one[f], w, err_msg=f)


# ------------------------------------------------------- the 2-D mesh and DTensor
def test_two_by_two_mesh_push_matches_reference(tmp_path):
    # four gloo ranks on a 2 x 2 ("data", "model") mesh: the edge shards run
    # over both axes flattened, one a rank in row-major order; each rank's
    # rows are the reference's meshless shard loop's row at S = 4, and its
    # push the all-reduced whole
    import _sharded_ranks as R

    out = str(tmp_path / "res")
    mp.spawn(R.run_nd, args=(f"file://{tmp_path / 'store'}", out), nprocs=4,
             join=True)
    src, dst, lengths, x, _ = R.arrays()
    for rank in range(4):
        with open(f"{out}.{rank}", "rb") as f:
            got = pickle.load(f)
        assert tuple(got["coordinate"]) == divmod(rank, 2)
        for weight, semiring in R.CASES:
            jg = jfrom_edges(src, dst, R.N, R.E_CAP,
                             weights=lengths if weight == "length" else None)
            jl = JP.build_sharded_layout(jg, num_shards=4, weight=weight,
                                         semiring=semiring)
            one = got[semiring]
            assert one["num_shards"] == 4
            assert one["axes"] == ("data", "model")
            for f in R.LAYOUT_FIELDS:
                np.testing.assert_array_equal(
                    one[f], np.asarray(getattr(jl, f))[rank:rank + 1],
                    err_msg=f)
            _match(one["push"], JB.push(jnp.asarray(x), jl,
                                        semiring=semiring,
                                        backend="segment_sum"), semiring)


@pytest.mark.parametrize("batch", [2, 1])
def test_dtensor_steps_match_the_plain_steps(mesh, batch):
    # the dense smoke model's train, prefill and decode steps on DTensor
    # parameters and inputs over a 1 x 1 ("data", "model") mesh, under the
    # rules: bitwise the plain-tensor steps (every ws, per-shard region and
    # the vocab-sharded loss on the one rank's whole tensors); a batch of
    # one sits on the size-1 data axis, which splits nothing
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import param_pspecs_guarded
    from repro_torch.models.params import init_params
    from repro_torch.sharding import rules as TR
    from repro_torch.train import step as ST
    from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                             tree_leaves, tree_map)

    cfg = get_smoke_config("qwen2_0_5b")
    mesh2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    rules, sizes = TR.rules_for_mesh(mesh2), {"data": 1, "model": 1}
    pspecs = param_pspecs_guarded(cfg, rules, sizes)

    def dt(t, spec=()):
        return DTensor.from_local(t.clone(), mesh2,
                                  TR.to_placements(spec, mesh2))

    def dtree(tree, specs):
        return {k: dtree(v, specs[k]) if isinstance(v, dict) else
                dt(v, specs[k]) for k, v in tree.items()}

    def local(tree):
        return [t.to_local() if isinstance(t, DTensor) else t
                for t in tree_leaves(tree)]

    def same(a, b):
        a, b = local(a), local(b)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    ids = lambda *s: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, s).astype(np.int32))
    data = {"tokens": ids(batch, 32), "labels": ids(batch, 32)}
    bspec = {"tokens": ("data",), "labels": ("data",)}
    with TR.axis_rules(rules):
        # train: the donated step writes both states in place
        p_plain = tree_map(torch.clone, params)
        o_plain = adamw_init(p_plain)
        p_dt = dtree(params, pspecs)
        o_dt = AdamWState(dt(torch.zeros((), dtype=torch.int32)),
                          *(dtree(m, pspecs) for m in (o_plain.mu,
                                                       o_plain.nu)))
        train = ST.make_train_step(cfg)
        _, _, m_plain = train(p_plain, o_plain, data)
        _, _, m_dt = train(p_dt, o_dt, {k: dt(v, bspec[k])
                                        for k, v in data.items()})
        same(p_plain, p_dt)
        same([o_plain.mu, o_plain.nu], [o_dt.mu, o_dt.nu])
        same(m_plain, m_dt)
        # prefill, then one decode step from each path's own caches
        prefill = ST.make_prefill_step(cfg, cache_len=48)
        logits, cache = prefill(p_plain, {"tokens": data["tokens"]})
        logits_dt, cache_dt = prefill(
            p_dt, {"tokens": dt(data["tokens"], ("data",))})
        same([logits, cache], [logits_dt, cache_dt])
        serve = ST.make_serve_step(cfg)
        token, pos = ids(batch, 1), torch.tensor(32, dtype=torch.int32)
        logits, cache = serve(p_plain, cache, token, pos)
        logits_dt, cache_dt = serve(p_dt, cache_dt, dt(token, ("data",)),
                                    dt(pos))
        same([logits, cache], [logits_dt, cache_dt])

