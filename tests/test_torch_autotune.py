"""The port's narrow edge weights, merge-tile tuner and push roofline
against the JAX package.

Narrow weights: a bf16/f16 push replays the reference's ``segment_sum``
backend at rtol = atol = 1e-6 (both widen the same bf16 weights exactly and
accumulate in f32), and a bf16 PageRank session query for query at the
session tolerance of tests/test_torch_session.py, 1e-5: XLA's segment sum
and ``index_add_`` add in other orders, which moves ranks of ~137 by 2e-6
relative over 30 iterations, in f32 as in bf16; ``min_plus`` over lengths
that bf16 holds exactly is bitwise the f32 push and session.  The tuner's
bookkeeping (modes, cache, key strings) follows the reference's; its cost
model is the card's, checked against its own definition and the committed
roofline baseline.  Timing runs only on the card, so the ``full`` mode is
driven here through a timing stub.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
import repro_torch
from repro.core import backend as JB
from repro.graph import graph as JG
from repro.kernels.spmv import autotune as JAT
from repro.stream import stream as jstream
from repro_torch.core import backend as TB
from repro_torch.graph import graph as TG
from repro_torch.graph.generators import barabasi_albert_edges, gnm_edges
from repro_torch.kernels.spmv import autotune as AT
from repro_torch.kernels.spmv.kernel import DEFAULT_TILE, TILES
from repro_torch.launch import roofline as RL
from repro_torch.stream import StreamConfig, build_stream

TOL = dict(rtol=1e-6, atol=1e-6)
SESSION_TOL = dict(rtol=1e-5, atol=1e-5)
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _fresh_cache():
    AT.clear_cache()
    yield
    AT.clear_cache()


def _graphs(lengths=None, n=300, m=3):
    src, dst = barabasi_albert_edges(n, m, 7, 0.3)
    n_cap, e_cap = n + 20, src.shape[0] + 150
    w = None if lengths is None else lengths(src.shape[0])
    return (JG.from_edges(src, dst, n_cap, e_cap, weights=w),
            TG.from_edges(src, dst, n_cap, e_cap, weights=w, device="cpu"),
            n_cap)


# ---------------------------------------------------------- narrow pushes
@pytest.mark.parametrize("weight_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("masked", [False, True])
def test_narrow_plus_times_push_matches_reference(weight_dtype, masked):
    js, ts, n = _graphs()
    jl = JB.build_layout(js, weight="inv_out", weight_dtype=weight_dtype)
    tl = TB.build_layout(ts, weight="inv_out", weight_dtype=weight_dtype)
    assert str(tl.weight.dtype) == f"torch.{weight_dtype}"
    np.testing.assert_array_equal(
        np.asarray(jl.weight.astype(jnp.float32)), tl.weight.float().numpy())
    v = np.random.default_rng(1).random(n).astype(np.float32)
    mask = (np.random.default_rng(2).random(tl.src.shape[0]) < 0.5
            if masked else None)
    want = JB.push(jnp.asarray(v), jl, backend="segment_sum",
                   mask=None if mask is None else jnp.asarray(mask))
    got = TB.push(torch.from_numpy(v), tl,
                  mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("semiring", ["min_plus", "max_times"])
def test_narrow_min_max_push_bitwise_for_representable_lengths(semiring):
    rng = np.random.default_rng(7)
    lengths = lambda e: rng.choice([0.25, 0.5, 1.0, 2.0],
                                   e).astype(np.float32)
    js, ts, n = _graphs(lengths)
    v = (10 * np.random.default_rng(9).random(n)).astype(np.float32)
    outs = []
    for wd in (None, "bfloat16", "float16"):
        jl = JB.build_layout(js, weight="length", semiring=semiring,
                             weight_dtype=wd)
        tl = TB.build_layout(ts, weight="length", semiring=semiring,
                             weight_dtype=wd)
        want = np.asarray(JB.push(jnp.asarray(v), jl, semiring=semiring,
                                  backend="segment_sum"))
        got = TB.push(torch.from_numpy(v), tl, semiring=semiring).numpy()
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])


def test_narrow_weights_rejected_for_min_min_and_skipped_by_the_engine():
    js, ts, _ = _graphs()
    for build, g in ((JB.build_layout, js), (TB.build_layout, ts)):
        with pytest.raises(ValueError, match="weight_dtype"):
            build(g, weight="unit", semiring="min_min",
                  weight_dtype="bfloat16")
    src, dst = barabasi_albert_edges(200, 2, 0, 0.3)
    cc = repro_torch.session((src, dst), "cc", device="cpu",
                             weight_dtype="bfloat16")
    ref = repro.session((src, dst), "cc", backend="segment_sum",
                        weight_dtype="bfloat16")
    assert all(lay.weight.dtype == torch.int32
               for lay in cc.engine.edge_layouts())
    assert cc.engine._weight_dtype_for("min_min") is None
    assert cc.engine._weight_dtype_for("plus_times") == "bfloat16"
    np.testing.assert_array_equal(cc.query().scores, ref.query().scores)


def _replay_pagerank(knobs, queries=4):
    src, dst = barabasi_albert_edges(1500, 4, 0, 0.3)
    cfg = dict(stream_size=1500, num_queries=queries)
    js = repro.session(jstream.build_stream(
        src, dst, jstream.StreamConfig(**cfg)), backend="segment_sum",
        **knobs)
    stream = build_stream(src, dst, StreamConfig(**cfg))
    ts = repro_torch.session(stream, device="cpu", **knobs)
    np.testing.assert_allclose(ts.scores, js.scores, **SESSION_TOL)
    for q, (s, d) in enumerate(stream):
        js.add_edges(s, d)
        ts.add_edges(s, d)
        rj, rt = js.query(), ts.query()
        for k in ("action", "num_hot", "num_ek", "num_eb", "iterations"):
            assert getattr(rt.stats, k) == getattr(rj.stats, k), (q, k)
        np.testing.assert_allclose(rt.scores, rj.scores, **SESSION_TOL)
    return ts, js


def test_bf16_pagerank_session_replays_the_reference():
    ts, js = _replay_pagerank(dict(weight_dtype="bfloat16",
                                   autotune="cached"))
    (layout,) = ts.engine.edge_layouts()
    assert layout.weight.dtype == torch.bfloat16
    assert layout.merge_tile == DEFAULT_TILE  # a "cpu" key
    assert ts.engine.autotune_runs == 0


def test_bf16_sssp_session_is_bitwise_the_f32_session():
    """SSSP over streamed lengths that bf16 holds exactly: the bf16 session
    is bitwise the f32 one and the reference's f32 session.  (The
    reference's own bf16 SSSP session stops at its first summary: jax
    0.9's strict scatter refuses ``.at[].set`` of the bf16 lengths into f32,
    ``repro/core/pagerank.py:550``; the port casts them.)"""
    src, dst = gnm_edges(400, 2400, seed=3)
    lengths = np.random.default_rng(4).choice(
        [0.5, 1.0, 1.5, 3.0], src.shape[0]).astype(np.float32)
    stream = build_stream(src, dst, StreamConfig(stream_size=400,
                                                 num_queries=3))
    init = (stream.init_src, stream.init_dst)
    runs = []
    for make, wd in ((repro_torch.session, None),
                     (repro_torch.session, "bfloat16"),
                     (repro.session, None)):
        kw = (dict(device="cpu") if make is repro_torch.session
              else dict(backend="segment_sum"))
        s = make(init, "sssp", sources=(0,), r=0.05, weight_dtype=wd,
                 autotune="cached", node_capacity=400, edge_capacity=3000,
                 **kw)
        out = [np.asarray(s.scores).copy()]
        for q, (a, b) in enumerate(stream):
            s.engine.register_add_edges(
                a, b, lengths[q * len(a):(q + 1) * len(a)])
            out.append(np.asarray(s.query().scores))
        if wd:
            (layout,) = s.engine.edge_layouts()
            assert layout.weight.dtype == torch.bfloat16
        runs.append(out)
    for f32, bf16, ref in zip(*runs):
        np.testing.assert_array_equal(bf16, f32)
        np.testing.assert_array_equal(bf16, ref)
    assert np.isfinite(runs[0][-1]).sum() > 100


# ------------------------------------------------------- session threading
SAMPLE = ("src", "w", "row_offsets")  # what the timing stubs are handed


def test_sessions_thread_the_tuned_tile(monkeypatch, tmp_path):
    """With a card's key (the platform patched in), ``cached`` stamps a
    loaded tile on every full layout while the E_K layouts keep the
    default; ``full`` times every tile once per key (a stub here) on the
    first layout built for it, and reuses the winner."""
    from repro_torch.core import backend as B

    monkeypatch.setattr(AT, "platform_of", lambda device: H100)
    timed, samples = [], []
    monkeypatch.setattr(AT, "_time_candidate", lambda key, tile, *, sample: (
        timed.append(tile) or samples.append(sample) or tile))
    src, dst = gnm_edges(256, 1200, seed=11)
    caps = dict(node_capacity=256, edge_capacity=1536, hot_node_capacity=256,
                hot_edge_capacity=1536)
    key = AT.TuneKey(1536, 256, 1, "float32", "sum", H100, 2)
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"version": 1,
                                "entries": {key.as_str(): 768}}))
    assert AT.load_cache(path) == 1
    sess = repro_torch.session((src, dst), device="cpu", autotune="cached",
                               weight_dtype="bfloat16", **caps)
    (layout,) = sess.engine.edge_layouts()
    assert layout.merge_tile == 768 == AT.tune_for_push(
        edge_capacity=1536, num_segments=256, weight_dtype="bfloat16",
        mode="cached", device="cpu")
    assert sess.engine.autotune_runs == 0 and not timed
    summaries = []
    real = B.summary_layout
    monkeypatch.setattr(B, "summary_layout", lambda summary, **kw: (
        summaries.append(real(summary, **kw)) or summaries[-1]))
    sess.add_edges(src[:40], dst[:40]).query()
    assert summaries and {s.merge_tile for s in summaries} == {None}

    AT.clear_cache()
    full = repro_torch.session((src, dst), device="cpu", autotune="full",
                               **caps)
    assert full.engine.autotune_runs == 1 and timed == list(TILES)
    (layout,) = full.engine.edge_layouts()
    assert layout.merge_tile == min(timed)
    # timed on a layout of the key's shape: the first one built for it
    assert all(smp[0].shape == layout.src.shape
               and smp[2].shape == layout.row_offsets.shape
               for smp in samples)
    with repro_torch.serve_session((src, dst), device="cpu",
                                   node_capacity=256, edge_capacity=1536,
                                   hot_node_capacity=256,
                                   hot_edge_capacity=1536, slots=3,
                                   autotune="full") as srv:
        t = srv.submit("sssp", sources=(0,))
        srv.run()
        assert t.done and srv.engine.autotune_batch_hint == 3
    # one more timed key per lane semiring at B = 3; a second session
    # replays the cached winners without timing
    runs = AT.run_count()
    assert runs >= 2
    again = repro_torch.session((src, dst), device="cpu", node_capacity=256,
                                edge_capacity=1536, hot_node_capacity=256,
                                hot_edge_capacity=1536, autotune="full")
    assert AT.run_count() == runs
    assert again.engine.edge_layouts()[0].merge_tile == min(TILES)


def test_async_builds_take_tiles_resolved_before_them(monkeypatch):
    monkeypatch.setattr(AT, "platform_of", lambda device: H100)
    samples = []
    monkeypatch.setattr(AT, "_time_candidate", lambda key, tile, *, sample: (
        samples.append(sample) or tile))
    src, dst = gnm_edges(256, 1200, seed=12)
    s = repro_torch.session((src, dst), device="cpu", autotune="full",
                            async_rebuild=True)
    runs = AT.run_count()
    for q in range(3):
        s.add_edges(src[q * 10:(q + 1) * 10], dst[q * 10:(q + 1) * 10])
        s.query()
    assert AT.run_count() == runs
    tiles = {lay.merge_tile for lay in s.engine._pipeline.current.layouts
             .values()}
    assert tiles == {min(TILES)}
    # a key not resolved when a build is dispatched is timed before it, on
    # the layout of the snapshot the query was served from
    s.engine._tiles.clear()
    AT.clear_cache()
    samples.clear()
    s.add_edges(src[40:50], dst[40:50])
    s.query()
    (served,) = s.engine._pipeline.current.layouts.values()
    assert AT.run_count() == 1 and len(samples) == len(TILES)
    assert all(smp[0] is served.src for smp in samples)
    # a tile first asked for inside a build is an error, not a timing on
    # the build's stream
    s.engine._tiles.clear()
    s.engine._in_build = True
    with pytest.raises(RuntimeError, match="async build"):
        s.engine._tuned_geometry("plus_times", served)


def test_full_on_the_cpu_gives_the_default_tile_and_no_run():
    src, dst = barabasi_albert_edges(200, 2, 0, 0.3)
    s = repro_torch.session((src, dst), device="cpu", autotune="full")
    assert s.engine.edge_layouts()[0].merge_tile == DEFAULT_TILE
    assert s.engine.autotune_runs == 0
    for mode in ("off", "cached", "full"):
        assert AT.tune(AT.TuneKey(10**6, 10**5, 1, "float32", "sum", "cpu"),
                       mode) == DEFAULT_TILE
    with pytest.raises(ValueError, match="autotune"):
        repro_torch.session((src, dst), device="cpu", autotune="fast")


# ------------------------------------------------------ tuner bookkeeping
def _key(**kw):
    base = dict(e_pad=4_000_000, n=300_000, b=1, dtype="float32",
                reduce="sum", platform=H100, w_itemsize=4)
    base.update(kw)
    return AT.TuneKey(**base)


@pytest.mark.parametrize("key", [_key(), _key(b=8, reduce="max"),
                                 _key(dtype="int32", reduce="min"),
                                 _key(w_itemsize=2, platform="cpu")])
def test_tune_key_string_round_trip(key):
    assert AT.TuneKey.from_str(key.as_str()) == key
    ref = JAT.TuneKey(key.e_pad, key.n, key.b, key.dtype, key.reduce,
                      key.platform)
    # the reference's fields, in its order, then the weight width
    assert key.as_str().split("/")[:5] == ref.as_str().split("/")[:5]


def test_cached_is_deterministic_and_writes_no_cache(monkeypatch):
    """A ``cached`` miss is the default tile, never an untimed guess."""
    monkeypatch.setattr(AT, "_time_candidate", pytest.fail)
    for key in (_key(), _key(e_pad=20_000, n=5_000), _key(b=4)):
        assert AT.tune(key, "cached") == AT.tune(key, "cached") == (
            DEFAULT_TILE)
    assert AT.cache_entries() == {} and AT.run_count() == 0
    assert AT.tune(_key(), "off") == DEFAULT_TILE
    with pytest.raises(ValueError, match="autotune mode"):
        AT.tune(_key(), "fast")


def test_full_times_every_candidate_once_then_hits(monkeypatch):
    timed = []
    fake = {768: 3.0, 1280: 1.0, 1792: 2.0, 2816: 4.0, 3840: 5.0}
    monkeypatch.setattr(AT, "_time_candidate", lambda key, tile, *, sample: (
        timed.append((tile, sample)) or fake[tile]))
    key = _key()
    assert AT.tune(key, "full", sample=SAMPLE) == 1280
    assert timed == [(t, SAMPLE) for t in TILES]
    assert AT.run_count() == 1
    assert AT.tune(key, "full") == 1280  # a hit needs no layout
    assert len(timed) == len(TILES) and AT.cache_hits() == 1
    assert AT.tune(key, "cached") == 1280 and AT.cache_hits() == 2
    # a miss under "full" times a real layout or nothing
    with pytest.raises(ValueError, match="needs a layout"):
        AT.tune(_key(b=2), "full")


def test_cache_save_load_round_trip(monkeypatch, tmp_path):
    monkeypatch.setattr(AT, "_time_candidate",
                        lambda key, tile, *, sample: tile)
    keys = [_key(), _key(b=4, reduce="min", w_itemsize=2)]
    tiles = [AT.tune(k, "full", sample=SAMPLE) for k in keys]
    path = tmp_path / "cache.json"
    AT.save_cache(path)
    payload = json.loads(path.read_text())
    assert payload["version"] == 1 and len(payload["entries"]) == 2
    AT.clear_cache()
    assert AT.load_cache(path) == 2 and AT.run_count() == 0
    assert [AT.tune(k, "cached") for k in keys] == tiles
    assert AT.run_count() == 0 and AT.cache_hits() == 2
    assert AT.load_cache(tmp_path / "missing.json") == 0
    payload["entries"][keys[0].as_str()] = 1000
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="tile 1000"):
        AT.load_cache(path)


def test_candidates_pruned_by_shared_memory():
    key = _key(e_pad=20_000, n=5_000)
    spec = AT.device_spec(H100)
    assert AT.candidates(key) == list(TILES)  # every built tile fits 48 KiB
    small = AT.DeviceSpec(**{**spec.__dict__, "smem_per_block": 16 * 1024})
    pruned = AT.candidates(key, spec=small)
    assert pruned and all(AT.block_smem_bytes(t) <= 16 * 1024
                          for t in pruned)
    assert set(TILES) - set(pruned) == {t for t in TILES
                                        if AT.block_smem_bytes(t) > 16384}
    with pytest.raises(ValueError, match="DEVICE_SPECS"):
        AT.candidates(_key(platform="NVIDIA A100-SXM4-80GB"))


def test_model_counts_the_push_bytes():
    e, n = 3_900_008, 300_000
    f32 = AT.modeled_push_cost(e_pad=e, n=n)
    bf16 = AT.modeled_push_cost(e_pad=e, n=n, w_itemsize=2)
    masked = AT.modeled_push_cost(e_pad=e, n=n, w_itemsize=2, masked=True)
    assert f32.hbm_bytes - bf16.hbm_bytes == 2 * e
    assert masked.hbm_bytes - bf16.hbm_bytes == e
    blocks = -(-(n + e) // DEFAULT_TILE)
    assert f32.blocks == blocks
    assert f32.hbm_bytes == e * 8 + 4 * (n + 1) + 8 * n + 2 * blocks * 2 * 4
    assert f32.flops == 2 * e and f32.smem_bytes == (
        DEFAULT_TILE * 8 + AT.CARRY_SMEM_BYTES)
    batched = AT.modeled_push_cost(e_pad=e, n=n, b=4)
    assert batched.hbm_bytes - f32.hbm_bytes == 3 * 8 * n + 2 * blocks * 3 * 4
    # the bf16 bound of a full synth-web-lg push: 6 bytes an edge
    assert 8.0e-6 < bf16.bound_time_s < 8.1e-6 < f32.bound_time_s


# ---------------------------------------------------------- roofline gate
def test_roofline_is_the_tuner_model():
    rec = RL.push_roofline_check(edge_capacity=10_000, num_segments=2_048,
                                 reduce="min", weight_dtype="bfloat16",
                                 tile=768, masked=True, batch=2)
    cost = AT.modeled_push_cost(e_pad=10_000, n=2_048, b=2, w_itemsize=2,
                                reduce="min", tile=768, masked=True)
    assert rec["hbm_bytes"] == cost.hbm_bytes
    assert rec["flops"] == cost.flops
    assert rec["bound_time_s"] == cost.bound_time_s
    assert rec["bound_by"] == "bytes"
    rec = RL.push_roofline_check(edge_capacity=10_000, num_segments=2_048,
                                 measured_s=2 * cost.bound_time_s)
    assert rec["fraction_of_peak"] == pytest.approx(
        AT.modeled_push_cost(e_pad=10_000, n=2_048).bound_time_s
        / (2 * cost.bound_time_s))


def test_committed_baseline_verifies_clean():
    recs = RL.check_push_baselines()
    assert len(recs) >= 5
    assert any(r["weight_dtype"] == "bfloat16" for r in recs.values())
    assert all(r["hbm_ratio_vs_baseline"] == 1.0 for r in recs.values())


def test_gate_trips_on_a_25_percent_regression(tmp_path):
    payload = json.loads(RL.BASELINE.read_text())
    name = sorted(payload["shapes"])[0]
    payload["shapes"][name]["hbm_bytes"] /= 1.25
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(AssertionError, match="regressed 25.0%"):
        RL.check_push_baselines(path)
    RL.check_push_baselines(path, update=True)
    RL.check_push_baselines(path)
