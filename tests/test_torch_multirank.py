"""The port on four real ranks: a 2 x 2 ``("data", "model")`` mesh of
spawned gloo processes on the CPU (the rank body is
``tests/_sharded_ranks.py::run_multirank``, which imports no JAX; a
``file://`` store in the test's tmp dir).  One spawn runs every check; its
ranks pickle what they hold and computed, and the tests here hold that to
the oracles.

- **The sliced graph state**: each rank's state is placed as the
  reference's ``graph_shardings`` lays it out (its quarter of the edge
  slots, the node vectors whole), built from its own slot range alone;
  its placed layouts are the whole state's rows; ``fused_query_step`` on
  the sliced states is bitwise the whole-state run on the same mesh, and
  matches the reference's meshless shard loop (``num_shards=4``,
  ``backend="segment_sum"``): integer outputs and min/max results bitwise,
  sums at rtol 1e-5, atol 1e-6; no collective moves an edge-sized buffer.
- **The DTensor steps**: the dense and the MoE smoke configs' train steps,
  and the dense prefill and one decode step, on DTensor parameters and
  batches placed by ``launch.specs.param_pspecs_guarded`` and the rules,
  with f32 activations, against the single-process plain steps (the plain
  step is held to JAX by ``tests/test_torch_train.py``).  The ranks'
  reductions run in another order, so the moments, metrics, logits and
  caches agree within :data:`LM_RTOL` of each tensor's largest magnitude
  (measured: at most 2.2e-6, beside 2.9e-6 between the plain step in f32
  and in f64, which the train test prints with ``-s``).  The first AdamW
  step's parameter moves ``p - p0`` are the AdamW arithmetic on the
  rank's own moments at :data:`SELF_RTOL` (lr, bias corrections and weight
  decay of the sharded write path), and the plain step's moves at
  :data:`STEP_RTOL`, both beside one f32 spacing of the parameter; the
  second check leaves out the entries whose gradient lies within the
  measured reduction noise of ``eps`` (see :func:`_hold_first_update`).
  The MoE routes are bitwise; the global norm is one all-reduce and
  DTensor warns of no sequential all-reduces.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import backend as JB
from repro.core.algorithm import make_algorithm as jmake
from repro.core.fused import fused_query_step as jfused
from repro.graph import from_edges as jfrom_edges
from repro.graph import partition as JP
from repro_torch.core.algorithm import make_algorithm as tmake

TOL = dict(rtol=1e-5, atol=1e-6)
#: the DTensor steps' outputs against the plain step's, relative to each
#: tensor's largest magnitude
LM_RTOL = 1e-5
#: the train step's learning rate (``make_train_step``'s default, an f32
#: tensor there) and its AdamW constants (``adamw_update_``'s defaults)
LR = float(np.float32(3e-4))
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
#: the DTensor step's parameter moves against the AdamW arithmetic on its
#: own moments (measured at most 2.3e-7), and against the plain step's
#: moves where the gradient is clear of the reduction noise (measured at
#: most 1.6e-6), each relative to the move
SELF_RTOL = 1e-6
STEP_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' pickled results (one spawn for the module)."""
    import _sharded_ranks as R

    d = tmp_path_factory.mktemp("multirank")
    out = str(d / "res")
    mp.spawn(R.run_multirank, args=(f"file://{d / 'store'}", out), nprocs=4,
             join=True)
    got = []
    for rank in range(4):
        with open(f"{out}.{rank}", "rb") as f:
            got.append(pickle.load(f))
    return R, got


def _match(out, ref, semiring):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if semiring == "plus_times" and out.dtype.kind == "f":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        np.testing.assert_array_equal(out, ref)


def test_each_rank_holds_a_quarter_of_the_edge_slots(ranks):
    R, got = ranks
    quarter = R.G_CAP // 4
    for rank, res in enumerate(got):
        g = res["graph"]
        assert g["slot_range"] == (rank * quarter, (rank + 1) * quarter)
        assert g["local_slots"] == dict.fromkeys(
            ("src", "dst", "edge_alive", "edge_len"), (quarter,))
        # built from its slot range alone, degrees all-reduced: the placed
        # whole state's buffers
        assert g["built_is_placed"]
        assert g["layout_rows_equal"] == [True] * 4
        assert "queue 1 entry 15" in g["rebalance"]


@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_sliced_fused_step_matches_whole_and_reference(ranks, name):
    R, got = ranks
    params = dict(R.G_ALGOS)[name]
    talgo = tmake(name, num_iters=8, **params)
    semiring = talgo.semiring
    first = got[0]["graph"][name]
    for res in got:
        one = res["graph"][name]
        # the sliced states are bitwise the whole state on the same mesh,
        # and every rank has the same answer
        assert one["sliced_stats"] == one["whole_stats"]
        for k, v in one["whole"].items():
            np.testing.assert_array_equal(one["sliced"][k], v)
            np.testing.assert_array_equal(v, first["whole"][k])
        # no collective moves an edge-sized buffer (4 B a slot)
        assert "all-gather" not in one["coll_max"]
        assert max(one["coll_max"].values()) < 4 * R.G_CAP
        assert one["coll_counts"]["all-reduce"] >= 2
    assert not first["whole_stats"][7]  # no fallback
    assert first["whole_stats"][0] > 0  # a hot set
    # the reference's meshless shard loop at four shards
    src, dst, lengths = R.graph_arrays()
    old = R.G_M - R.G_NEW
    jg = jfrom_edges(src, dst, R.G_N, R.G_CAP, weights=lengths)
    jprev = jfrom_edges(src[:old], dst[:old], R.G_N, R.G_CAP,
                        weights=lengths[:old])
    ja = jmake(name, num_iters=8, **params)
    jl = tuple(JP.build_sharded_layout(jg, num_shards=4, weight=w,
                                       reverse=r, semiring=s)
               for w, r, s in map(JB.normalize_layout_spec,
                                  ja.layout_specs))
    jst = {k: jnp.asarray(v) for k, v in first["state"].items()}
    want, wstats = jfused(jg, jst, jnp.copy(jprev.out_deg),
                          jnp.copy(jprev.node_active), jnp.float32(0.2),
                          jnp.float32(0.05), algo=ja, layouts=jl,
                          backend="segment_sum", **R.G_CAPS)
    assert first["whole_stats"][:6] == [int(x) for x in wstats[:6]]
    assert first["whole_stats"][6] == int(wstats.iterations)
    for k in want:
        _match(first["sliced"][k], want[k], semiring)


def _gap(a, b) -> float:
    """max |a - b| over the largest |b| (0 for two zero tensors)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max() if a.size else 0.0)


def _plain_runs(R, arch, dtype=None):
    """The single-process plain steps on the same inputs, with the MoE
    routes of the train step recorded; ``dtype`` replaces the parameters'
    and activations' dtype (the f64 control)."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.train import step as ST
    from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map

    cfg = R.lm_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, activation_dtype=dtype,
                                  param_dtype=dtype)
    params, batch, token = R.lm_inputs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = tree_map(torch.clone, params)
    o = adamw_init(p)
    routes, route = [], moe.route

    def recording(probs, k):
        w, i = route(probs, k)
        routes.append(i.numpy())
        return w, i
    moe.route = recording
    try:
        _, _, metrics = ST.make_train_step(cfg)(p, o, batch)
    finally:
        moe.route = route
    # copies: the serve step writes into the prefill's cache
    leaves = lambda tree: [t.detach().numpy().copy()
                           for t in tree_leaves(tree)]
    out = {"train": {"p0": leaves(params), "params": leaves(p),
                     "mu": leaves(o.mu),
                     "nu": leaves(o.nu),
                     "metrics": {k: v.numpy() for k, v in metrics.items()}},
           "routes": routes}
    if arch == R.LM_ARCHS[0]:
        p = tree_map(torch.clone, params)
        logits, cache = ST.make_prefill_step(cfg, cache_len=R.LM_CACHE)(
            p, {"tokens": batch["tokens"]})
        out["prefill"] = leaves([logits, cache])
        logits, cache = ST.make_serve_step(cfg)(
            p, cache, torch.from_numpy(token),
            torch.tensor(R.LM_SEQ, dtype=torch.int32))
        out["decode"] = leaves([logits, cache])
    return out


def _hold_first_update(one, want) -> tuple:
    """Hold the DTensor step's parameter moves ``d = p - p0`` after the
    first AdamW step (in f64 from the f32 values; ``sp`` one f32 spacing
    of the new parameter, where either run may round the other way):

    - every entry to the AdamW arithmetic on the rank's own moments,
      ``-lr · (m/c1 / (sqrt(v/c2) + eps) + wd · p0)`` at step 1, within
      ``SELF_RTOL`` of it plus ``sp``: a skipped update, or a wrong lr, bias
      correction or weight decay, fails here;
    - each entry to the plain step's move, within ``STEP_RTOL`` of it plus
      ``sp``, except where the gradient is within reduction noise: ``g = m
      / (1 - b1)``, and a gradient moved by ``n`` (the leaf's largest gap
      between the two runs' gradients) moves ``g / (|g| + eps)`` by up to
      ``eps · n / (|g| + eps)²``; the entries where that exceeds
      ``STEP_RTOL`` are left out (mostly gradients of 0, such as the rows
      of tokens no batch holds);
    - the entries held whose gradient is at least ``100 · eps`` moved by
      ``lr · (1 ± wd · |p0|)`` within 1%.

    Returns (entries left out of the second check, entries, the largest
    gap beyond ``sp`` over the move in the first check, in the second)."""
    c1 = 1.0 - float(np.float32(B1))
    c2 = 1.0 - float(np.float32(B2))
    f = lambda a: np.asarray(a, np.float64)
    spacing = lambda a: f(np.spacing(np.abs(np.asarray(a, np.float32))))
    masked = total = 0
    worst = [0.0, 0.0]
    beyond = lambda err, sp, ref: float((np.maximum(err - sp, 0)
                                         / np.maximum(ref, 1e-30)).max(
                                             initial=0.0))
    for p0, pd, pp, md, vd, mp_ in zip(want["p0"], one["params"],
                                       want["params"], one["mu"],
                                       one["nu"], want["mu"]):
        d, dp, q0 = f(pd) - f(p0), f(pp) - f(p0), f(p0)
        u = (f(md) / c1) / (np.sqrt(f(vd) / c2) + EPS) + WD * q0
        assert np.all(np.abs(d + LR * u)
                      <= SELF_RTOL * np.abs(LR * u) + spacing(pd))
        worst[0] = max(worst[0], beyond(np.abs(d + LR * u), spacing(pd),
                                        np.abs(LR * u)))
        gd, gp = f(md) / (1 - B1), f(mp_) / (1 - B1)
        noise = np.abs(gd - gp).max()
        held = EPS * noise / (np.abs(gp) + EPS) ** 2 <= STEP_RTOL
        masked, total = masked + int((~held).sum()), total + held.size
        assert np.all((np.abs(d - dp) <= STEP_RTOL * np.abs(dp)
                       + spacing(pp))[held])
        worst[1] = max(worst[1], beyond(np.abs(d - dp)[held],
                                        spacing(pp)[held], np.abs(dp)[held]))
        big = held & (np.abs(gp) >= 100 * EPS)
        assert np.all(np.abs(np.abs(d[big]) / LR - 1)
                      <= WD * np.abs(q0[big]) + 0.01)
    return masked, total, worst[0], worst[1]


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x22b"])
def test_dtensor_train_steps_match_the_plain_step(ranks, arch):
    R, got = ranks
    want = _plain_runs(R, arch)
    gaps, moves = {}, (0, 0, 0.0, 0.0)
    for res in got:
        one = res["lm"][arch]
        # one all-reduce for the norm, and no sequential all-reduces
        assert one["norm_counts"] == [{"all-reduce": 1.0}]
        assert one["warnings"] == []
        for part in ("mu", "nu"):
            a, b = one["train"][part], want["train"][part]
            assert len(a) == len(b)
            gaps[part] = max([gaps.get(part, 0.0)]
                             + [_gap(x, y) for x, y in zip(a, b)])
        for k, v in want["train"]["metrics"].items():
            gaps[k] = max(gaps.get(k, 0.0), _gap(one["train"]["metrics"][k],
                                                 v))
        assert len(one["train"]["params"]) == len(want["train"]["params"])
        held = _hold_first_update(one["train"], want["train"])
        moves = (held[0], held[1], max(moves[2], held[2]),
                 max(moves[3], held[3]))
        # the MoE routes: each rank's batch rows of the plain routes
        d = res["lm"]["coordinate"][0]
        rows = slice(d * R.LM_BATCH // 2, (d + 1) * R.LM_BATCH // 2)
        assert len(one["routes"]) == len(want["routes"])
        for x, y in zip(one["routes"], want["routes"]):
            np.testing.assert_array_equal(x, y[rows])
    f64 = _plain_runs(R, arch, "float64")["train"]
    control = {part: max(_gap(x, y) for x, y in zip(want["train"][part],
                                                    f64[part]))
               for part in ("mu", "nu")}
    print(f"{arch} train: DTensor vs plain {gaps}; plain f32 vs f64 "
          f"{control}; parameter moves: AdamW on the rank's moments "
          f"{moves[2]:.3g} (limit {SELF_RTOL}), the plain step's "
          f"{moves[3]:.3g} (limit {STEP_RTOL}) on all but {moves[0]} of "
          f"{moves[1]} entries")
    assert max(gaps.values()) <= LM_RTOL, gaps
    if arch == "mixtral_8x22b":
        assert want["routes"]


def test_dtensor_prefill_and_decode_match_the_plain_steps(ranks):
    R, got = ranks
    arch = R.LM_ARCHS[0]
    want = _plain_runs(R, arch)
    gaps = {}
    for res in got:
        one = res["lm"][arch]
        for part in ("prefill", "decode"):
            assert len(one[part]) == len(want[part])
            gaps[part] = max([gaps.get(part, 0.0)] + [
                _gap(x, y) for x, y in zip(one[part], want[part])])
    print(f"prefill/decode gaps: {gaps}")
    assert max(gaps.values()) <= LM_RTOL, gaps
