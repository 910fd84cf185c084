"""The rank bodies of ``tests/test_torch_sharded.py``'s spawned tests.

A module of its own, importing only torch and the port, so that each
spawned rank starts without loading JAX.  In :func:`run` each rank joins a
gloo group of two, builds the mesh layout of its two shards (of four), and
pickles its push and its sharded summary to ``{out}.{rank}``; in
:func:`run_nd` each of four ranks of a 2 x 2 mesh pickles its one shard's
rows and its push; in :func:`run_multirank` (``tests/test_torch_multirank.py``)
each of four ranks of a 2 x 2 mesh holds a quarter of the graph's edge
slots through ``fused_query_step`` and runs the DTensor train, prefill
and decode steps.
"""

import pickle
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import backend as TB
from repro_torch.core.pagerank import build_summary
from repro_torch.graph import partition as TP
from repro_torch.graph.generators import gnm_edges
from repro_torch.graph.graph import from_edges

#: every spawned rank's process-group timeout: a desynchronised rank
#: fails its collective after this, as one failed test, where gloo's
#: default of 30 minutes would outlast the whole suite
TIMEOUT = timedelta(seconds=120)
#: (weight, semiring) of the two runs: a sum and a min
CASES = (("inv_out", "plus_times"), ("length", "min_plus"))
SUMMARY_FIELDS = ("hot_ids", "num_hot", "ek_src", "ek_dst", "ek_w",
                  "ek_row_offsets", "num_ek", "num_eb", "overflow", "b_in")
#: vertices, edge slots and the summary's capacities
N, E_CAP = 280, 1464
CAPS = dict(hot_node_capacity=128, hot_edge_capacity=1024)


def arrays():
    """The edges, their lengths, the values and the hot mask as numpy:
    the ranks build the port's inputs from them, the test the
    reference's."""
    src, dst = gnm_edges(N, 1400, seed=21)
    lengths = np.random.default_rng(22).uniform(0.5, 2.0, 1400).astype(
        np.float32)
    x = np.random.default_rng(23).random(N).astype(np.float32)
    hot = np.random.default_rng(24).random(N) < 0.3
    return src, dst, lengths, x, hot


def inputs(weight: str):
    """The port's graph, values and hot mask."""
    src, dst, lengths, x, hot = arrays()
    g = from_edges(src, dst, N, E_CAP,
                   weights=lengths if weight == "length" else None,
                   device="cpu")
    return g, torch.from_numpy(x), torch.from_numpy(hot)


def summarize(g, x, hot, weight, semiring, layout):
    """The push and the sharded summary over ``layout``."""
    sm = build_summary(g, x, hot, **CAPS, weight=weight, semiring=semiring,
                       layout=layout)
    return {"rows": layout.src.shape[0],
            "push": TB.push(x, layout, semiring=semiring).numpy(),
            **{f: getattr(sm, f).numpy() for f in SUMMARY_FIELDS}}


def run(rank: int, init: str, out: str) -> None:
    """One rank of the two-rank run."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("shards",))
        res = {}
        for weight, semiring in CASES:
            g, x, hot = inputs(weight)
            layout = TP.place_sharded_layout(TP.build_sharded_layout(
                g, mesh=mesh, num_shards=4, weight=weight,
                semiring=semiring))
            res[semiring] = summarize(g, x, hot, weight, semiring, layout)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


#: the layout rows each rank of the 2 x 2 run returns
LAYOUT_FIELDS = ("src", "dst", "weight", "valid", "row_offsets", "order")


def run_nd(rank: int, init: str, out: str) -> None:
    """One rank of the four-rank run on a 2 x 2 ``("data", "model")``
    mesh: its edge shards run over both axes flattened (four shards, one a
    rank), built placed; pickles its rows and its all-reduced push."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {"coordinate": mesh.get_coordinate()}
        for weight, semiring in CASES:
            g, x, _ = inputs(weight)
            layout = TP.build_sharded_layout(
                g, mesh=mesh, weight=weight, semiring=semiring, placed=True)
            res[semiring] = {
                "num_shards": layout.num_shards, "axes": layout.axes,
                **{f: getattr(layout, f).numpy() for f in LAYOUT_FIELDS},
                "push": TB.push(x, layout, semiring=semiring).numpy()}
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the four-rank run of slice S
#: the graph of tests/test_torch_multirank.py: vertices, edges, slots (four
#: ranks and up to eight shards divide them), the edges its query follows
#: (the last ones), the step's capacities
G_N, G_M, G_CAP, G_NEW = 400, 800, 1024, 12
G_CAPS = dict(hot_node_capacity=400, hot_edge_capacity=512)
#: the workloads of the fused step on sliced states, with their parameters
G_ALGOS = (("pagerank", {}), ("sssp", dict(sources=(0,))))
#: the LM configs of the DTensor steps: the dense and the MoE smoke config
LM_ARCHS = ("qwen2_0_5b", "mixtral_8x22b")
LM_BATCH, LM_SEQ, LM_CACHE = 4, 32, 48


def graph_arrays():
    """The edges, their lengths and the hot-set thresholds as numpy."""
    src, dst = gnm_edges(G_N, G_M, seed=41)
    lengths = np.random.default_rng(42).uniform(0.5, 2.0, G_M).astype(
        np.float32)
    return src, dst, lengths


def graph_query_inputs(algo):
    """The port's whole graph, the algorithm's exact state on the graph
    before its last ``G_NEW`` edges, and that graph's degrees and
    activity (the query's baselines)."""
    src, dst, lengths = graph_arrays()
    g = from_edges(src, dst, G_N, G_CAP, weights=lengths, device="cpu")
    old = G_M - G_NEW
    prev = from_edges(src[:old], dst[:old], G_N, G_CAP,
                      weights=lengths[:old], device="cpu")
    state, _ = algo.exact(algo.init_state(prev), prev)
    return g, state, prev.out_deg.clone(), prev.node_active.clone()


def lm_config(arch):
    """The smoke config with f32 activations (so the MoE routes compare
    bitwise)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch),
                               activation_dtype="float32")


def lm_inputs(cfg):
    """The parameters (from a seed), a train batch, a decode token."""
    from repro_torch.models.params import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    ids = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    return params, {"tokens": ids(LM_BATCH, LM_SEQ),
                    "labels": ids(LM_BATCH, LM_SEQ)}, ids(LM_BATCH, 1)


def _graph_runs(mesh):
    """Part A on this rank: the sliced states and the fused steps."""
    from repro_torch.core.algorithm import make_algorithm
    from repro_torch.core.fused import fused_query_step
    from repro_torch.graph.graph import edge_slice
    from repro_torch.launch.dispatch_cost import CostCounter

    src, dst, lengths = graph_arrays()
    lo, hi = TP.edge_slot_range(mesh, G_CAP)
    top = min(hi, G_M)
    whole = from_edges(src, dst, G_N, G_CAP, weights=lengths, device="cpu")
    placed = TP.place_graph_state(whole, mesh)
    # this rank's state from its slot range alone, the degrees all-reduced
    built = TP.from_edge_slice(mesh, src[lo:top], dst[lo:top],
                               node_capacity=G_N, edge_capacity=G_CAP,
                               num_edges=G_M, weights=lengths[lo:top])
    a, b = edge_slice(placed), edge_slice(built)
    res = {"slot_range": (lo, hi),
           "local_slots": {f: tuple(getattr(b, f).shape)
                           for f in ("src", "dst", "edge_alive",
                                     "edge_len")},
           "built_is_placed": all(
               torch.equal(getattr(a, f), getattr(b, f))
               for f in ("src", "dst", "edge_alive", "edge_len", "mask"))
           and all(torch.equal(getattr(placed, f), getattr(built, f))
                   for f in ("num_edges", "out_deg", "in_deg",
                             "node_active"))}
    # the placed layout's rows against the whole state's
    rows = []
    for spec in (dict(weight="inv_out"), dict(weight="length",
                                              semiring="min_plus")):
        for shards in (4, 8):
            got = TP.build_sharded_layout(built, mesh=mesh, placed=True,
                                          num_shards=shards, **spec)
            want = TP.build_sharded_layout(whole, mesh=mesh, placed=True,
                                           num_shards=shards, **spec)
            rows.append(all(
                (getattr(got, f) is None and getattr(want, f) is None)
                or torch.equal(getattr(got, f), getattr(want, f))
                for f in LAYOUT_FIELDS + ("rank",)))
    res["layout_rows_equal"] = rows
    try:
        TP.rebalance_sharded_layout(built, num_shards=4)
        res["rebalance"] = "ran"
    except NotImplementedError as e:
        res["rebalance"] = str(e)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    for name, params in G_ALGOS:
        algo = make_algorithm(name, num_iters=8, **params)
        g, state, deg_prev, active_prev = graph_query_inputs(algo)
        run = lambda st: fused_query_step(
            st, state, deg_prev, active_prev, f32(0.2), f32(0.05),
            algo=algo, mesh=mesh, **G_CAPS)
        want, wstats = run(g)
        with CostCounter() as cc:
            got, gstats = run(built)
        res[name] = {
            "state": {k: v.numpy() for k, v in state.items()},
            "whole": {k: v.numpy() for k, v in want.items()},
            "sliced": {k: v.numpy() for k, v in got.items()},
            "whole_stats": [int(x) for x in wstats[:8]],
            "sliced_stats": [int(x) for x in gstats[:8]],
            "coll_max": dict(cc.cost.coll_max),
            "coll_counts": dict(cc.cost.coll_counts)}
    return res


def _lm_runs(mesh):
    """Part B on this rank: the DTensor train steps of both configs, the
    dense prefill and one decode step; every output gathered whole."""
    import logging

    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dispatch_cost import CostCounter
    from repro_torch.launch.specs import param_pspecs_guarded
    from repro_torch.models import moe
    from repro_torch.sharding import rules as TR
    from repro_torch.train import step as ST
    from repro_torch.train.optimizer import (AdamWState, tree_leaves,
                                             tree_map)

    rules, sizes = TR.rules_for_mesh(mesh), {"data": 2, "model": 2}
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor)
                       else t).detach().numpy()
    gather = lambda tree: [whole(t) for t in tree_leaves(tree)]
    # DTensor's warning of sequential all-reduces over several mesh dims
    warned = []
    handler = logging.Handler()
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger("torch.distributed.tensor").addHandler(handler)
    # the norm's collectives, counted apart from the step's
    norm_counts = []
    global_norm = ST.global_norm

    def counted_norm(tree):
        with CostCounter() as cc:
            out = global_norm(tree)
        norm_counts.append(dict(cc.cost.coll_counts))
        return out
    routes = []
    route = moe.route

    def recording(probs, k):
        w, i = route(probs, k)
        routes.append(i.numpy())
        return w, i
    ST.global_norm, moe.route = counted_norm, recording
    res = {"coordinate": tuple(mesh.get_coordinate())}
    try:
        with TR.axis_rules(rules):
            for arch in LM_ARCHS:
                cfg = lm_config(arch)
                params, batch, token = lm_inputs(cfg)
                pspecs = param_pspecs_guarded(cfg, rules, sizes)
                place = lambda tree, specs: (
                    {k: place(v, specs[k]) for k, v in tree.items()}
                    if isinstance(tree, dict) else
                    TR.place(tree.numpy(), TR.NamedSharding(mesh, specs)))
                bspec = TR.NamedSharding(mesh, ("data",))
                dbatch = {k: TR.place(v, bspec) for k, v in batch.items()}
                p = place(params, pspecs)
                zeros = lambda: tree_map(lambda t: torch.zeros_like(
                    t, dtype=torch.float32), p)
                o = AdamWState(TR.place(np.zeros((), np.int32),
                                        TR.NamedSharding(mesh, ())),
                               zeros(), zeros())
                del routes[:]
                warned.clear()
                _, _, metrics = ST.make_train_step(cfg)(p, o, dbatch)
                res[arch] = {
                    "train": {"params": gather(p), "mu": gather(o.mu),
                              "nu": gather(o.nu),
                              "metrics": {k: whole(v)
                                          for k, v in metrics.items()}},
                    "routes": list(routes), "norm_counts": list(norm_counts),
                    "warnings": [w for w in warned if "sequential" in w]}
                norm_counts.clear()
                if arch != LM_ARCHS[0]:
                    continue
                p = place(params, pspecs)
                logits, cache = ST.make_prefill_step(cfg, cache_len=LM_CACHE)(
                    p, {"tokens": dbatch["tokens"]})
                res[arch]["prefill"] = gather([logits, cache])
                logits, cache = ST.make_serve_step(cfg)(
                    p, cache, TR.place(token, bspec),
                    TR.place(np.array(LM_SEQ, np.int32),
                             TR.NamedSharding(mesh, ())))
                res[arch]["decode"] = gather([logits, cache])
    finally:
        ST.global_norm, moe.route = global_norm, route
        logging.getLogger("torch.distributed.tensor").removeHandler(handler)
    return res


def run_multirank(rank: int, init: str, out: str) -> None:
    """One rank of the four-rank run on a 2 x 2 ``("data", "model")``
    mesh: the graph state placed by ``graph_shardings`` (this rank's
    quarter of the edge slots) through ``fused_query_step``, beside the
    whole state on the same mesh, then the DTensor train, prefill and
    decode steps; pickles what it holds and computed.  Two threads a rank,
    so the four ranks do not crowd out the other tests' processes."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {"graph": _graph_runs(mesh), "lm": _lm_runs(mesh)}
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
