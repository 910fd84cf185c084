"""The rank body of ``tests/test_torch_mesh_sessions.py``: the port's mesh
engine driven through both front doors on four real ranks.

A module of its own, importing only torch, numpy and the port, so that each
spawned rank starts without loading JAX; the test imports it too, for the
streams its oracles replay.  :func:`run` joins a gloo group of
:data:`WORLD` ranks, builds a 1-D ``("shards",)`` mesh over them and runs
every scenario below on it at :data:`SHARDS` edge shards (two a rank), then
one PageRank session on a 2 x 2 ``("data", "model")`` mesh, and pickles
what each session answered and counted to ``{out}.{rank}``.  Every rank
runs the same sessions on the same streams, as a mesh engine's ranks do.
"""

import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from _sharded_ranks import TIMEOUT
import repro_torch
from repro_torch.core.algorithm import Action, available_algorithms
from repro_torch.core.backend import ShardedEdgeLayout
from repro_torch.graph.generators import gnm_edges
from repro_torch.graph.partition import shard_live_counts

WORLD = 4
SHARDS = 8
#: each algorithm's parameters, as the sharded tests pass them
PARAMS = {"sssp": dict(sources=(0,)), "widest-path": dict(sources=(0,)),
          "personalized-pagerank": dict(seeds=(2,))}
NUM_ITERS = 8
#: the stream's graph: G(220, 1300)
N, M = 220, 1300
#: the forced-imbalance streams' edge capacity: every live slot starts in
#: the head shards
IMBALANCE_CAPACITY = 16384
IMBALANCED = ("pagerank", "sssp", "connected-components")
#: the vertices whose out-edges the removal batch takes away (a degree
#: change of 100%, so the query after it has a hot set)
REMOVED_SOURCES = (5, 9, 17)
#: the serving plan of the mesh serve session
SERVE_PLAN = (("personalized-pagerank", dict(seeds=(3,))),
              ("sssp", dict(sources=(5,))), ("pagerank", {}),
              ("connected-components", {}))
#: the starved-bucket serve session (the reference's
#: ``test_serving_on_mesh_with_shard_capacity_knob``): SSSP from vertex 3
#: on G(120, 700), a generous and a starved per-bucket capacity
TIGHT_SSSP = dict(sources=(3,))
TIGHT_CAPS = (4096, 2)


def session_graph(seed: int = 11):
    """The G(N, M) graph of the session scenarios."""
    return gnm_edges(N, M, seed=seed)


def session_batches(src, dst):
    """The scenario-1 stream: two add batches, then one removal batch of
    every out-edge of :data:`REMOVED_SOURCES`; a query after each."""
    gone = np.isin(src, REMOVED_SOURCES)
    return (("add", [1, 2, 3, 7], [4, 5, 6, 9]),
            ("add", [11, 12, 8, 0], [14, 15, 2, 3]),
            ("remove", src[gone], dst[gone]))


def imbalance_batches():
    """The forced-imbalance stream: two add batches and a query with none."""
    return (("add", np.arange(50), np.arange(50) + 100),
            ("add", np.arange(50) + 60, np.arange(50) + 30), None)


def async_batches():
    """The async stream: adds, a removal riding an add, an empty query."""
    return (("add", [1, 2, 3], [4, 5, 6]), ("add", [9, 10], [11, 12]),
            ("remove", [1, 9], [4, 11]), None)


def apply(sess, batch) -> None:
    """Buffer one ``(kind, src, dst)`` batch (``None``: nothing)."""
    if batch is not None:
        kind, s, d = batch
        (sess.add_edges if kind == "add" else sess.remove_edges)(s, d)


def stats_row(st) -> dict:
    """A query's stats without its wall time (the one field that may
    differ between ranks)."""
    row = dataclasses.asdict(st)
    del row["wall_time_s"]
    return row


def drive(sess, batches) -> dict:
    """Each batch then a query: the answers, the stats, and per layout
    its shards and the rows this rank holds (None for an unsharded
    one)."""
    scores, rows = [], []
    for batch in batches:
        apply(sess, batch)
        res = sess.query()
        scores.append(res.scores)
        rows.append(stats_row(res.stats))
    eng = sess.engine
    return {"scores": scores, "rows": rows,
            "layout_builds": eng.layout_builds,
            "rebalances": eng.rebalances,
            "last_imbalance": eng.last_imbalance,
            "slots_recut": eng._shard_slots is not None,
            "layouts": [(lay.num_shards, lay.src.shape[0])
                        if isinstance(lay, ShardedEdgeLayout) else None
                        for lay in eng.edge_layouts()]}


def _sessions(mesh) -> dict:
    """Scenario 1: every registered algorithm over the removal stream."""
    src, dst = session_graph()
    out = {}
    for name in sorted(available_algorithms()):
        with repro_torch.session((src, dst), name, device="cpu", mesh=mesh,
                                 num_shards=SHARDS, num_iters=NUM_ITERS,
                                 **PARAMS.get(name, {})) as s:
            out[name] = drive(s, session_batches(src, dst))
    return out


def _imbalance(mesh) -> dict:
    """Scenario 2: the forced-imbalance stream, sync and async; the live
    counts of the recut assignment."""
    src, dst = gnm_edges(N, M, seed=31)
    out = {}
    for name in IMBALANCED:
        for async_rebuild in (False, True):
            with repro_torch.session(
                    (src, dst), name, device="cpu", mesh=mesh,
                    num_shards=SHARDS, num_iters=NUM_ITERS,
                    edge_capacity=IMBALANCE_CAPACITY,
                    async_rebuild=async_rebuild, **PARAMS.get(name, {})) as s:
                threshold = s.engine.config.rebalance_threshold
                res = drive(s, imbalance_batches())
                eng = s.engine
                res["threshold"] = threshold
                res["live_counts"] = (
                    None if eng._shard_slots is None else
                    shard_live_counts(eng.state, eng._shard_slots).numpy())
            out[name, async_rebuild] = res
    return out


def _no_rebalance(mesh) -> dict:
    """Scenario 3: ``rebalance_threshold=None`` keeps the contiguous cut."""
    src, dst = gnm_edges(150, 800, seed=32)
    with repro_torch.session((src, dst), "pagerank", device="cpu",
                             num_iters=6, edge_capacity=8192, mesh=mesh,
                             num_shards=SHARDS,
                             rebalance_threshold=None) as s:
        return drive(s, (("add", [1, 2, 3], [4, 5, 6]),))


def _async(mesh) -> dict:
    """Scenario 4: async mesh sessions."""
    src, dst = gnm_edges(N, M, seed=12)
    out = {}
    for name in IMBALANCED:
        with repro_torch.session((src, dst), name, device="cpu", mesh=mesh,
                                 num_shards=SHARDS, num_iters=NUM_ITERS,
                                 async_rebuild=True,
                                 **PARAMS.get(name, {})) as s:
            out[name] = drive(s, async_batches())
    return out


def serve_tickets(mesh=None) -> list:
    """Scenario 5: the plan through ``serve_session`` at two slots, a
    stream chunk buffered before the run; each ticket's answer and
    fallback flag.  ``mesh=None`` is the unsharded run the test holds it
    to."""
    src, dst = gnm_edges(200, 1200, seed=13)
    extra = {} if mesh is None else dict(mesh=mesh, num_shards=SHARDS)
    with repro_torch.serve_session((src, dst), device="cpu", slots=2,
                                   **extra) as srv:
        tickets = [srv.submit(n, **p) for n, p in SERVE_PLAN]
        srv.add_edges([1, 2, 3], [7, 8, 9])
        srv.run()
        return [(t.result, t.exact_fallback) for t in tickets]


def _tight_serving(mesh) -> list:
    """Scenario 5, the per-bucket capacity: one SSSP ticket at each of
    :data:`TIGHT_CAPS`; its answer, fallback flag and the run's overflow
    fallbacks."""
    src, dst = gnm_edges(120, 700, seed=7)
    out = []
    for cap in TIGHT_CAPS:
        with repro_torch.serve_session((src, dst), device="cpu", slots=2,
                                       mesh=mesh, num_shards=SHARDS,
                                       shard_hot_edge_capacity=cap) as srv:
            t = srv.submit("sssp", **TIGHT_SSSP)
            srv.run()
            out.append({"done": t.done, "result": t.result,
                        "exact_fallback": t.exact_fallback,
                        "overflow_fallbacks": srv.stats.overflow_fallbacks})
    return out


def unfused_graph():
    """Scenario 6's graph and its one add batch."""
    src, dst = gnm_edges(N, M, seed=14)
    return src, dst, (("add", np.arange(40), np.arange(40) + 1),)


def _unfused(mesh) -> dict:
    """Scenario 6: CC on the unfused engine, and with starved buckets."""
    src, dst, batches = unfused_graph()
    cc = "connected-components"
    out = {}
    for tag, extra in (("unfused", dict(fused=False)),
                       ("tight", dict(shard_hot_edge_capacity=2))):
        with repro_torch.session((src, dst), cc, device="cpu", mesh=mesh,
                                 num_shards=SHARDS, num_iters=NUM_ITERS,
                                 **extra) as s:
            out[tag] = drive(s, batches)
    return out


def unsharded_exact_cc() -> dict:
    """The exact CC answers scenario 6's starved session must give."""
    src, dst, batches = unfused_graph()
    with repro_torch.session((src, dst), "connected-components",
                             device="cpu", num_iters=NUM_ITERS,
                             on_query=lambda q, v: Action.EXACT) as s:
        return drive(s, batches)


def _two_by_two(mesh) -> dict:
    """Scenario 7: scenario 1's PageRank on a 2 x 2 ``("data",
    "model")`` mesh, its shards over both dims flattened."""
    src, dst = session_graph()
    with repro_torch.session((src, dst), "pagerank", device="cpu", mesh=mesh,
                             num_shards=SHARDS, num_iters=NUM_ITERS) as s:
        return drive(s, session_batches(src, dst))


def run(rank: int, init: str, out: str) -> None:
    """One rank: every scenario on the 1-D mesh, then the 2 x 2 one.  One
    thread a rank, so the four ranks do not crowd out the other tests'
    processes."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("shards",))
        res = {"sessions": _sessions(mesh), "imbalance": _imbalance(mesh),
               "no_rebalance": _no_rebalance(mesh), "async": _async(mesh),
               "serving": serve_tickets(mesh),
               "tight_serving": _tight_serving(mesh),
               "unfused": _unfused(mesh)}
        grid = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res["two_by_two"] = _two_by_two(grid)
        res["coordinate"] = tuple(grid.get_coordinate())
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
