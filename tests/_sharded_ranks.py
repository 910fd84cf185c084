"""The rank bodies of ``tests/test_torch_sharded.py``'s spawned tests.

A module of its own, importing only torch and the port, so that each
spawned rank starts without loading JAX.  In :func:`run` each rank joins a
gloo group of two, builds the mesh layout of its two shards (of four), and
pickles its push and its sharded summary to ``{out}.{rank}``; in
:func:`run_nd` each of four ranks of a 2 x 2 mesh pickles its one shard's
rows and its push.
"""

import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import backend as TB
from repro_torch.core.pagerank import build_summary
from repro_torch.graph import partition as TP
from repro_torch.graph.generators import gnm_edges
from repro_torch.graph.graph import from_edges

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
                            world_size=2)
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
                            world_size=4)
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
