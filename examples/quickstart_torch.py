"""Quickstart: VeilGraph on PyTorch in ~40 lines.

Build a streaming graph, serve queries approximately, compare against exact.
It runs on the CUDA card; ``main(device="cpu")`` (or ``--device cpu``) runs
it on the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.core import Action, EngineConfig, VeilGraphEngine
from repro_torch.core.policies import always
from repro_torch.graph.generators import barabasi_albert_edges
from repro_torch.metrics import rbo_from_scores
from repro_torch.stream import StreamConfig, build_stream


def main(device=None):
    # a scale-free graph and a stream of 2000 edge additions in 10 chunks
    src, dst = barabasi_albert_edges(5000, 4, seed=0)
    stream = build_stream(src, dst, StreamConfig(stream_size=2000,
                                                 num_queries=10, seed=1))

    cfg = EngineConfig(
        node_capacity=5_000, edge_capacity=64_000,
        hot_node_capacity=2_048, hot_edge_capacity=16_384,
        r=0.2, n=1, delta=0.5,      # the paper's (r, n, Δ) knobs
        num_iters=30, tol=1e-6, device=device,
    )
    approx = VeilGraphEngine(cfg)                                # summarized
    exact = VeilGraphEngine(cfg, on_query=always(Action.EXACT))  # ground truth

    approx.start(stream.init_src, stream.init_dst)
    exact.start(stream.init_src, stream.init_dst)

    print(f"{'q':>3} {'hot%':>7} {'edges%':>7} {'RBO@100':>8} {'speedup':>8}")
    for q, (s, d) in enumerate(stream):
        approx.register_add_edges(s, d)
        exact.register_add_edges(s, d)
        ranks_a, st_a = approx.query()
        ranks_e, st_e = exact.query()
        rbo = rbo_from_scores(ranks_a, ranks_e, depth=100,
                              active=approx.state.node_active.cpu().numpy())
        sp = st_e.wall_time_s / max(st_a.wall_time_s, 1e-9)
        print(f"{q:>3} {100*st_a.vertex_ratio:>6.2f}% {100*st_a.edge_ratio:>6.2f}%"
              f" {rbo:>8.4f} {sp:>7.2f}x")
    approx.stop()
    exact.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="e.g. cpu (default: the CUDA card)")
    main(ap.parse_args().device)
