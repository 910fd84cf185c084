"""End-to-end reproduction of the paper's experiment protocol on one
dataset, on PyTorch.

Initial exact computation on G, then Q=50 queries, each integrating a chunk
of edge additions and running the summarized update over the hot-vertex
summary graph.  Reports the paper's four metrics per query: summary vertex
ratio, summary edge ratio, RBO vs exact ground truth, and speedup.

Built on the session front door (``repro_torch.api.session``), so any
registered algorithm runs through the same protocol — PageRank (the
paper's case study), personalized PageRank, HITS, or your own plugin.  It
runs on the CUDA card; ``run(device="cpu")`` (or ``--device cpu``) runs it
on the CPU:

  PYTHONPATH=src python examples/streaming_pagerank_torch.py \\
      --dataset synth-citation --r 0.2 --n 1 --delta 0.1
  PYTHONPATH=src python examples/streaming_pagerank_torch.py \\
      --dataset synth-citation --algorithm hits --device cpu
"""

import argparse

import numpy as np

import repro_torch as veilgraph
from repro_torch.core.policies import always
from repro_torch.graph.generators import DATASETS, generate
from repro_torch.metrics import rbo_from_scores
from repro_torch.stream import StreamConfig, build_stream


def run(dataset="synth-citation", algorithm="pagerank", r=0.2, n=1, delta=0.1,
        queries=50, shuffle=True, seed=7, rbo_depth=None, verbose=True,
        device=None, **algo_params):
    spec = DATASETS[dataset]
    src, dst = generate(spec, seed=0)
    sc = StreamConfig(stream_size=spec.stream_size, num_queries=queries,
                      shuffle=shuffle, seed=seed)
    stream = build_stream(src, dst, sc)
    depth = rbo_depth or (1000 if sc.edges_per_query <= 200 else 4000)

    n_cap = spec.nodes
    e_cap = int(src.shape[0] * 1.15)
    knobs = dict(
        node_capacity=n_cap, edge_capacity=e_cap,
        hot_node_capacity=max(2048, n_cap // 2),
        hot_edge_capacity=max(16384, e_cap // 2),
        r=r, n=n, delta=delta, device=device,
        **algo_params,
    )
    # sweep knobs only where the algorithm takes them (the fixed-point
    # traversal workloads have no tol — they stop when nothing changes);
    # introspect the registry factory rather than instantiating it, so
    # algorithms with required constructor args don't crash here.  An
    # already-constructed instance carries its own knobs — session()
    # rejects forwarding to it, so inject nothing.
    if isinstance(algorithm, str):
        from repro_torch.core.algorithm import (algorithm_factory,
                                                factory_accepts)
        factory = algorithm_factory(algorithm)
        for k, v in (("num_iters", 30), ("tol", 1e-6)):
            if factory_accepts(factory, k):
                knobs.setdefault(k, v)
    approx = veilgraph.session(stream, algorithm, **knobs)
    exact = veilgraph.session(stream, algorithm,
                              on_query=always(veilgraph.Action.EXACT), **knobs)
    st0 = approx.stats_log[0]
    if verbose:
        print(f"{dataset} (analogue of {spec.paper_analogue}): "
              f"V={stream.total_nodes} E={stream.total_edges} "
              f"|S|={spec.stream_size} chunk={sc.edges_per_query} "
              f"algorithm={approx.algorithm.name} "
              f"device={approx.engine.device}")
        print(f"initial exact compute: {st0.wall_time_s:.3f}s")

    rows = []
    for q, (ra, re_) in enumerate(zip(approx.play(), exact.play())):
        # orient by the algorithm's ranking direction and drop sentinel
        # entries (+inf unreachable distances, int-max labels) — otherwise
        # distance/label workloads would be compared on an inverted,
        # tie-dominated ranking.  Only the *exact* run's validity filters:
        # a vertex the approximation left at a sentinel while the exact run
        # resolved it is a miss, and (sign-flipped to -inf) it ranks last
        # in the approx ordering, correctly dragging RBO down.
        mask = approx.engine.state.node_active.cpu().numpy()
        if re_.valid is not None:
            mask = mask & re_.valid
        sign = 1.0 if ra.descending else -1.0
        rbo = rbo_from_scores(
            sign * ra.scores.astype(np.float64),
            sign * re_.scores.astype(np.float64),
            depth=depth, active=mask)
        rows.append({
            "q": q, "vertex_ratio": ra.stats.vertex_ratio,
            "edge_ratio": ra.stats.edge_ratio, "rbo": rbo,
            "speedup": re_.stats.wall_time_s / max(ra.stats.wall_time_s, 1e-9),
            "fallback": ra.stats.overflow_fallback,
        })
        if verbose and (q % 10 == 0 or q == queries - 1):
            rr = rows[-1]
            print(f"q{q:>3}: hot {100*rr['vertex_ratio']:5.2f}%  "
                  f"edges {100*rr['edge_ratio']:5.2f}%  RBO {rbo:.4f}  "
                  f"speedup {rr['speedup']:.2f}x")
    approx.close()
    exact.close()
    if verbose:
        w = rows[1:]  # skip the first query
        print(f"mean: vertex {100*np.mean([x['vertex_ratio'] for x in w]):.2f}% "
              f"edge {100*np.mean([x['edge_ratio'] for x in w]):.2f}% "
              f"RBO {np.mean([x['rbo'] for x in w]):.4f} "
              f"speedup {np.mean([x['speedup'] for x in w]):.2f}x")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synth-citation",
                    choices=sorted(DATASETS))
    ap.add_argument("--algorithm", default="pagerank",
                    choices=sorted(veilgraph.available_algorithms()))
    ap.add_argument("--r", type=float, default=0.2)
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--no-shuffle", action="store_true")
    ap.add_argument("--device", default=None,
                    help="e.g. cpu (default: the CUDA card)")
    args = ap.parse_args()
    run(args.dataset, args.algorithm, args.r, args.n, args.delta, args.queries,
        shuffle=not args.no_shuffle, device=args.device)
