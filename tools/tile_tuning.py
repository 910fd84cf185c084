#!/usr/bin/env python3
"""The tile the merge-tile tuner picks for synth-web-lg's PageRank
layout, against each tile's device time on that layout (card only).

    python3 tools/tile_tuning.py [--src DIR]

Builds every tile of ``spmv_push.cu`` (one ``nvcc`` each, started
together), then for the full ``inv_out`` layout with f32 and with bf16
weights prints one JSON line: the tile a ``"full"`` tuning picks when it
times the layout itself (as the engine does), and each tile's device time
on the layout (20 pushes replayed from a CUDA graph, inputs warm in L2)
beside its bound (``repro_torch.launch.roofline``).  ``--src`` runs another copy of the port's ``src/`` (e.g. a
``git archive`` under ``artifacts/``).  About a minute after the builds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls replayed from one
    CUDA graph, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tile_tuning.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core.backend import build_layout
    from repro_torch.graph.generators import DATASETS, generate
    from repro_torch.graph.graph import from_edges
    from repro_torch.kernels.build import build_library
    from repro_torch.kernels.spmv import autotune as AT
    from repro_torch.kernels.spmv import kernel as K
    from repro_torch.launch.roofline import push_roofline_check

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(K.TILES)) as pool:
        list(pool.map(lambda t: build_library(K.SOURCE, K.tile_defines(t)),
                      K.TILES))
    print(json.dumps({"device": smi, "build_s": time.perf_counter() - t0}),
          flush=True)
    dev = torch.device("cuda")
    spec = DATASETS["synth-web-lg"]
    src, dst = generate(spec, seed=0)
    state = from_edges(src, dst, spec.nodes, src.shape[0], device=dev)
    values = torch.from_numpy(np.random.default_rng(0).random(
        spec.nodes).astype(np.float32)).to(dev)
    platform = torch.cuda.get_device_name(0)
    for wd in (None, "bfloat16"):
        lay = build_layout(state, weight_dtype=wd)
        key = AT.TuneKey(e_pad=state.edge_capacity, n=spec.nodes, b=1,
                         dtype="float32", reduce="sum", platform=platform,
                         w_itemsize=2 if wd else 4)
        AT.clear_cache()
        real = AT.tune(key, "full", sample=(lay.src, lay.weight,
                                            lay.row_offsets))
        AT.clear_cache()
        times = {t: graph_ms(lambda t=t: K.spmv_push(
            values, lay.src, lay.weight, lay.row_offsets, tile=t))
                 for t in K.TILES}
        print(json.dumps({
            "layout": f"synth-web-lg inv_out {wd or 'float32'}",
            "bound_ms": push_roofline_check(
                edge_capacity=int(lay.row_offsets[-1]),
                num_segments=spec.nodes, weight_dtype=wd,
                platform=platform)["bound_time_s"] * 1e3,
            "full_pick_on_the_layout": real,
            "fastest_on_the_layout": min(times, key=times.get),
            "device_ms": {str(t): ms for t, ms in times.items()},
            "timing": "20 pushes replayed from one CUDA graph"}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
