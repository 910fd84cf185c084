#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded phase alone on the card and print its rows.

    python3 tools/sharded_phase.py [--out FILE] [--examples]

Builds the two SpMV sources at the default merge tile (one ``nvcc`` each,
started together), makes the synth-web-lg stream and a serving plan from
``chip_smoke.py``'s seed, and runs ``chip_smoke.sharded_path``: PageRank,
SSSP, CC, the forced-imbalance SSSP stream and one serving wave at 8 edge
shards on a 1-rank NCCL mesh, each against an unsharded session on the
card, then the sharded and unsharded push times and the kernels on a
shard's stream, and last the dry run's sessions on a 1 x 1 ``("data",
"model")`` mesh.  Then the same streams on four ranks of the card
(``chip_smoke.mesh_ranks_path``), and with ``--examples`` the two ported
examples (``chip_smoke.examples_path``).
It prints one JSON line per row (``--out`` also writes them all to FILE)
and a last line with ``ok`` true, or the failed check, the card's name
and power limit and the seconds.  It needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--examples", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tools/sharded_phase.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke as C
    from repro_torch.graph.generators import DATASETS, generate
    from repro_torch.kernels.build import build_library
    from repro_torch.kernels.spmv import kernel as K
    from repro_torch.stream import StreamConfig, build_stream

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda src: build_library(
            src, K.tile_defines(K.DEFAULT_TILE)), (K.SOURCE,
                                                   K.REDUCE_SOURCE)))
    build_s = time.perf_counter() - t0
    spec = DATASETS["synth-web-lg"]
    s, d = generate(spec, seed=C.SEED)
    stream = build_stream(s, d, StreamConfig(stream_size=spec.stream_size,
                                             num_queries=50))
    plan = C.serving_plan(s, d, spec.nodes, np.random.default_rng(C.SEED))
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    try:
        rows, counts, checks, (nd_rows, _), refs = C.sharded_path(
            stream, plan, dev, np.random.default_rng(C.SHARDED_SEED))
        rows = rows + [r for part in checks for r in part] + nd_rows
        rows += C.mesh_ranks_path(stream, refs, dev)[0]
        if args.examples:
            rows += C.examples_path()[0]
    except AssertionError as e:
        print(json.dumps({"ok": False, "failed": str(e),
                          "nvidia_smi": smi}))
        return 1
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"ok": True, "launches": counts, "nvidia_smi": smi,
                      "build_s": build_s,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
