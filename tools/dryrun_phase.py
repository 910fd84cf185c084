#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s dry run phases alone on the card and print their
rows.

    python3 tools/dryrun_phase.py [--only graph|lm] [--out FILE]

Builds the SpMV sources at the default merge tile and the flash forward,
backward and decode sources (one ``nvcc`` each, started together), then
runs ``chip_smoke.dryrun_graph_path`` (the veilgraph dry run cell at N =
2^25, E = 2^30 as rank 0 of a fake group of 256, its gates, and one
shard push timed against its modeled bytes) and
``chip_smoke.dryrun_lm_path`` (Qwen2-0.5B's train, prefill and decode
cells on DTensor parameters over a 1 x 1 NCCL mesh, each bitwise the
plain-tensor step, with its roofline record and device time).  The 2-D
mesh sessions run in ``tools/sharded_phase.py``.  It prints one JSON line
per row (``--out`` also writes them to FILE) and a last line with ``ok``
true, or the failed check, the card's name and power limit and the
seconds.  It needs a CUDA device and ``nvcc``.
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
    ap.add_argument("--only", choices=["graph", "lm"])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tools/dryrun_phase.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke as C
    from repro_torch.kernels.build import build_library
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.spmv import kernel as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    jobs = [(K.SOURCE, K.tile_defines(K.DEFAULT_TILE)),
            (K.REDUCE_SOURCE, K.tile_defines(K.DEFAULT_TILE)),
            (FA.SOURCE, ()), (FA.BWD_SOURCE, ()), (DA.SOURCE, ())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build_library(*job), jobs))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rows, counts = [], {}
    try:
        for part, fn in (("graph", C.dryrun_graph_path),
                         ("lm", C.dryrun_lm_path)):
            if args.only in (None, part):
                got, counts[part] = fn(dev)
                rows += got
                for r in got:
                    print(json.dumps(r), flush=True)
    except AssertionError as e:
        print(json.dumps({"ok": False, "failed": str(e),
                          "nvidia_smi": smi}))
        return 1
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(json.dumps({"ok": True, "launches": counts, "nvidia_smi": smi,
                      "build_s": build_s,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
