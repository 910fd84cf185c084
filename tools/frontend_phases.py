#!/usr/bin/env python3
"""The encoder-decoder (SeamlessM4T-large-v2) and vision-frontend
(InternVL2-2B) part of ``chip_smoke.py`` alone: the attention kernels at
those families' shapes (``FRONTEND_ATTENTION_CHECKS``), the flash backward
at their training shapes (``FRONTEND_BWD_CHECKS``), then the phases
``lm-serve-encdec``, ``lm-serve-vlm``, ``lm-train-encdec`` and
``lm-train-vlm``, each as the whole script runs it.  It builds the three
attention sources first (one ``nvcc`` each, started together) and prints
the card's name and power limit, then one JSON line per row, each
phase's wall time and the build's.  It needs a CUDA device and
``nvcc``:

    python3 tools/frontend_phases.py [--only kernels|serve|train]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.build import build_library  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DA  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=("kernels", "serve", "train"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("frontend_phases.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    C.emit({"phase": "device", "nvidia_smi": smi})
    t0 = time.perf_counter()
    sources = (FA.SOURCE, FA.BWD_SOURCE, DA.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda src: build_library(src, ()), sources))
    C.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.only in (None, "kernels"):
        t0 = time.perf_counter()
        rng = np.random.default_rng(C.FRONTEND_SEED)
        for tag, kind, shape in C.FRONTEND_ATTENTION_CHECKS:
            C.emit(C.check_attention_kernel(tag, kind, shape, rng, dev))
        for tag, shape, dtype, timed in C.FRONTEND_BWD_CHECKS:
            C.emit(C.check_flash_backward(tag, shape, dtype, rng, dev,
                                          timed))
        C.emit({"phase": "frontend-kernels-total",
                "wall_s": time.perf_counter() - t0})
    rng = np.random.default_rng(C.SEED)
    if args.only in (None, "serve"):
        for phase, arch, *shape in C.FRONTEND_SERVING:
            t0 = time.perf_counter()
            rows, _ = C.lm_serve_frontend_path(phase, arch, *shape, dev, rng)
            for row in rows:
                C.emit(row)
            C.emit({"phase": f"{phase}-total", "model": arch,
                    "wall_s": time.perf_counter() - t0})
    if args.only in (None, "train"):
        for phase, arch, *shape in C.FRONTEND_TRAINING:
            t0 = time.perf_counter()
            rows, _ = C.lm_train_family_path(phase, arch, *shape, dev)
            for row in rows:
                C.emit(row)
            C.emit({"phase": f"{phase}-total", "model": arch,
                    "wall_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
