#!/usr/bin/env python3
"""Four parts of ``chip_smoke.py`` alone: ``blocked_attention``'s
dynamic offsets through the flash kernels' dynamic entries
(``attention-dynamic``), the attention kernels at Granite-34B's and
Yi-9B's shapes (``DENSE_ATTENTION_CHECKS``), the sharding substrate
(``sharding``: on a checkpoint of Qwen2-0.5B's seeded parameters and
AdamW state written here, where the whole script uses ``lm-train``'s), and
the two models served whole (``lm-serve-granite``, ``lm-serve-yi``), each
as the whole script runs it.  It builds the attention sources first (the
three static libraries and the two dynamic ones, one ``nvcc`` each,
started together; each build's registers and spills are printed) and
prints the card's name and power limit, then one JSON line per row and
each part's wall time.  It needs a CUDA device and ``nvcc``:

    python3 tools/granite_yi_phases.py [--only dynamic|kernels|sharding|serve]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
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


def sharding(dev) -> None:
    """The sharding phase on a checkpoint written here."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import adamw_init

    params = init_params(get_config(C.LM_ARCH), torch.Generator(
        device=dev).manual_seed(C.SEED), dev)
    tmp = tempfile.mkdtemp(prefix="granite_yi_ckpt_")
    try:
        ckpt = CheckpointManager(tmp, async_save=False)
        ckpt.save(C.TRAIN_CKPT_EVERY, {"params": params,
                                       "opt": adamw_init(params)})
        del params
        for row in C.sharding_path(ckpt, C.TRAIN_CKPT_EVERY, dev):
            C.emit(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only",
                        choices=("dynamic", "kernels", "sharding", "serve"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("granite_yi_phases.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    C.emit({"phase": "device", "nvidia_smi": smi})
    t0 = time.perf_counter()
    jobs = [(FA.SOURCE, ()), (FA.BWD_SOURCE, ()), (DA.SOURCE, ()),
            (FA.SOURCE, FA.DYNAMIC_DEFINES),
            (FA.BWD_SOURCE, FA.DYNAMIC_DEFINES)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: build_library(*job), jobs))
    C.emit({"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": [{"library": lib.name, "defines": list(defines),
                           **C.ptxas_summary(lib, full=False)}
                          for lib, (_, defines) in zip(libs, jobs)]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(C.GRANITE_YI_SEED)
    parts = (("dynamic", lambda: C.attention_dynamic_path(dev, rng)[0]),
             ("kernels", lambda: [
                 C.check_attention_kernel(tag, kind, shape, rng, dev)
                 for tag, kind, shape in C.DENSE_ATTENTION_CHECKS]),
             ("sharding", lambda: sharding(dev) or []),
             ("serve", lambda: [row for phase, arch in C.DENSE_SERVING
                                for row in C.lm_serve_dense_path(
                                    phase, arch, dev, rng)[0]]))
    for name, run in parts:
        if args.only not in (None, name):
            continue
        t0 = time.perf_counter()
        C.reset_launch_counts()
        for row in run():
            C.emit(row)
        C.emit({"phase": f"{name}-total", "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
