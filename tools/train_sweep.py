#!/usr/bin/env python3
"""Which synthetic streams and learning rates make Qwen2-0.5B's loss fall
in 30 steps.

Trains the full-width model (``configs/qwen2_0_5b.py``, f32 params, bf16
activations, remat, AdamW with weight decay 0.1 and clipping at 1.0, the
cosine schedule after 5 warm-up steps) from the same seeded weights for
30 steps at B = 4, S = 2048 on ``SyntheticLMData(lag=1)`` drawn over
``data_vocab`` token ids, once per (data_vocab, lr) point, and prints one
JSON line per point: the 30 losses, the means of the first and last five,
the median step time and the peak memory.  The model's vocabulary stays
151,936 at every point; only the ids the stream draws change.  It is the
sweep behind ``chip_smoke.py``'s TRAIN_DATA_VOCAB and TRAIN_LR.

It needs a CUDA device (about 20 s a point after the flash builds):

    python3 tools/train_sweep.py [--points VOCAB:LR ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: (data_vocab, lr): every id of the model at three rates, then 4,096 ids
POINTS = ("151936:1e-4", "151936:3e-4", "151936:3e-3", "4096:3e-4",
          "4096:1e-3")
STEPS, BATCH, SEQ, WARMUP = 30, 4, 2048, 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", nargs="+", default=list(POINTS),
                    help="data_vocab:lr pairs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           shard_batch)
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import adamw_init, cosine_schedule
    from repro_torch.train.step import make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    dev = torch.device("cuda")
    cfg = get_config("qwen2_0_5b")
    for point in args.points:
        vocab, lr = point.split(":")
        vocab, lr = int(vocab), float(lr)
        data = SyntheticLMData(DataConfig(vocab, SEQ, BATCH, seed=0, lag=1),
                               host_batch=BATCH)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        state = adamw_init(params)
        step = make_train_step(cfg, learning_rate=cosine_schedule(
            lr, WARMUP, STEPS), remat=True)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for s in range(STEPS):
            batch = shard_batch(data.batch_at(s), dev)
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
        print(json.dumps({
            "data_vocab": vocab, "lr": lr, "warmup": WARMUP,
            "losses": losses, "mean_first_5": float(np.mean(losses[:5])),
            "mean_last_5": float(np.mean(losses[-5:])),
            "step_s_median": float(np.median(times[1:])),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
            flush=True)
        del params, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
