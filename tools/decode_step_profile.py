#!/usr/bin/env python3
"""Where a decode step's device time goes, for the MoE and SSM families at
``chip_smoke.py``'s serving shapes.

For each model of ``chip_smoke.FAMILY_SERVING`` (Mixtral-8x22B with 4 of
its layers, DBRX-132B with 2, Mamba2-2.7B whole; every width as
published, seeded weights held in the activation dtype as the serving
engine holds them), one decode step of ``slots`` rows with the cache at
the served run's midpoint: its device time from 10 steps replayed in one
CUDA graph, its eager time, and a ``torch.profiler`` trace of 5 eager
steps.  From the trace it prints, per step, the device time of each kernel
name and of each aten operation with its input shapes (the top entries),
and for every matrix product the bytes of its weight operand over its
time.  ``weight_bound_ms`` is the bytes of every weight a step reads
(all but the embedding table) over 3.35 TB/s.  One JSON line per model;
``--arch`` picks models.

It needs a CUDA device (about 40 s in all, with the attention builds):

    python3 tools/decode_step_profile.py [--arch mixtral_8x22b ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from math import prod
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
STEPS, TOP = 5, 12


def profile_step(step) -> dict:
    """Device time per step by kernel name and by (aten op, shapes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    kernels, ops = [], []
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3 / STEPS
        if ms <= 0:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"kernel": e.key[:120], "ms": ms,
                            "calls": e.count / STEPS})
    for e in prof.key_averages(group_by_input_shape=True):
        ms = e.self_device_time_total / 1e3 / STEPS
        if ms <= 0 or e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        row = {"op": e.key, "shapes": [list(s) for s in e.input_shapes
                                       if s][:3],
               "ms": ms, "calls": e.count / STEPS}
        if e.key in ("aten::mm", "aten::bmm") and len(row["shapes"]) >= 2:
            weight = prod(row["shapes"][1]) * 2 * row["calls"]
            row["weight_gb_per_s"] = weight / (ms * 1e-3) / 1e9
        ops.append(row)
    total = sum(k["ms"] for k in kernels)
    mm = sum(o["ms"] for o in ops if o["op"] in ("aten::mm", "aten::bmm"))
    return {"kernel_ms_per_step": total, "matmul_ms_per_step": mm,
            "kernels": sorted(kernels, key=lambda k: -k["ms"])[:TOP],
            "ops": sorted(ops, key=lambda o: -o["ms"])[:TOP]}


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as C

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=[arch for _, arch, *_ in C.FAMILY_SERVING])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_step_profile.py needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_library
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.params import (cast_params, init_params,
                                           param_count_actual)
    from repro_torch.models.transformer import init_cache, lm_decode_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for source in (FA.SOURCE, DA.SOURCE):
        build_library(source, ())
    dev = torch.device("cuda")
    for _, arch, layers, _, slots, prompt, new, max_len in C.FAMILY_SERVING:
        if arch not in args.arch:
            continue
        cfg, reduced = C.family_config(arch, layers)
        t0 = time.perf_counter()
        params = cast_params(
            init_params(cfg, torch.Generator(device=dev).manual_seed(C.SEED),
                        dev), getattr(torch, cfg.activation_dtype))
        torch.cuda.empty_cache()
        cache = init_cache(cfg, slots, max_len, device=dev)
        token = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        pos = torch.tensor(prompt + new // 2, dtype=torch.int32, device=dev)
        step = lambda: lm_decode_step(params, cfg, cache, token, pos)
        row = {"model": cfg.name, "reduced": reduced,
               "params": param_count_actual(cfg), "slots": slots,
               "position": prompt + new // 2,
               # every weight but the embedding table (a step gathers
               # `slots` of its rows), unless the head reads it
               "weight_bytes": sum(
                   t.numel() * t.element_size()
                   for name, t in C.flat_tree(params).items()
                   if name != "/embed/tok" or cfg.tie_embeddings),
               "eager_ms": C.cuda_ms(step, reps=10),
               "device_ms": C.graph_ms(step, reps=10),
               **profile_step(step)}
        row["weight_bound_ms"] = row["weight_bytes"] / C.HBM_BYTES_PER_S * 1e3
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del params, cache, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
