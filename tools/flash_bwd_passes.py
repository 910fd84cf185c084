#!/usr/bin/env python3
"""Where the flash backward's time goes: the device time of each of its
two passes (the dq pass, the dk/dv pass) at ``chip_smoke.py``'s timed
backward shapes, read from a ``torch.profiler`` trace of ten calls.

For every timed row of ``chip_smoke.FLASH_BWD_CHECKS`` it prints one JSON
line: each pass's mean device ms a call (``not measured`` where the
profiler shows no device time), their sum, the bound
(``chip_smoke.flash_bwd_bound``), and, from the shape alone, how many
steps of query rows the dk/dv pass's blocks take (the longest block and
the mean: under a causal mask the first keys' blocks see every row, and
when the blocks are fewer than the card holds at once, the longest sets
the pass's time).  It needs a CUDA device and ``nvcc``:

    python3 tools/flash_bwd_passes.py [--reps N]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402

#: the dk/dv pass's keys a block (``tc::kKeys`` in
#: ``csrc/flash_attention_bwd.cu``)
DKV_KEYS = 64


def dkv_steps(shape) -> dict:
    """Steps of query rows each dk/dv block takes (the kernel's row
    range per key tile), the longest and the mean over the blocks."""
    b, s, h, kv, hd, vd, causal, window = shape
    groups = h // kv
    step = 32 if hd + vd >= 224 else 64  # tc::row_step
    rows = s * groups
    steps = []
    for k0 in range(0, s, DKV_KEYS):
        k_last = min(k0 + DKV_KEYS, s) - 1
        f_lo = min(k0 * groups, rows) if causal else 0
        f_hi = min((k_last + window) * groups, rows) if window else rows
        steps.append(max(0, -(-(f_hi - f_lo) // step)))
    return {"rows_a_step": step, "blocks": len(steps) * b * kv,
            "steps_longest_block": max(steps),
            "steps_mean": float(np.mean(steps))}


def pass_ms(fn, reps: int) -> dict:
    """Mean device ms a call of each pass over ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        key = ("dq" if "flash_bwd_dq_kernel" in evt.key else
               "dkv" if "flash_bwd_dkv_kernel" in evt.key else None)
        if key is None:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        out[key] = out.get(key, 0.0) + us / reps / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tools/flash_bwd_passes.py needs a CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for tag, shape, dtype, timed in C.FLASH_BWD_CHECKS:
        if not timed:
            continue
        b, s, h, kv, hd, vd, causal, window = shape
        rng = np.random.default_rng(C.SEED)
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(
            np.float32)).to(dev, dt) for d in ((b, s, h, hd), (b, s, kv, hd),
                                               (b, s, kv, vd)))
        dout = torch.from_numpy(rng.standard_normal((b, s, h, vd)).astype(
            np.float32)).to(dev)
        opts = dict(causal=causal, window=window)
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **opts)
        ms = pass_ms(lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    **opts), args.reps)
        bound = C.flash_bwd_bound(b, s, h, kv, hd, vd, causal, window,
                                  q.element_size())
        print(json.dumps({
            "shape": tag, "dims": list(shape), "dtype": dtype,
            "dq_pass_ms": ms.get("dq", "not measured"),
            "dkv_pass_ms": ms.get("dkv", "not measured"),
            "sum_ms": sum(ms.values()) if len(ms) == 2 else "not measured",
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "dkv_pass": dkv_steps(shape),
            "timing": f"torch.profiler device time, mean of {args.reps} "
                      f"calls after 3",
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
