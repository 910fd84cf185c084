#!/usr/bin/env python3
"""The bf16 flash backward at MQA heads, static entry beside the dynamic
one: each gradient's worst share of ``chip_smoke.py``'s fixed bf16 limit
(|err| <= 1e-5 max|ref| + 5e-3 |ref| against the f64 plain version, the
``flash-bwd-kernel`` rows' limit) and how many elements pass it.

At Granite-34B's heads (48 query heads on one KV head, hd 128) every key's
dk and dv sum G x Sq rows; both entries add each 16-column step's
products into a fresh fragment and that into the sum in f32
(``flash_attention_bwd.cu``'s ``mma_fab``), where one chain of
tensor-core adds drifted past the limits.  The cases:
1,024 queries over 4,160 keys not causal, and causal at S = 1,024, both
entries (the dynamic one at zero offsets, where it computes the static
masks), then the dynamic entry at G = 8 and at ``chip_smoke.py``'s
Granite offsets.  It needs a CUDA device and ``nvcc``:

    python3 tools/mqa_backward_check.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels.build import build_library  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402

#: (tag, (B, Sq, Skv, H, KV, hd, causal), offsets or None for the static
#: entry)
CASES = (
    ("static, 48/1, 1,024 over 4,160, not causal",
     (1, 1024, 4160, 48, 1, 128, False), None),
    ("dynamic at zero offsets, 48/1, 1,024 over 4,160, not causal",
     (1, 1024, 4160, 48, 1, 128, False), (0, 0, None)),
    ("static, 48/1, S = 1,024, causal", (1, 1024, 1024, 48, 1, 128, True),
     None),
    ("dynamic at zero offsets, 48/1, S = 1,024, causal",
     (1, 1024, 1024, 48, 1, 128, True), (0, 0, None)),
    ("dynamic, 8/1, 1,024 at 3,136 over 4,160, valid 4,100",
     (1, 1024, 4160, 8, 1, 128, True), (3136, 0, 4100)),
    ("dynamic, 48/1, 1,024 at 3,136 over 4,160, valid 4,100",
     (1, 1024, 4160, 48, 1, 128, True), (3136, 0, 4100)),
)


def check(tag, shape, offsets, dev) -> dict:
    b, sq, skv, h, kv, hd, causal = shape
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
               .to(dev, torch.bfloat16)
               for d in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    dout = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(
        np.float32)).to(dev, torch.bfloat16).float()
    if offsets is None:
        out, lse = FA.flash_attention(q, k, v, return_lse=True, causal=causal)
        got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        offs = None
    else:
        offs = FA.Offsets(*(None if x is None else torch.tensor(
            x, dtype=torch.int32, device=dev) for x in offsets))
        out, lse = FA.flash_attention_dynamic(q, k, v, offs, causal=causal)
        got = FA.flash_attention_bwd_dynamic(q, k, v, out, lse, dout, offs,
                                             causal=causal)
    want = FA.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, dtype=torch.float64, q_block=512,
        kv_block=1024, offsets=offs, causal=causal)
    row = {"case": tag, "dims": list(shape), "offsets": offsets}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.double() - w).abs()
        share = err / (1e-5 * float(w.abs().max()) + 5e-3 * w.abs())
        row[name] = {"share_of_limit": float(share.max()),
                     "elements_past_limit": int((share > 1).sum()),
                     "max_abs_err": float(err.max()),
                     "max_abs_ref": float(w.abs().max())}
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("mqa_backward_check.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    jobs = [(FA.SOURCE, ()), (FA.BWD_SOURCE, ()),
            (FA.SOURCE, FA.DYNAMIC_DEFINES),
            (FA.BWD_SOURCE, FA.DYNAMIC_DEFINES)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build_library(*job), jobs))
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, shape, offsets in CASES:
        print(json.dumps(check(tag, shape, offsets, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
