#!/usr/bin/env python3
"""The flash attention kernels of two trees, timed in turns in one call.

For each ``--src`` (a ``src/`` directory holding a ``repro_torch``), in the
order given and then in the reverse order (``a b`` runs ``a, b, b, a``), a
subprocess imports that tree's kernels and prints one JSON line per shape,
every time the device time of 20 calls replayed from one CUDA graph
(``chip_smoke.graph_ms``):

- ``fwd``: the bf16 forward (``flash_attention``) at the published models'
  prefill shapes (DBRX, Granite-34B, Yi-9B, Zamba2-7B, MiniCPM3-4B,
  Qwen2-0.5B, Mixtral-8x22B past its window), beside its eager time,
  ``scaled_dot_product_attention`` on the same inputs, the operations
  bound, and its bf16 error against the f64 plain version as a share of
  ``chip_smoke.py``'s limit; and the dynamic entry
  (``flash_attention_dynamic``) at ``chip_smoke.DYNAMIC_CHECKS``' Qwen2
  and Granite rows, beside SDPA with the call's boolean mask;
- ``bwd``: the bf16 backward (``flash_attention_bwd``) at its timed
  training shapes (Qwen2-0.5B, Zamba2-7B, MiniCPM3-4B, InternVL2-2B,
  Mixtral-8x22B), beside the forward with lse that feeds it.

Every tree's libraries are built first, one ``nvcc`` per source and tree,
all started together.  It needs a CUDA device and ``nvcc``:

    python3 tools/flash_compare.py --src artifacts/.parent/src --src src \\
        [--only fwd|bwd] [--out FILE]

Unpack another commit to compare with ``git archive`` under a directory
that ``.gitignore`` lists (``artifacts/.parent``: a leading dot keeps
pytest from collecting it).
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

#: (tag, (B, S, H, KV, hd, vd, causal, window[, Skv]))
FWD_SHAPES = (
    ("DBRX-132B, B=4, S=2048, 48/8 x 128", (4, 2048, 48, 8, 128, 128, True,
                                             None)),
    ("Granite-34B, B=1, S=4096, 48/1 x 128", (1, 4096, 48, 1, 128, 128,
                                               True, None)),
    ("Yi-9B, B=1, S=4096, 32/4 x 128", (1, 4096, 32, 4, 128, 128, True,
                                         None)),
    ("Zamba2-7B, B=1, S=4096, 32/32 x 112", (1, 4096, 32, 32, 112, 112,
                                              True, None)),
    ("MiniCPM3-4B, B=1, S=4096, 40/40, hd 96, vd 64",
     (1, 4096, 40, 40, 96, 64, True, None)),
    ("Qwen2-0.5B, B=1, S=4096, 14/2 x 64", (1, 4096, 14, 2, 64, 64, True,
                                             None)),
    ("Mixtral-8x22B, B=1, S=6144, 48/8 x 128, window 4096",
     (1, 6144, 48, 8, 128, 128, True, 4096)),
)
#: the dynamic rows of chip_smoke.DYNAMIC_CHECKS timed here (by index)
DYNAMIC_ROWS = (0, 2)
#: (tag, (B, S, H, KV, hd, vd, causal, window))
BWD_SHAPES = (
    ("Qwen2-0.5B training, B=4, S=2048, 14/2 x 64",
     (4, 2048, 14, 2, 64, 64, True, None)),
    ("Zamba2-7B training, B=4, S=2048, 32/32 x 112",
     (4, 2048, 32, 32, 112, 112, True, None)),
    ("MiniCPM3-4B training, B=4, S=2048, 40/40, hd 96, vd 64",
     (4, 2048, 40, 40, 96, 64, True, None)),
    ("InternVL2-2B training, B=4, S=2048, 16/8 x 128",
     (4, 2048, 16, 8, 128, 128, True, None)),
    ("Mixtral-8x22B training, B=4, S=6144, 48/8 x 128, window 4096",
     (4, 6144, 48, 8, 128, 128, True, 4096)),
)


def inputs(dims, dev, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(d).astype(np.float32))
            .to(dev, torch.bfloat16) for d in dims]


def forward_rows(src, turn, dev):
    import torch
    import torch.nn.functional as F

    import chip_smoke as C
    from repro_torch.kernels.flash_attention import kernel as FA

    for tag, shape in FWD_SHAPES:
        dims, run, plain, pairs, bound, library = C.attention_case(
            "flash", shape, dev)
        q, k, v = inputs(dims, dev)
        share = C.max_excess(run(q, k, v), plain(q, k, v, torch.float64),
                             C.ATTN_BF16_ATOL, C.ATTN_BF16_RTOL)[1]
        ms = C.graph_ms(lambda: run(q, k, v))
        row = {"part": "fwd", "src": src, "turn": turn, "shape": tag,
               "dims": list(shape), "kernel_ms": ms,
               "kernel_eager_ms": C.cuda_ms(lambda: run(q, k, v)),
               "library_ms": C.graph_ms(library(q, k, v)[0]),
               "bf16_share_of_limit": share, **bound,
               "roofline_share": bound["bound_ms"] / ms}
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    for i in DYNAMIC_ROWS:
        tag, shape, offsets = C.DYNAMIC_CHECKS[i]
        b, sq, skv, h, kv, hd, causal, window = shape
        q, k, v = inputs(((b, sq, h, hd), (b, skv, kv, hd),
                          (b, skv, kv, hd)), dev)
        offs = FA.Offsets(*(torch.tensor(x, dtype=torch.int32, device=dev)
                            for x in offsets))
        opts = dict(causal=causal, window=window)
        call = lambda: FA.flash_attention_dynamic(q, k, v, offs, **opts)
        out = call()[0]
        ref = FA.flash_attention_plain(q, k, v, dtype=torch.float64,
                                       offsets=offs, q_block=512,
                                       kv_block=1024, **opts)
        mask = C.dynamic_allowed(sq, skv, causal, window, offsets, dev)
        pairs = int(mask.sum()) * b
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ops = 2 * 2 * hd * h * pairs
        nbytes = (2 * (b * sq * h * hd + 2 * b * skv * kv * hd)
                  + 4 * (b * sq * h * hd + b * h * sq))
        bound_ms = max(nbytes / C.HBM_BYTES_PER_S, ops / C.BF16_FLOPS) * 1e3
        ms = C.graph_ms(call)
        print(json.dumps({
            "part": "fwd-dynamic", "src": src, "turn": turn, "shape": tag,
            "dims": list(shape), "offsets": list(offsets), "kernel_ms": ms,
            "kernel_eager_ms": C.cuda_ms(call),
            "library_ms": C.graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "f32_out_share_of_limit": C.max_excess(
                out, ref, C.BWD_OUT_TOL["bfloat16"])[1],
            "operations": ops, "bytes": nbytes, "bound_ms": bound_ms,
            "roofline_share": bound_ms / ms}), flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def backward_rows(src, turn, dev):
    import numpy as np
    import torch

    import chip_smoke as C
    from repro_torch.kernels.flash_attention import kernel as FA

    for tag, shape in BWD_SHAPES:
        b, s, h, kv, hd, vd, causal, window = shape
        q, k, v = inputs(((b, s, h, hd), (b, s, kv, hd), (b, s, kv, vd)),
                         dev)
        dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (b, s, h, vd)).astype(np.float32)).to(dev)
        opts = dict(causal=causal, window=window)
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **opts)
        bwd = lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout, **opts)
        bound = C.flash_bwd_bound(b, s, h, kv, hd, vd, causal, window, 2, s)
        ms = C.graph_ms(bwd)
        print(json.dumps({
            "part": "bwd", "src": src, "turn": turn, "shape": tag,
            "dims": list(shape), "kernel_ms": ms,
            "fwd_lse_ms": C.graph_ms(lambda: FA.flash_attention(
                q, k, v, return_lse=True, **opts)),
            **bound, "roofline_share": bound["bound_ms"] / ms}), flush=True)
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()


def worker(src: Path, turn: int, only) -> int:
    import torch

    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(1, str(REPO))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if only in (None, "fwd"):
        forward_rows(str(src), turn, dev)
    if only in (None, "bwd"):
        backward_rows(str(src), turn, dev)
    return 0


def build(src: Path) -> None:
    """Every flash library of the tree at ``src``, one nvcc per source
    and define set, started together."""
    code = (
        "import sys\nfrom concurrent.futures import ThreadPoolExecutor\n"
        f"sys.path.insert(0, {str(src.resolve())!r})\n"
        "from repro_torch.kernels.build import build_library\n"
        "from repro_torch.kernels.flash_attention import kernel as FA\n"
        "jobs = [(s, d) for s in (FA.SOURCE, FA.BWD_SOURCE)\n"
        "        for d in ((), FA.DYNAMIC_DEFINES)]\n"
        "with ThreadPoolExecutor(len(jobs)) as pool:\n"
        "    list(pool.map(lambda j: build_library(*j), jobs))\n")
    subprocess.run([sys.executable, "-c", code], check=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, action="append", required=True,
                    help="a src/ directory; give it once per tree")
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None)
    ap.add_argument("--out", type=Path, default=None,
                    help="also append every line to this file")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.src[0], args.worker, args.only)
    import torch

    if not torch.cuda.is_available():
        print("flash_compare.py needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(args.src)) as pool:
        list(pool.map(build, args.src))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    head = {"phase": "flash-compare", "device": smi,
            "build_s": time.perf_counter() - t0,
            "order": [str(s) for s in args.src + args.src[::-1]]}
    lines = [json.dumps(head)]
    print(lines[-1], flush=True)
    for turn, src in enumerate(args.src + args.src[::-1]):
        cmd = [sys.executable, __file__, "--src", str(src), "--worker",
               str(turn)] + (["--only", args.only] if args.only else [])
        out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                             cwd=REPO).stdout
        for line in out.splitlines():
            print(line, flush=True)
            lines.append(line)
    if args.out:
        with args.out.open("a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
