#!/usr/bin/env python3
"""Mutation check of the bf16 limit that ``chip_smoke.py`` holds the two
attention kernels to.

Each mutant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` with one
fault planted in the CUDA sources, a fault that only the bf16
instantiations see.  The script builds every copy (one subprocess each, run
together) and runs ``chip_smoke.py``'s attention checks there in bf16: its
shapes, the model path's calls, the f64 plain version as the oracle.  For
every shape it prints the max abs error, its largest share of
``chip_smoke.py``'s limit (``ATTN_BF16_ATOL + ATTN_BF16_RTOL |ref|``), and
whether the kernel passes that limit and the earlier one (``2e-2 + 2e-2
|ref|``).  The unchanged copy must pass
everywhere and each mutant must fail somewhere, or the script exits 1.
It needs a CUDA device and ``nvcc``:

    python3 tools/attention_mutants.py [--workdir DIR]

The copies go under DIR (by default a new temporary directory), never
into the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EARLIER_LIMIT = 2e-2
FLASH = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
DECODE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
COMMON = "src/repro_torch/kernels/attention_common.cuh"
#: name -> (file, text, its replacement); ``sizeof(T) == 2`` is bf16 only,
#: and so is all of the flash kernel's tensor-core path
MUTANTS = {
    "none": None,
    "bf16-output-rounds-toward-zero": (
        COMMON, "return __float2bfloat16_rn(x);",
        "return __float2bfloat16_rz(x);"),
    # n is the valid length the cluster's CTAs split: one more slot lands
    # in the last busy CTA's share
    "decode-bf16-reads-one-slot-past-cache-len": (
        DECODE, "const int n = max(0, min(__ldg(cache_len), s));",
        "const int n = max(0, min(__ldg(cache_len) + (sizeof(T) == 2), s));"),
    "flash-bf16-window-one-key-wider": (
        FLASH, "(window <= 0 || pos - key < window)",
        "(window <= 0 || pos - key <= window)"),
    # P enters P.V rounded once to bf16 (its low term is 0)
    "flash-bf16-p-rounded-once": (
        FLASH, "__floats2bfloat162_rn(x - hf.x, y - hf.y)",
        "__floats2bfloat162_rn(0.0f, 0.0f)"),
}

CHECK = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as C
dev = torch.device("cuda")
for tag, kind, shape in C.ATTENTION_CHECKS:
    dims, run, plain = C.attention_case(kind, shape, dev)[:3]
    rng = np.random.default_rng(C.SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
               .to(dev, torch.bfloat16) for d in dims)
    out = run(q, k, v)
    ref = plain(q, k, v, torch.float64)
    err, share = C.max_excess(out, ref, C.ATTN_BF16_ATOL, C.ATTN_BF16_RTOL)
    share_earlier = C.max_excess(out, ref, %r)[1]
    print(json.dumps({"kernel": kind, "shape": tag, "max_abs_err": err,
                      "share_of_limit": share,
                      "passes_limit": share <= 1,
                      "passes_earlier_limit": share_earlier <= 1,
                      "limit": {"atol": C.ATTN_BF16_ATOL,
                                "rtol": C.ATTN_BF16_RTOL}}), flush=True)
""" % EARLIER_LIMIT


def make_copy(root: Path, name: str, mutation) -> Path:
    copy = root / name
    shutil.copytree(REPO / "src" / "repro_torch", copy / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", copy / "chip_smoke.py")
    if mutation is not None:
        path, old, new = mutation
        text = (copy / path).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not found once in {path}")
        (copy / path).write_text(text.replace(old, new))
    return copy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", type=Path, default=None,
                    help="where the copies go (default: a temporary "
                         "directory, removed afterwards)")
    args = ap.parse_args()
    root = args.workdir or Path(tempfile.mkdtemp(prefix="attn_mutants_"))
    root.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, mutation in MUTANTS.items():
        copy = make_copy(root, name, mutation)
        env = dict(os.environ, PYTHONPATH=str(copy / "src"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", CHECK], cwd=copy, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    failures = []
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        rows = [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]
        for row in rows:
            print(json.dumps({"mutant": name, **row}))
        complete = proc.returncode == 0 and len(rows) > 0
        caught = any(not r["passes_limit"] for r in rows)
        verdict = {"mutant": name, "returncode": proc.returncode,
                   "caught": caught,
                   "caught_by_earlier_limit": any(
                       not r["passes_earlier_limit"] for r in rows)}
        print(json.dumps(verdict))
        if not complete:
            print(err[-4000:], file=sys.stderr)
            failures.append(name)
        elif caught == (name == "none"):
            failures.append(name)
    if args.workdir is None:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": not failures, "failed": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
