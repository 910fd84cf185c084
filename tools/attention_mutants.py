#!/usr/bin/env python3
"""Mutation check of the bf16 limits that ``chip_smoke.py`` holds the
attention kernels to.

Each mutant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` with one
fault planted in the CUDA sources, a fault that only the bf16
instantiations see.  The script builds every copy (one subprocess each, run
together) and runs ``chip_smoke.py``'s checks there in bf16, the f64 plain
versions as the oracle:

- a forward mutant (flash forward, decode) runs the attention checks
  (``ATTENTION_CHECKS``: their shapes, the model path's calls).  For every
  shape it prints the max abs error, its largest share of the limit
  (``ATTN_BF16_ATOL + ATTN_BF16_RTOL |ref|``), and whether the kernel
  passes that limit and the earlier one (``2e-2 + 2e-2 |ref|``);
- a backward mutant (the flash backward's tensor-core passes) runs
  ``check_flash_backward`` on the bf16 rows of ``FLASH_BWD_CHECKS``, all
  but Mixtral's (one process per copy shares the card), in reporting mode.
  For every row it prints each checked value's share of its fixed limit
  (lse, the f32 output, dq, dk, dv), the largest, and the bitwise checks.

The unchanged copy runs both and must pass everywhere; each mutant must
fail somewhere, or the script exits 1.  It needs a CUDA device and
``nvcc``:

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
from typing import NamedTuple

REPO = Path(__file__).resolve().parent.parent
EARLIER_LIMIT = 2e-2
FLASH = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
BWD = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
DECODE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
COMMON = "src/repro_torch/kernels/attention_common.cuh"


class Mutant(NamedTuple):
    """One planted fault: ``text`` in ``path`` becomes ``replacement``;
    ``checks`` is ``"forward"`` or ``"backward"``."""
    path: str
    text: str
    replacement: str
    checks: str


#: name -> its mutant (``None``: the unchanged copy).  ``sizeof(T) == 2``
#: is bf16 only, and so are all of the flash kernels' tensor-core paths
MUTANTS = {
    "none": None,
    "bf16-output-rounds-toward-zero": Mutant(
        COMMON, "return __float2bfloat16_rn(x);",
        "return __float2bfloat16_rz(x);", "forward"),
    # n is the valid length the cluster's CTAs split: one more slot lands
    # in the last busy CTA's share
    "decode-bf16-reads-one-slot-past-cache-len": Mutant(
        DECODE, "const int n = max(0, min(__ldg(cache_len), s));",
        "const int n = max(0, min(__ldg(cache_len) + (sizeof(T) == 2), s));",
        "forward"),
    # the bf16 forward's mask (hop::allowed) lets a row see one key more
    # at its window's far edge
    "flash-bf16-window-one-key-wider": Mutant(
        FLASH, "(window <= 0 || pos - key < window)",
        "(window <= 0 || pos - key <= window)", "forward"),
    # P enters P.V rounded once to bf16 (its low term is 0): `split`, which
    # makes the forward's register A fragments of P.V (hop::split_p) and
    # decode's two terms
    "flash-bf16-p-rounded-once": Mutant(
        COMMON, "  lo = take_bf16x2(x, y);", "  lo = 0u;", "forward"),
    # the dk/dv pass's dS enters dS^T q rounded once (its other terms
    # dropped), in the static and the dynamic entries alike
    "flash-bwd-bf16-ds-rounded-once": Mutant(
        BWD, "mma_fab<N / 16, HK / 8, kTerms>(acc_k, s, qt, QS);",
        "mma_fab<N / 16, HK / 8, 1>(acc_k, s, qt, QS);", "backward"),
    # dv += P^T dO without its P_1 dO_2 term: dO enters dv rounded once
    "flash-bwd-bf16-dv-drops-do-lo": Mutant(
        BWD, "    mma_fab<N / 16, VD / 8, 1>(acc_v, s, dot + N * VS, VS);\n",
        "", "backward"),
    # the dq pass's S = q K^T without its last 16-column k-step at hd 112
    # and hd 24 (staged as 32: columns 16-23 are real)
    "flash-bwd-bf16-last-k-step-dropped-at-hd-112-and-24": Mutant(
        BWD, "mma_abt<HK, kKeys / 8, 1, 1>(s, qw, QS, 0, kt, QS, 0);",
        "mma_abt<HK - 16 * (HD == 112 || HD == 24), kKeys / 8, 1, 1>"
        "(s, qw, QS, 0, kt, QS, 0);", "backward"),
    # both tensor-core passes let a row see one key more at its window's
    # far edge
    "flash-bwd-bf16-window-one-key-wider": Mutant(
        BWD, "const tc::Masks masks{skv, causal, window};",
        "const tc::Masks masks{skv, causal, window > 0 ? window + 1 : 0};",
        "backward"),
}

CHECK_FORWARD = r"""
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

CHECK_BACKWARD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as C
dev = torch.device("cuda")
rng = np.random.default_rng(C.SEED)
for tag, shape, dtype, _ in C.FLASH_BWD_CHECKS:
    if dtype != "bfloat16" or shape == C.MIXTRAL_BWD_SHAPE:
        continue
    row = C.check_flash_backward(tag, shape, dtype, rng, dev, False,
                                 strict=False)
    share = max(row["share_of_limit"].values())
    print(json.dumps({"kernel": "flash_bwd", "shape": tag,
                      "max_abs_err": row["max_abs_err"],
                      "share_of_limit": share,
                      "shares": row["share_of_limit"],
                      "bitwise_second_launch": row["bitwise_second_launch"],
                      "out_bitwise_vs_no_lse_launch":
                          row["out_bitwise_vs_no_lse_launch"],
                      "passes_limit": row["passes"],
                      "limit": row["tolerance"]}), flush=True)
    torch.cuda.empty_cache()
"""
CHECKS = {"forward": CHECK_FORWARD, "backward": CHECK_BACKWARD}


def make_copy(root: Path, name: str, mutant) -> Path:
    copy = root / name
    shutil.copytree(REPO / "src" / "repro_torch", copy / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", copy / "chip_smoke.py")
    if mutant is not None:
        text = (copy / mutant.path).read_text()
        if text.count(mutant.text) != 1:
            raise SystemExit(f"{name}: {mutant.text!r} is not found once in "
                             f"{mutant.path}")
        (copy / mutant.path).write_text(
            text.replace(mutant.text, mutant.replacement))
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
    for name, mutant in MUTANTS.items():
        copy = make_copy(root, name, mutant)
        env = dict(os.environ, PYTHONPATH=str(copy / "src"))
        kinds = ("forward", "backward") if mutant is None else (
            mutant.checks,)
        procs[name] = [subprocess.Popen(
            [sys.executable, "-c", CHECKS[kind]], cwd=copy, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for kind in kinds]
    failures = []
    for name, group in procs.items():
        out, err, returncode = "", "", 0
        for proc in group:
            o, e = proc.communicate(timeout=900)
            out, err = out + o, err + e
            returncode = returncode or proc.returncode
        rows = [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]
        for row in rows:
            print(json.dumps({"mutant": name, **row}))
        complete = returncode == 0 and len(rows) > 0
        caught = any(not r["passes_limit"] for r in rows)
        verdict = {"mutant": name, "returncode": returncode,
                   "caught": caught,
                   "worst_share_of_limit": max(r["share_of_limit"]
                                               for r in rows) if rows
                   else None}
        if any("passes_earlier_limit" in r for r in rows):
            verdict["caught_by_earlier_limit"] = any(
                not r["passes_earlier_limit"] for r in rows
                if "passes_earlier_limit" in r)
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
