#!/usr/bin/env python3
"""Where decode attention's device time goes.

At Qwen2-0.5B's decode shape (bf16, B = 8, S = 4096 cache slots, 14 heads,
2 KV heads, head dim 64), every time from a replayed CUDA graph
(``chip_smoke.graph_ms``), one JSON line per point:

- the sweep: ``decode_attention`` of the tree given by ``--src`` at
  ``cache_len`` 128, 1024, 2100 and 4096, beside
  ``scaled_dot_product_attention`` over the valid slots and the byte
  bound, with the kernel nodes one call captures.  Where that tree's
  wrapper plans a split of the cache (a module-level ``split_plan``: the
  two-launch design of a split kernel and a combine, which the one-launch
  kernel replaced), it also times the split kernel alone, with the plan
  forced to one split of all S slots, which skips the combine;
- the pieces (``--pieces``): copies of this checkout's kernel source, each
  with a part of the kernel cut out, built apart (one ``nvcc`` each, all
  started together, every copy instantiated at hd = vd = 64 only) and
  timed at ``cache_len`` 128 and 4096.  A cut copy's output is not
  checked: it only says what the part it lacks costs.

It needs a CUDA device and ``nvcc``:

    python3 tools/decode_sweep.py [--src DIR] [--pieces] [--workdir DIR]

``--src`` is the ``src/`` directory whose ``repro_torch`` the sweep times
(by default this checkout's), so that two trees can be compared in one
run; the copies of ``--pieces`` go under ``--workdir`` (by default a
temporary directory, removed afterwards), never into the repository.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
B, S, H, KV, HD = 8, 4096, 14, 2, 64
CACHE_LENS = (128, 1024, 2100, 4096)
PIECE_CACHE_LENS = (128, 4096)
KERNELS = REPO / "src" / "repro_torch" / "kernels"
SOURCE = Path("decode_attention") / "csrc" / "decode_attention.cu"

# (text, its replacement, times it occurs) in decode_attention.cu
ONLY_64 = ("ATTN_FOR_EACH_DIMS(ATTN_CASE)", "ATTN_CASE(64, 64)", 1)
EMPTY = ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  return;\n  cg::cluster_group cluster = cg::this_cluster();\n", 1)
NO_CLUSTER = ("__cluster_dims__(kCluster, 1, 1)", "", 1)
NO_STREAM = ("const int mine = chunks > warp ?",
             "const int mine = 0 * chunks > warp ?", 1)
LOCAL_STORES = [("*cluster.map_shared_rank(&", "*(&", 3),
                (", 0) = ", ") = ", 3)]
NO_CLUSTER_BARRIERS = [
    ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
     '"memory");\n', "", 1),
    ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n',
     "", 1),
    ("  cluster.sync();\n", "  __syncthreads();\n", 1)]
#: name -> cuts, each copy also built at hd = vd = 64 only
PIECES = {
    "full": [],
    "empty-cluster-launch": [EMPTY],
    "empty-launch-without-cluster": [EMPTY, NO_CLUSTER],
    "no-stream (q load, merges, DSMEM stores, cluster barriers)":
        [NO_STREAM],
    "no-stream, local stores": [NO_STREAM, *LOCAL_STORES],
    "no-stream, local stores, no cluster barrier":
        [NO_STREAM, *LOCAL_STORES, *NO_CLUSTER_BARRIERS],
}


def inputs(dev):
    import chip_smoke as C

    rng = np.random.default_rng(C.SEED)
    return [torch.from_numpy(rng.standard_normal(d).astype(np.float32))
            .to(dev, torch.bfloat16)
            for d in ((B, 1, H, HD), (B, S, KV, HD), (B, S, KV, HD))]


def sweep(src: Path, dev) -> None:
    import torch.nn.functional as F

    import chip_smoke as C
    from repro_torch.kernels.decode_attention import kernel as DA

    q, k, v = inputs(dev)
    for clen in CACHE_LENS:
        n = torch.tensor(clen, dtype=torch.int32, device=dev)
        call = lambda: DA.decode_attention(q, k, v, n)
        ref = DA.decode_attention_plain(q, k, v, n, dtype=torch.float64)
        err, share = C.max_excess(call(), ref, C.ATTN_BF16_ATOL,
                                  C.ATTN_BF16_RTOL)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous()[:, :, :clen]
                  for t in (k, v))
        row = {"phase": "decode-sweep", "src": str(src),
               "shape": [B, S, H, KV, HD, HD], "cache_len": clen,
               "kernel_ms": C.graph_ms(call),
               "kernel_nodes_per_call": C.graph_kernel_nodes(call),
               "library_ms": C.graph_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, enable_gqa=True)),
               "bf16_max_abs_err": err, "bf16_share_of_limit": share,
               **C.attention_bound(b=B, sq=1, skv=clen, h=H, kv=KV, hd=HD,
                                   vd=HD, pairs=clen)}
        plan = getattr(DA, "split_plan", None)
        if plan is not None:
            row["plan"] = list(plan(B, H, KV, S, torch.cuda
                                    .get_device_properties(dev)
                                    .multi_processor_count))
            DA.split_plan = lambda *a: (S, 1)
            try:
                row["split_kernel_alone_ms"] = C.graph_ms(call)
            finally:
                DA.split_plan = plan
        print(json.dumps(row), flush=True)


def cut_copy(dest: Path, name: str, cuts) -> Path:
    """A copy of the kernel families' sources in ``dest``, its decode
    source with ``cuts`` applied; returns the copied source's path."""
    shutil.copytree(KERNELS, dest, ignore=shutil.ignore_patterns(
        "build", "__pycache__", "*.py"))
    path = dest / SOURCE
    text = path.read_text()
    for old, new, times in (ONLY_64, *cuts):
        if text.count(old) != times:
            raise SystemExit(f"{name}: {old!r} is not found {times} times "
                             f"in {SOURCE}")
        text = text.replace(old, new)
    path.write_text(text)
    return path


def pieces(root: Path, dev) -> None:
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel as DA

    sources = {name: cut_copy(root / str(i) / "kernels", name, cuts)
               for i, (name, cuts) in enumerate(PIECES.items())}
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build_library, sources.values()))
    q, k, v = inputs(dev)
    shipped = DA.SOURCE
    try:
        for name, source in sources.items():
            DA.SOURCE = source
            for clen in PIECE_CACHE_LENS:
                n = torch.tensor(clen, dtype=torch.int32, device=dev)
                print(json.dumps({
                    "phase": "decode-pieces", "copy": name,
                    "cache_len": clen,
                    "kernel_ms": C.graph_ms(
                        lambda: DA.decode_attention(q, k, v, n))}),
                    flush=True)
    finally:
        DA.SOURCE = shipped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--pieces", action="store_true",
                    help="also time copies of this checkout's kernel with "
                         "parts cut out")
    ap.add_argument("--workdir", type=Path, default=None)
    args = ap.parse_args()
    if args.pieces and args.src.resolve() != (REPO / "src").resolve():
        ap.error("--pieces cuts this checkout's kernel: give no --src")
    if not torch.cuda.is_available():
        print("decode_sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(REPO))
    dev = torch.device("cuda")
    sweep(args.src, dev)
    if args.pieces:
        root = args.workdir or Path(tempfile.mkdtemp(prefix="decode_pieces_"))
        try:
            pieces(root, dev)
        finally:
            if args.workdir is None:
                shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
