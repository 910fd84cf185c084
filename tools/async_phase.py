#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s async phase alone on the card and print its rows.

    python3 tools/async_phase.py [--src DIR] [--held-back-only]
                                 [--mutant NAME]

``--src DIR`` runs the port found in DIR (a directory holding
``repro_torch``, such as the ``src/`` of another checkout unpacked with
``git archive``) in place of the repository's; the phase itself always
comes from the repository's ``chip_smoke.py``.  ``--held-back-only`` runs
only the PageRank session whose builds are held back on their stream.
``--mutant`` copies the port into a temporary directory and deletes one
line of the stream ordering at promotion first:

- ``no-wait-event``: the main stream no longer waits for the build's
  event; the held-back run must fail;
- ``no-record-stream``: the snapshot's tensors are no longer recorded on
  the main stream.

It prints one JSON line per query and per session (times in ms, as the
phase measures them) and a last line with ``ok`` true, or the failed
check.  It needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ENGINE = Path("repro_torch/core/engine.py")
#: name -> the lines of ``engine.py`` the mutant deletes
MUTANTS = {
    "no-wait-event": "            main.wait_event(snap.events[1])\n",
    "no-record-stream": ("            for t in _snapshot_tensors(snap):\n"
                         "                t.record_stream(main)\n"),
}
KEEP = ("algorithm", "quality_target", "slow_build", "query", "action",
        "epoch", "async_answer_ms", "async_call_ms", "sync_answer_ms",
        "sync_call_ms", "build_events_ms", "build_running_at_return",
        "build_running_at_promotion", "integrate_host_ms",
        "builds_running_at_promotion", "wall_s")


def mutant_copy(src: Path, name: str) -> Path:
    """A copy of ``src/repro_torch`` (its kernel builds included) with the
    mutant's lines deleted."""
    out = Path(tempfile.mkdtemp(prefix=f"async-{name}-"))
    shutil.copytree(src / "repro_torch", out / "repro_torch")
    path = out / ENGINE
    text = path.read_text()
    if text.count(MUTANTS[name]) != 1:
        raise SystemExit(f"mutant {name}: its lines are not in {ENGINE}")
    path.write_text(text.replace(MUTANTS[name], ""))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--held-back-only", action="store_true")
    ap.add_argument("--mutant", choices=sorted(MUTANTS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tools/async_phase.py needs a CUDA device", file=sys.stderr)
        return 2
    src = args.src.resolve()
    if args.mutant:
        src = mutant_copy(src, args.mutant)
    sys.path[:0] = [str(src), str(REPO)]
    import chip_smoke as C
    import repro_torch
    from repro_torch.graph.generators import DATASETS, generate
    from repro_torch.stream import StreamConfig, build_stream

    print(json.dumps({"src": str(src), "mutant": args.mutant,
                      "port": repro_torch.__file__}))
    if args.held_back_only:
        C.ASYNC_RUNS = ()
    spec = DATASETS["synth-web-lg"]
    s, d = generate(spec, seed=C.SEED)
    stream = build_stream(s, d, StreamConfig(stream_size=spec.stream_size,
                                             num_queries=50))
    t0 = time.perf_counter()
    try:
        rows, _ = C.async_path(stream, torch.device("cuda"))
    except AssertionError as e:
        print(json.dumps({"ok": False, "failed": str(e)}))
        return 1
    finally:
        if args.mutant:
            shutil.rmtree(src)
    for r in rows:
        print(json.dumps({k: r[k] for k in KEEP if k in r}))
    print(json.dumps({"ok": True, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
