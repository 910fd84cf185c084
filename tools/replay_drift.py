#!/usr/bin/env python3
"""How far two correct attention paths drift apart through a served model
(card only).

    python3 tools/replay_drift.py [--arch zamba2_7b] [--prompt-len 4096]
        [--new-tokens 32] [--max-len 4160] [--slots 4]

Serves one wave of seeded random prompts greedily through the attention
kernels (``chip_smoke.serve_path``, the published config whole, seeded
weights), then replays it teacher-forced (the served tokens) three ways
and prints, per step (0: the prefill's last position, then each decode
step), each replay's max |logit difference| as a share of ``chip_smoke``'s
``LM_LOGIT_TOL · max(max|logit|, 1)``:

- ``kernel_vs_plain``: the served logits against the plain attention
  versions at the config's tiles;
- ``plain_vs_plain``: the plain versions at half those tiles against them:
  two correct implementations whose f32 sums differ only in order, as the
  kernel's and the plain version's do (``chip_smoke.lm_teacher_forced``
  makes both comparisons on its own prompts and bounds the first by the
  second);
- ``kernel_vs_plain_from_served_cache``: the plain decode steps started
  from the kernels' own prefill cache (the prefill recomputed through the
  kernels, which is bitwise the served one), so that the decode steps'
  drift is apart from the prefill's.

One JSON line per comparison, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as C  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2_7b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=4160)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replay_drift.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    rng = np.random.default_rng(C.SEED)
    _, engine, prompts, _ = C.serve_path(
        "replay-drift", cfg, requests=args.slots, slots=args.slots,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        max_len=args.max_len, dev=dev, rng=rng)
    served = [lg.float() for lg, _ in engine.record]
    tokens = [tok for _, tok in engine.record]
    toks = torch.from_numpy(prompts[:args.slots]).to(dev)
    params = engine.params
    plain = C.replay_logits(params, cfg, toks, tokens, args.max_len, dev,
                            plain=True)
    half = dataclasses.replace(cfg, q_block=cfg.q_block // 2,
                               kv_block=cfg.kv_block // 2)
    plain_half = C.replay_logits(params, half, toks, tokens, args.max_len,
                                 dev, plain=True)
    from repro_torch.models.transformer import lm_prefill
    _, kernel_cache = lm_prefill(params, cfg, toks, cache_len=args.max_len)
    forced = C.replay_logits(params, cfg, toks, tokens, args.max_len, dev,
                             plain=True, cache=kernel_cache)
    del kernel_cache
    for name, got, want in (
            ("kernel_vs_plain", served, plain),
            ("plain_vs_plain", plain_half, plain),
            ("kernel_vs_plain_from_served_cache", served, forced)):
        per = C.drift_shares(got, want)
        print(json.dumps({"comparison": name, "model": cfg.name,
                          "layers": cfg.num_layers,
                          "tiles": [cfg.q_block, cfg.kv_block],
                          "prefill_share": per[0],
                          "decode_max_share": max(per[1:]),
                          "worst_step": int(np.argmax(per)),
                          "share_by_step": per}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
