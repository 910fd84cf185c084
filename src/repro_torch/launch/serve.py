"""Serve batched requests from the command line: a smoke or full-size
model with weights made from a seed, on the card unless ``--device`` names
another device.  ``--arch`` takes the dense GQA models (``qwen2_0_5b``,
``yi_9b``, ``granite_34b``), the MLA one (``minicpm3_4b``), the MoE ones
(``mixtral_8x22b``, ``dbrx_132b``), the SSM (``mamba2_2_7b``) and the
hybrid (``zamba2_7b``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \\
      --smoke --device cpu --requests 8 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x22b \\
      --smoke --device cpu --prompt-len 40 --max-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \
      --smoke --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    print(f"serving {cfg.name} with {args.requests} requests × "
          f"{args.new_tokens} new tokens, {args.slots} slots on {device}")

    rng = np.random.default_rng(args.seed)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           max_len=args.max_len, seed=args.seed,
                           device=device)
    del params
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                    dtype=np.int32),
                max_new_tokens=args.new_tokens, id=i)
        for i in range(args.requests)
    ]
    stats = engine.run(reqs)
    done = sum(r.done for r in reqs)
    print(f"done: {done}/{len(reqs)} requests, {stats.tokens_out} tokens, "
          f"prefill {stats.prefill_s:.2f}s decode {stats.decode_s:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s)")
    return stats


if __name__ == "__main__":
    main()
