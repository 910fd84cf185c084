"""Train from the command line: a smoke or full-size model of the dense,
MLA, MoE, SSM or hybrid family with weights made from a seed, the donated
AdamW step with remat, async checkpoints and resume, on the card unless
``--device`` names another device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128

Without ``--ckpt-dir`` checkpoints go to a new temporary directory; with
one, a run resumes after its latest committed step.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, shard_batch
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import LoopConfig, RestartableLoop
from repro_torch.train.optimizer import adamw_init, cosine_schedule
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    print(f"training {cfg.name}: L={cfg.num_layers} d={cfg.d_model} "
          f"V={cfg.vocab_size} on {device}")

    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    opt = adamw_init(params)
    sched = cosine_schedule(args.lr, args.warmup, args.steps)
    # the step writes the new parameters and moments into the state it is
    # given, as the reference's jit donates them
    step_fn = make_train_step(cfg, learning_rate=sched, remat=True,
                              weight_decay=args.weight_decay)
    # lag=1: the target mostly repeats the current input token, a strong
    # learnable signal
    data = SyntheticLMData(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                      seed=args.seed, lag=1),
                           host_batch=args.batch)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep_last_k=2)
    loop = RestartableLoop(
        ckpt, LoopConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every, log_every=0))

    state = {"params": params, "opt": opt}
    del params, opt
    state = loop.restore(state) or state

    losses = []

    def one_step(state, step):
        batch = shard_batch(data.batch_at(step), device)
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        return {"params": p, "opt": o}

    # the loop holds the only reference to the state, which each donated
    # step updates in place
    held = [state]
    del state
    loop.run(held.pop(), one_step, start_step=loop.resume_step())
    ckpt.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"checkpoints in {ckpt_dir}; timing {loop.timer.summary()}")
    return losses


if __name__ == "__main__":
    main()
