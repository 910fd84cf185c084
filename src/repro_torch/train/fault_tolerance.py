"""Fault tolerance for training: the port of
``repro.train.fault_tolerance``.

- ``StepTimer``: per-step EMA timing and straggler (outlier) detection;
- ``PreemptionGuard``: a flag set on SIGTERM, so the loop checkpoints and
  exits cleanly;
- ``RestartableLoop``: periodic async saves, save on preemption, resume
  from the latest committed step, bounded retry of a failing step;
- ``elastic_reshard``: a checkpoint restored onto another mesh, placed by
  the given shardings (the checkpoint holds global shapes and each rank's
  shards with their indices, not a device layout).
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager


@dataclass
class StepTimer:
    ema_alpha: float = 0.1
    outlier_factor: float = 2.0
    ema_s: Optional[float] = None
    history: List[float] = field(default_factory=list)
    outliers: List[int] = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.history.append(dt)
        is_outlier = (self.ema_s is not None
                      and dt > self.outlier_factor * self.ema_s)
        if is_outlier:
            self.outliers.append(step)
        # outliers do not poison the EMA
        if not is_outlier:
            self.ema_s = (dt if self.ema_s is None
                          else (1 - self.ema_alpha) * self.ema_s
                          + self.ema_alpha * dt)
        return is_outlier

    def summary(self) -> Dict[str, float]:
        h = np.asarray(self.history) if self.history else np.zeros(1)
        return {
            "mean_s": float(h.mean()),
            "p50_s": float(np.percentile(h, 50)),
            "p99_s": float(np.percentile(h, 99)),
            "ema_s": float(self.ema_s or 0.0),
            "outliers": len(self.outliers),
        }


class PreemptionGuard:
    """Sets a flag on SIGTERM (or the given signals) so the loop
    checkpoints and exits cleanly (a preemption notice)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # not the main thread
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    max_step_retries: int = 2
    log_every: int = 10


class RestartableLoop:
    """Checkpoint/restart training driver.

    ``state`` is any tree of tensors (params, optimizer state, ...).  On
    start it resumes after the latest committed checkpoint if one exists.
    A failing step is retried from the last good in-memory state, and
    re-raised after ``max_step_retries`` retries.
    """

    def __init__(self, ckpt: CheckpointManager, cfg: LoopConfig,
                 *, log: Callable[[str], None] = print):
        self.ckpt = ckpt
        self.cfg = cfg
        self.log = log
        self.timer = StepTimer()

    def resume_step(self) -> int:
        latest = self.ckpt.latest_step()
        return 0 if latest is None else latest + 1

    def restore(self, state_template: Any, device=None) -> Any:
        """The latest committed state in ``state_template``'s structure,
        or None when there is none."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return None
        self.log(f"[restore] resuming from step {latest}")
        return self.ckpt.restore(latest, state_template, device)

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            start_step: Optional[int] = None) -> Any:
        cfg = self.cfg
        guard = PreemptionGuard()
        step = self.resume_step() if start_step is None else start_step
        try:
            while step < cfg.total_steps:
                t0 = time.perf_counter()
                retries = 0
                while True:
                    try:
                        state = step_fn(state, step)
                        break
                    except Exception as e:  # noqa: BLE001 — retry transient
                        retries += 1
                        if retries > cfg.max_step_retries:
                            self.log(f"[fatal] step {step} failed "
                                     f"{retries - 1} retries: {e}")
                            raise
                        self.log(f"[retry] step {step} attempt {retries}: {e}")
                dt = time.perf_counter() - t0
                if self.timer.record(step, dt):
                    self.log(f"[straggler] step {step} took {dt:.3f}s "
                             f"(ema {self.timer.ema_s:.3f}s)")
                if cfg.log_every and step % cfg.log_every == 0:
                    self.log(f"[step {step}] {dt*1e3:.1f} ms")
                if cfg.checkpoint_every and step % cfg.checkpoint_every == 0 \
                        and step > 0:
                    self.ckpt.save(step, state)
                if guard.requested:
                    self.log(f"[preempt] checkpointing at step {step} and "
                             "exiting")
                    self.ckpt.save(step, state)
                    self.ckpt.wait()
                    break
                step += 1
            else:
                self.ckpt.save(cfg.total_steps - 1, state)
                self.ckpt.wait()
        finally:
            guard.restore()
        return state


def elastic_reshard(ckpt: CheckpointManager, step: int, state_template: Any,
                    new_shardings: Any) -> Any:
    """Load a checkpoint onto a different mesh (elastic rescale).

    Placement is entirely determined by ``new_shardings`` (a tree of
    ``NamedSharding`` against the new mesh,
    :meth:`CheckpointManager.restore`), so a checkpoint saved by N ranks
    restores onto M, or onto one process."""
    return ckpt.restore(step, state_template, shardings=new_shardings)
