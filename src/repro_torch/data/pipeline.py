"""Synthetic token data with bounded prefetch: the port of
``repro.data.pipeline``.

Each process makes only its slice of the global batch, deterministic in
(seed, step, process) so that a restarted job resumes mid-stream without
skew, and a background thread keeps a bounded queue of batches ahead of
the step.  ``SyntheticLMData.batch_at`` is the reference's numpy code, so
both packages draw the same tokens bit for bit.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import place


def _process_count_and_index() -> tuple:
    """``torch.distributed``'s world size and rank once it is initialised,
    else one process of index 0 (the reference's ``jax.process_count`` and
    ``jax.process_index``)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic LM task: noisy copy of a lag-k markov stream (learnable)
    lag: int = 2
    noise: float = 0.05


class SyntheticLMData:
    """Deterministic-per-step synthetic LM batches: token t copies token
    t - lag with probability 1 - noise, else is drawn afresh.  Predictable
    enough that a few hundred steps show a falling loss, random enough not
    to be trivial."""

    def __init__(self, cfg: DataConfig, *, host_batch: Optional[int] = None):
        self.cfg = cfg
        self.host_batch = host_batch or max(
            cfg.global_batch // _process_count_and_index()[0], 1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}``, int32 ``(host_batch, seq_len)``, the
        labels the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * (_process_count_and_index()[1]
                                             + 1))
        b, s = self.host_batch, cfg.seq_len
        base = rng.integers(0, cfg.vocab_size, size=(b, s + cfg.lag),
                            dtype=np.int64)
        copy = rng.random((b, s + cfg.lag)) > cfg.noise
        for t in range(cfg.lag, s + cfg.lag):
            base[:, t] = np.where(copy[:, t], base[:, t - cfg.lag], base[:, t])
        tokens = base[:, : s].astype(np.int32)
        labels = base[:, 1: s + 1].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch queue over any batch iterator."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
                if self._done:
                    return
        except BaseException as e:
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._done = True


def shard_batch(batch: Dict[str, np.ndarray], shardings: Any = None, *,
                device=None) -> Dict[str, Any]:
    """Place a host batch: with ``shardings`` (a dict, key ->
    ``NamedSharding``) each key with an entry becomes a DTensor on its
    mesh, this rank holding its own shard of the host array, and a key
    without one is returned as it is, as the reference's
    ``jax.device_put`` per key.  Otherwise every key becomes a tensor on
    one device, one process's slice: ``device``, or ``shardings`` itself
    when it names a device (``shard_batch(batch, "cpu")``), else the
    card."""
    if not isinstance(shardings, dict):
        device = resolve_device(shardings if device is None else device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    return {k: v if shardings.get(k) is None else place(v, shardings[k])
            for k, v in batch.items()}
