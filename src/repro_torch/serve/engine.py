"""Batched LM serving: prefill + decode loop with a static-slot batch (the
port of ``repro.serve.engine``).

Continuous-batching-lite: up to ``batch_slots`` requests form a wave, are
left-padded to the longest prompt (without an attention mask, as in the
reference), prefilled together and decoded in lockstep; the next wave
starts when the wave is done.  On the card every attention call of a wave
is one hand-written kernel launch: ``flash_attention`` per layer of the
prefill, ``decode_attention`` per layer of each decode step (a hybrid
model's: per application of its shared attention block).  The wave's
cache tree is the family's, passed through as ``lm_prefill`` makes it: an
SSM (Mamba2) wave carries its conv and state instead of a KV cache (its
prefill ignores ``max_len``), a hybrid wave both, an MLA wave its bf16
latent and rope key; left padding runs the pad tokens through that state,
and through an MoE router, as in the reference.  As the reference's
engine, it passes no frontend inputs to the prefill: it serves a vision
model as a text-only one, and refuses an encoder-decoder, whose encoder
needs its frames (serve one through ``train.step.make_prefill_step`` and
``make_serve_step``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import cast_params, require_ported
from repro_torch.models.transformer import lm_decode_step, lm_prefill


@dataclass
class Request:
    prompt: np.ndarray           # int32[prompt_len]
    max_new_tokens: int = 16
    id: int = 0
    # filled by the engine
    output: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    steps: int = 0
    tokens_out: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


class ServingEngine:
    """Serves :class:`Request` waves of a dense GQA or MLA, MoE, SSM or
    hybrid model, or a vision model's text backbone, on ``device`` (the card unless another device is
    named).  ``params`` is the tree of
    ``params.init_params`` (or ``convert.lm_params_from_numpy``); the engine
    holds one copy in the activation dtype on its device, made once here.
    Greedy selection takes the argmax of the last position's logits;
    sampling draws from a ``torch.Generator`` on the device seeded by
    ``seed`` (its numbers are not ``jax.random``'s)."""

    def __init__(self, cfg: ModelConfig, params: Any, *, batch_slots: int = 4,
                 max_len: int = 256, greedy: bool = True, seed: int = 0,
                 device=None):
        require_ported(cfg)
        if cfg.encoder_layers > 0:
            raise ValueError(
                f"{cfg.name}: ServingEngine passes no encoder frames to the "
                f"prefill, as the reference's; serve an encoder-decoder "
                f"through train.step.make_prefill_step (its batch's "
                f"'frames') and make_serve_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = cast_params(params, getattr(torch, cfg.activation_dtype),
                                  self.device)
        self.slots = batch_slots
        self.max_len = max_len
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def run(self, requests: List[Request]) -> ServeStats:
        """Serve requests in waves of ``batch_slots`` (lockstep decode)."""
        stats = ServeStats()
        queue = list(requests)
        while queue:
            wave = queue[: self.slots]
            queue = queue[self.slots:]
            self._run_wave(wave, stats)
        return stats

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_wave(self, wave: List[Request], stats: ServeStats) -> None:
        cfg = self.cfg
        b = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        t0 = time.perf_counter()
        logits, cache = lm_prefill(self.params, cfg,
                                   torch.from_numpy(toks).to(self.device),
                                   cache_len=self.max_len)
        last = logits[:, -1].clone()
        del logits  # (B, S, V): the largest tensor of the wave
        self._sync()
        stats.prefill_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        max_new = max(r.max_new_tokens for r in wave)
        pos = plen
        pos_t = torch.tensor(pos, dtype=torch.int32, device=self.device)
        cur = self._select(last)
        for _ in range(max_new):
            host = cur.tolist()
            for i, r in enumerate(wave):
                if not r.done and len(r.output) < r.max_new_tokens:
                    r.output.append(int(host[i]))
                    stats.tokens_out += 1
                elif not r.done:
                    r.done = True
            if all(len(r.output) >= r.max_new_tokens for r in wave):
                break
            if pos >= self.max_len - 1:
                break
            logits, cache = lm_decode_step(self.params, cfg, cache,
                                           cur[:, None], pos_t)
            cur = self._select(logits[:, -1])
            pos += 1
            pos_t = pos_t + 1
            stats.steps += 1
        self._sync()
        stats.decode_s += time.perf_counter() - t0
        for r in wave:
            r.done = True

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        """int32[B] from the (B, V) logits of the last position."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(
            torch.int32)
