"""Train, eval, prefill and serve steps: the port of ``repro.train.step``.

``make_train_step(cfg)`` returns ``step(params, opt_state, batch)`` for the
dense GQA family: the loss's gradient by autograd (every attention call
through the flash kernels, forward and backward), clipped to a global
norm, then AdamW.  Batches are dicts of tensors on the parameters' device:
``tokens`` and ``labels`` (B, S) int32, optionally ``loss_mask`` (B, S).
Training the MLA, MoE, SSM and hybrid families is not ported yet (the
flash backward is not built at MLA's and the hybrid's head dims), and
raises; the other families raise in ``lm_forward`` (ROADMAP queue 1 entry
17b).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import NOT_PORTED_ENTRY
from repro_torch.models.transformer import (lm_decode_step, lm_forward,
                                            lm_prefill)
from repro_torch.train.loss import cross_entropy
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         clip_by_global_norm, tree_leaves,
                                         tree_map)


def loss_and_grads(params: Dict[str, Any], cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *, remat: bool = True,
                   z_loss: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """(loss, accuracy, grads): the loss of ``batch`` and its gradient
    with respect to every leaf of ``params`` (a tree like ``params``, in
    the leaves' dtypes)."""
    if cfg.family != "dense" or cfg.mla is not None:
        what = "MLA" if cfg.mla is not None else cfg.family
        raise NotImplementedError(f"{cfg.name}: training the {what} "
                                  f"family is not ported yet "
                                  f"({NOT_PORTED_ENTRY})")
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    logits = lm_forward(live, cfg, batch["tokens"], remat=remat)
    loss, acc = cross_entropy(logits, batch["labels"],
                              batch.get("loss_mask"), z_loss=z_loss)
    del logits
    leaves = tree_leaves(live)
    grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), acc,
            tree_map(lambda _: next(grads), live))


def make_train_step(cfg: ModelConfig, *,
                    learning_rate: Union[Callable, float] = 3e-4,
                    grad_clip: float = 1.0, remat: bool = True,
                    z_loss: float = 0.0,
                    weight_decay: float = 0.1) -> Callable:
    """AdamW train step ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``learning_rate`` is a float or a schedule of
    the optimizer's step (``optimizer.cosine_schedule``).  ``metrics``
    holds 0-d tensors ``loss``, ``accuracy``, ``grad_norm`` (before
    clipping) and ``lr``."""

    def step(params, opt_state: AdamWState, batch):
        loss, acc, grads = loss_and_grads(params, cfg, batch, remat=remat,
                                          z_loss=z_loss)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = (learning_rate(opt_state.step) if callable(learning_rate)
              else torch.tensor(learning_rate, dtype=torch.float32,
                                device=opt_state.step.device))
        new_params, new_state = adamw_update(grads, opt_state, params, lr,
                                             weight_decay=weight_decay)
        metrics = {"loss": loss, "accuracy": acc, "grad_norm": gnorm,
                   "lr": lr}
        return new_params, new_state, metrics

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``step(params, batch) -> {"loss", "accuracy"}``, without autograd."""

    @torch.no_grad()
    def step(params, batch):
        logits = lm_forward(params, cfg, batch["tokens"])
        loss, acc = cross_entropy(logits, batch["labels"],
                                  batch.get("loss_mask"))
        return {"loss": loss, "accuracy": acc}

    return step


def make_prefill_step(cfg: ModelConfig, *, cache_len: int) -> Callable:
    """Prompt processing: ``step(params, batch) -> (next-token logits (B,
    V), caches)``."""

    @torch.no_grad()
    def step(params, batch):
        logits, cache = lm_prefill(params, cfg, batch["tokens"],
                                   cache_len=cache_len)
        return logits[:, -1], cache

    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: ``step(params, cache, token (B, 1), pos) ->
    (logits (B, V), cache)``; the caches are updated in place."""

    @torch.no_grad()
    def step(params, cache, token, pos):
        logits, new_cache = lm_decode_step(params, cfg, cache, token, pos)
        return logits[:, 0], new_cache

    return step
