"""Train, eval, prefill and serve steps: the port of ``repro.train.step``.

``make_train_step(cfg)`` returns ``step(params, opt_state, batch)`` for
every family: the loss's gradient by autograd (every attention call
through the flash kernels, forward and backward), clipped to a global
norm, then AdamW written into the parameters and moments it was given, as
the reference's launcher donates them.  Batches are dicts of tensors on
the parameters' device: ``tokens`` and ``labels`` (B, S) int32,
optionally ``loss_mask`` (B, S); a vision model's also ``patch_embeds``
(B, P, d), put before the tokens, with the loss over the S text positions
only; an encoder-decoder's also ``frames`` (B, S_enc, d), its encoder's
input.  The prefill step passes both on as well.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (lm_decode_step, lm_forward,
                                            lm_prefill)
from repro_torch.sharding.per_shard import is_dtensor, to_placements_of
from repro_torch.train.loss import cross_entropy
from repro_torch.train.optimizer import (AdamWState, adamw_update_,
                                         check_not_donated, clip_scale,
                                         global_norm, tree_leaves, tree_map)


def _model_inputs(cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The frontend stubs' inputs of ``batch`` as ``lm_forward``'s and
    ``lm_prefill``'s keyword arguments."""
    kw: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        kw["prefix_embeds"] = batch["patch_embeds"]
    if cfg.encoder_layers > 0:
        kw["encoder_embeds"] = batch["frames"]
    return kw


def _text_logits(cfg: ModelConfig, logits: torch.Tensor,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The logits the loss covers: a vision model's text positions only
    (its patch embeddings are inputs)."""
    if cfg.frontend == "vision":
        return logits[:, batch["patch_embeds"].shape[1]:]
    return logits


def _loss_and_grad_leaves(params: Dict[str, Any], cfg: ModelConfig,
                          batch: Dict[str, torch.Tensor], remat: bool,
                          z_loss: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     List[torch.Tensor]]:
    """(loss, accuracy, the gradient of every leaf of ``params`` in
    ``tree_leaves`` order).  A DTensor gradient comes back at its
    parameter's placements: the data-parallel reduction the reference's
    GSPMD inserts (a reduce-scatter or an all-reduce of each partial
    gradient), before the norm and the update read it."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    logits = lm_forward(live, cfg, batch["tokens"], remat=remat,
                        **_model_inputs(cfg, batch))
    loss, acc = cross_entropy(_text_logits(cfg, logits, batch),
                              batch["labels"],
                              batch.get("loss_mask"), z_loss=z_loss)
    del logits
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), acc,
            [to_placements_of(g, p.placements) if is_dtensor(g) else g
             for g, p in zip(grads, leaves)])


def loss_and_grads(params: Dict[str, Any], cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *, remat: bool = True,
                   z_loss: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """(loss, accuracy, grads): the loss of ``batch`` and its gradient
    with respect to every leaf of ``params`` (a tree like ``params``, in
    the leaves' dtypes)."""
    loss, acc, grads = _loss_and_grad_leaves(params, cfg, batch, remat,
                                             z_loss)
    grads = iter(grads)
    return loss, acc, tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, *,
                    learning_rate: Union[Callable, float] = 3e-4,
                    grad_clip: float = 1.0, remat: bool = True,
                    z_loss: float = 0.0,
                    weight_decay: float = 0.1) -> Callable:
    """AdamW train step ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``learning_rate`` is a float or a schedule of
    the optimizer's step (``optimizer.cosine_schedule``).  ``metrics``
    holds 0-d tensors ``loss``, ``accuracy``, ``grad_norm`` (before
    clipping) and ``lr``.

    The step's arguments are donated, as the reference's launcher jits
    it with ``donate_argnums=(0, 1)``: it writes the new parameters and
    moments into the tensors it was given (``optimizer.adamw_update_``,
    bitwise ``clip_by_global_norm`` then ``adamw_update``) and returns
    them, so it holds about 16 bytes a parameter at the update where a
    functional step holds 28.  The caller keeps no other use for the old
    values (clone them first).  A step that failed after its first write
    leaves the state marked, and a retry on it raises
    ``optimizer.DonatedStateError``; one that failed before (in the
    forward or backward) can be retried."""

    def step(params, opt_state: AdamWState, batch):
        check_not_donated(opt_state)
        lr = (learning_rate(opt_state.step) if callable(learning_rate)
              else torch.tensor(learning_rate, dtype=torch.float32,
                                device=opt_state.step.device))
        loss, acc, grads = _loss_and_grad_leaves(params, cfg, batch, remat,
                                                 z_loss)
        gnorm = global_norm(grads)
        adamw_update_(grads, opt_state, params, lr,
                      grad_scale=clip_scale(gnorm, grad_clip),
                      weight_decay=weight_decay)
        metrics = {"loss": loss, "accuracy": acc, "grad_norm": gnorm,
                   "lr": lr}
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``step(params, batch) -> {"loss", "accuracy"}``, without autograd."""

    @torch.no_grad()
    def step(params, batch):
        logits = lm_forward(params, cfg, batch["tokens"],
                            **_model_inputs(cfg, batch))
        loss, acc = cross_entropy(_text_logits(cfg, logits, batch),
                                  batch["labels"], batch.get("loss_mask"))
        return {"loss": loss, "accuracy": acc}

    return step


def make_prefill_step(cfg: ModelConfig, *, cache_len: int) -> Callable:
    """Prompt processing: ``step(params, batch) -> (next-token logits (B,
    V), caches)``; ``batch`` holds the ``tokens`` and a frontend's inputs
    (``patch_embeds``, an encoder-decoder's ``frames``)."""

    @torch.no_grad()
    def step(params, batch):
        logits, cache = lm_prefill(params, cfg, batch["tokens"],
                                   cache_len=cache_len,
                                   **_model_inputs(cfg, batch))
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
