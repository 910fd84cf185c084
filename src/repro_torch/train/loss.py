"""Cross-entropy with an f32 log-softmax and optional z-loss: the port of
``repro.train.loss``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sharding import per_shard as PS


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, accuracy) of ``logits`` (B, S, V) against ``labels``
    (B, S), over the positions where ``mask`` (B, S) is nonzero if given.
    As the reference: every reduction in f32, the row max subtracted
    without a gradient through it, ``z_loss · log_z²`` added per position,
    the masked mean over ``max(sum(mask), 1)``."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m.detach()
    sumexp = torch.exp(shifted).sum(dim=-1)
    log_z = torch.log(sumexp) + m[..., 0]
    if PS.is_dtensor(logits):
        return _vocab_sharded(logits, labels, mask, m, log_z, z_loss)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = log_z - label_logit
    if z_loss > 0.0:
        nll = nll + z_loss * log_z.square()
    with torch.no_grad():
        correct = (logits.argmax(dim=-1) == labels).float()
    return _mean(nll, correct, mask)


def _mean(nll, correct, mask):
    if mask is not None:
        w = mask.float()
        denom = torch.clamp(w.sum(), min=1.0)
        return (nll * w).sum() / denom, (correct * w).sum() / denom
    return nll.mean(), correct.mean()


def _vocab_sharded(logits, labels, mask, m, log_z, z_loss):
    """The loss of DTensor logits, whose vocab dim may be sharded: the
    label's logit as a masked sum over the vocab and the first index of
    the row maximum as a masked minimum, each a reduction DTensor places
    (a gather or an argmax over a sharded dim would gather the logits).
    Both give the values of ``gather`` and ``argmax`` exactly: the sum
    adds zeros to one logit, the minimum picks the first maximal index."""
    v = logits.shape[-1]
    ids = PS.replicate_like(logits, torch.arange(v, dtype=torch.int32,
                                                 device=labels.device))
    hit = labels.to(torch.int32)[..., None] == ids
    label_logit = torch.where(hit, logits, 0.0).sum(dim=-1)
    nll = log_z - label_logit
    if z_loss > 0.0:
        nll = nll + z_loss * log_z.square()
    with torch.no_grad():
        first = torch.where(logits == m, ids, v).amin(dim=-1)
        correct = (first == labels).float()
    return _mean(nll, correct, mask)
