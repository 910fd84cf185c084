"""Mixture-of-Experts MLP: top-k routing with capacity-bounded dispatch (the
port of ``repro.models.moe``).

The reference's design, kept exactly because the answers depend on it:

- ``route``: the router's softmax in f32, the top k experts of each token
  (ties to the lower expert id, as ``jax.lax.top_k``), their weights
  renormalised to sum to one;
- ``assign``: ``cap = int(S·k·capacity_factor/E) + 1`` slots per expert and
  batch row; an assignment's rank within its expert is a cumsum over the
  one-hot of its expert in token-major, then k, order, and an assignment
  ranked ``cap`` or later is dropped (its token keeps only the residual);
- ``dispatch``: each kept assignment's token is copied into its expert's
  slot of an expert-major ``(E·cap + 1, B, d)`` buffer (the order in which
  the reference's ``lax.scan`` reads its ``(B, E·cap, d)`` one) whose last
  slot is a sink for the dropped ones (several may land there; it is
  thrown away);
- ``experts``: a loop over the experts, one expert's weights cast to the
  activation dtype at a time (as the reference's ``lax.scan``), over all
  ``cap`` slots whether filled or not; an expert's ``(cap, B, d)`` rows are
  contiguous, so each product is one matrix product that reads the
  expert's weights once;
- ``combine``: each assignment gathers its slot's output (zero if
  dropped), weighted, and the k terms are summed in the activation dtype.

Every shape is fixed by (B, S, E, k, capacity_factor): no host read, so a
decode step can be captured as a CUDA graph.  ``moe_mlp`` looks ``route``
up at call time, so a caller can replace it (to record or force the
routes of a run).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import per_shard as PS
from repro_torch.sharding.rules import ws


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert and batch row."""
    moe = cfg.moe
    return int(seq_len * moe.top_k * moe.capacity_factor
               / moe.num_experts) + 1


def router_probs(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, S, E) f32 softmax of the router's logits, computed in x's
    dtype."""
    return torch.softmax((x @ p["router"].to(x.dtype)).float(), dim=-1)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top_w f32, top_i int64), both (B, S, k): the k largest probabilities
    in descending order, equal ones by lower expert id, and their weights
    renormalised."""
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    return top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_i


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows of ``ids`` (``F.one_hot`` reads the ids' range
    back to the host on some devices)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def assign(top_i: torch.Tensor, num_experts: int, cap: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot int64, ok bool), both (B, S·k): each assignment's row of the
    dispatch buffer (``E·cap``, the sink, where dropped) and whether it was
    kept."""
    b = top_i.shape[0]
    flat_e = top_i.reshape(b, -1)
    onehot = _one_hot(flat_e, num_experts)
    pos = (onehot.cumsum(1) - onehot).gather(-1, flat_e[..., None])[..., 0]
    ok = pos < cap
    slot = torch.where(ok, flat_e * cap + pos,
                       torch.full_like(flat_e, num_experts * cap))
    return slot, ok


def dispatch(x: torch.Tensor, slot: torch.Tensor, k: int,
             num_slots: int) -> torch.Tensor:
    """(num_slots + 1, B, d): each assignment's token in its slot of its
    batch row, the last slot the dropped assignments' sink."""
    b, s, d = x.shape
    buf = x.new_zeros((num_slots + 1, b, d))
    rows = torch.arange(b, device=x.device)[:, None]
    buf[slot, rows] = x.repeat_interleave(k, dim=1)
    return buf


def experts(p: Dict[str, torch.Tensor], buf: torch.Tensor, num_experts: int,
            cap: int) -> torch.Tensor:
    """(E·cap + 1, B, d): each expert's SwiGLU over its ``cap`` slots of
    ``buf``, one expert's weights in the activation dtype at a time; the
    sink slot stays zero."""
    dt = buf.dtype
    y = torch.zeros_like(buf)
    # a DTensor buffer's batch dim is sharded: its products take the
    # expert's slots batch-major, whose rows flatten to one sharded dim
    sharded = PS.is_dtensor(buf)
    for e in range(num_experts):
        xe = buf[e * cap:(e + 1) * cap]
        if sharded:
            xe = xe.transpose(0, 1)
        h = F.silu(xe @ p["w_gate"][e].to(dt)) * (xe @ p["w_up"][e].to(dt))
        h = ws(h, *((("batch", None) if sharded else (None, "batch"))
                    + ("ff",)))
        ye = h @ p["w_down"][e].to(dt)
        y[e * cap:(e + 1) * cap] = ye.transpose(0, 1) if sharded else ye
    return y


def combine(y: torch.Tensor, slot: torch.Tensor, top_w: torch.Tensor,
            ok: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S, d): the sum over each token's k assignments of its slot's
    output times its weight (zero where dropped), in y's dtype."""
    b, d = y.shape[1], y.shape[-1]
    gathered = y[slot, torch.arange(b, device=y.device)[:, None]]
    w = (top_w.reshape(b, -1) * ok.float()).to(y.dtype)
    return (gathered * w[..., None]).reshape(b, -1, k, d).sum(2)


def moe_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``p`` holds the router ``(d, E)`` and the
    stacked expert weights ``w_gate``/``w_up`` ``(E, d, f)``, ``w_down``
    ``(E, f, d)``."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = capacity(cfg, x.shape[1])

    def route_and_dispatch(x, probs):
        top_w, top_i = route(probs, k)
        slot, ok = assign(top_i, e, cap)
        return dispatch(x, slot, k, e * cap), slot, ok, top_w

    # the routing, dispatch and combine run per batch shard (on DTensor
    # activations); the experts' products are DTensor matmuls
    mesh = PS.mesh_of(x)
    spec = None if mesh is None else PS.batch_spec(mesh, x.shape)
    buf_spec = None if spec is None else (None,) + spec
    buf, slot, ok, top_w = PS.run(route_and_dispatch,
                                  (x, router_probs(p, x)), (spec, spec),
                                  [buf_spec, spec, spec, spec])
    buf = ws(buf, None, "batch", None)
    y = experts(p, buf, e, cap)
    out = PS.run(lambda y, slot, top_w, ok: combine(y, slot, top_w, ok, k),
                 (y, slot, top_w, ok), (buf_spec, spec, spec, spec), spec)
    return ws(out, "batch", "ctx", "embed")


def moe_load_balance_loss(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e over the batch, f_e
    the share of tokens whose top expert is e, P_e the mean probability."""
    e = cfg.moe.num_experts
    probs = router_probs(p, x)
    frac = _one_hot(probs.argmax(-1), e).float().mean(dim=(0, 1))
    return e * (frac * probs.mean(dim=(0, 1))).sum()
