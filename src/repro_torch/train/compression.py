"""Gradient compression for the data-parallel all-reduce (the port of
``repro.train.compression``).

int8 block-quantized all-reduce with error feedback: each data-parallel
rank quantizes its local gradient to int8 with per-block f32 scales,
all-reduces the int8 payload (summed exactly in int32: 4x less traffic
than f32 before the widening), dequantizes with the mean scale, and carries
its quantization residual into the next step (error feedback keeps the
scheme unbiased over time).

As in the reference, each leaf of ``grads`` and ``errors`` has a leading
per-rank dim sharded over the mesh axis: here a DTensor placed ``Shard(0)``
over that axis, whose local shard is ``(1, ...)``, this rank's gradient.
The collectives are ``torch.distributed`` all-reduces over the axis's
process group.  Everything else is elementwise or blockwise torch code:
the reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

BLOCK = 256


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 block quantization: ``(q int8[nb, BLOCK], scale f32[nb])``,
    ``scale = max |block| / 127`` and ``q = clip(round(block / max(scale,
    1e-12)), -127, 127)`` (round half to even, as ``jnp.round``)."""
    flat = g.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale[:, None],
                                                     min=1e-12)), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               size: int) -> torch.Tensor:
    """The f32 tensor of ``shape`` (``size`` elements) that ``q`` and
    ``scale`` encode."""
    blocks = q.to(torch.float32) * scale[:, None]
    return blocks.reshape(-1)[:size].reshape(shape)


def _leaf(g: torch.Tensor, err: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """The reference's ``leaf`` on this rank's ``(1, ...)`` shards: the
    mean (shape of ``g``, its dtype) and the new error (f32)."""
    g1 = g[0].to(torch.float32) + err[0]
    q, scale = quantize(g1)
    qsum = q.to(torch.int32)
    ssum = scale.clone()
    n = torch.ones((), dtype=torch.float32, device=g.device)
    for t in (qsum, ssum, n):
        dist.all_reduce(t, group=group)
    recon = qsum.to(torch.float32) * (ssum / n)[:, None]
    mean = recon.reshape(-1)[:g1.numel()].reshape(g1.shape) / n
    sent = dequantize(q, scale, g1.shape, g1.numel())
    return mean[None].to(g.dtype), (g1 - sent)[None]


def compressed_mean(grads: Any, errors: Any, mesh,
                    axis: str = "data") -> Tuple[Any, Any]:
    """Compressed mean-all-reduce over ``axis`` of ``mesh`` (a
    ``DeviceMesh`` with that dim name).

    ``grads`` and ``errors`` are trees (nested dicts) of DTensors placed
    ``Shard(0)`` over ``axis`` with a leading per-rank dim of the axis's
    size: each rank holds its own gradient as its ``(1, ...)`` local
    shard.  Returns ``(means, new errors)`` in the same layout: every
    rank's shard of the first is the mean, of the second its own
    residual."""
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis)

    def walk(g, e):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], e[k]) for k in g}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        if not isinstance(g, DTensor) or not isinstance(e, DTensor):
            raise TypeError("compressed_mean: leaves must be DTensors "
                            "sharded over the axis")
        local_g, local_e = g.to_local(), e.to_local()
        if local_g.shape[0] != 1 or local_e.shape != local_g.shape:
            raise ValueError(f"compressed_mean: a rank's shard must be (1, "
                             f"...); got {tuple(local_g.shape)} and "
                             f"{tuple(local_e.shape)}")
        mean, new_err = _leaf(local_g, local_e, group)
        return (DTensor.from_local(mean, g.device_mesh, g.placements),
                DTensor.from_local(new_err, e.device_mesh, e.placements))

    return walk(grads, errors)


def init_error_state(grads_template: Any) -> Any:
    """Zero errors (f32) of every leaf's shape: a tree of plain tensors,
    or of DTensors in the template's layout."""
    from torch.distributed.tensor import DTensor

    if isinstance(grads_template, dict):
        return {k: init_error_state(v) for k, v in grads_template.items()}
    if isinstance(grads_template, DTensor):
        zeros = torch.zeros_like(grads_template.to_local(),
                                 dtype=torch.float32)
        return DTensor.from_local(zeros, grads_template.device_mesh,
                                  grads_template.placements)
    return torch.zeros(grads_template.shape, dtype=torch.float32,
                       device=grads_template.device)


def compression_ratio() -> float:
    """The all-reduce payload against an f32 one (int8 and the scales)."""
    return (1.0 + 4.0 / BLOCK) / 4.0
