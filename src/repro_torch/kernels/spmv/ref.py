"""Plain PyTorch oracle for the SpMV push kernel (port of
``repro.kernels.spmv.ref``)."""

from __future__ import annotations

import torch


def spmv_push_ref(contrib: torch.Tensor, dst_sorted: torch.Tensor,
                  num_nodes: int) -> torch.Tensor:
    """``out[v] = Σ contrib[e]`` over edges with ``dst_sorted[e] == v``,
    summed in edge order along the last axis; ids outside ``[0,
    num_nodes)`` (the padding sentinel) are dropped, as XLA's
    ``segment_sum`` drops them."""
    keep = (dst_sorted >= 0) & (dst_sorted < num_nodes)
    idx = torch.where(keep, dst_sorted, num_nodes).long()
    out = torch.zeros(contrib.shape[:-1] + (num_nodes + 1,),
                      dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(-1, idx, contrib)[..., :num_nodes]
