"""Memory and collective audit: each program's largest intermediate and
its largest collectives against byte budgets derived from the graph spec
(the port of ``repro.analysis.hlo_audit``).

- **MEM-TEMP** — the largest single new tensor a program makes (from the
  :class:`~repro_torch.analysis.dispatch_lint.DispatchRecorder` record, on
  either device) and, on the card, its peak allocation beyond its inputs
  (``torch.cuda.max_memory_allocated`` less what was allocated before the
  call, the kernels' scratch included) must stay under
  ``temp_bytes_max``.
- **COL-ALLGATHER-BYTES** — every all-gather stays below one edge buffer
  (``4·E_cap``): one that large means some stage replicated the sharded
  edge stream.
- **COL-ALLTOALL-BYTES** — the summary's bucket exchange is a
  capacity-padded all-to-all of hot blocks; one past the padded exchange
  budget means E-space (not K-space) data crossed the mesh.
- **COL-ALLREDUCE-BYTES** — the rank vectors' merges are node-space.
- **COL-REDUCESCATTER-BYTES**, **COL-PERMUTE-BYTES** — unbudgeted by
  the graph specs, as in the reference; a caller may set them.

The collective rules read the largest single op of each kind
(:attr:`repro_torch.launch.dispatch_cost.Cost.coll_max`, recorded by a
:class:`~repro_torch.launch.dispatch_cost.CostCounter` on a mesh of two or
more ranks), so how often a loop runs it neither dilutes nor inflates the
signal.  :func:`budgets_for_spec` derives the budgets from a catalog
``GraphSpec``, :func:`budgets_for_graph` is the pod-scale dry run's (edge
count only).  ``None`` disables a budget.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding

_RULE_BY_KIND = {
    "all-gather": "COL-ALLGATHER-BYTES",
    "all-to-all": "COL-ALLTOALL-BYTES",
    "all-reduce": "COL-ALLREDUCE-BYTES",
    "reduce-scatter": "COL-REDUCESCATTER-BYTES",
    "collective-permute": "COL-PERMUTE-BYTES",
}


@dataclasses.dataclass(frozen=True)
class CollectiveBudgets:
    """Per-kind byte ceilings for the largest single collective op, and a
    peak-temporary budget.  ``None`` = unchecked."""

    all_gather_max: Optional[float] = None
    all_to_all_max: Optional[float] = None
    all_reduce_max: Optional[float] = None
    reduce_scatter_max: Optional[float] = None
    collective_permute_max: Optional[float] = None
    temp_bytes_max: Optional[float] = None

    def budget_for(self, kind: str) -> Optional[float]:
        """The ceiling for one collective kind (``None`` = unchecked)."""
        return {
            "all-gather": self.all_gather_max,
            "all-to-all": self.all_to_all_max,
            "all-reduce": self.all_reduce_max,
            "reduce-scatter": self.reduce_scatter_max,
            "collective-permute": self.collective_permute_max,
        }.get(kind)


def budgets_for_spec(spec) -> CollectiveBudgets:
    """Budgets derived from a program-catalog ``GraphSpec``:

    - all-gather: strictly under one endpoint buffer ``4·E_cap``;
    - all-to-all: the capacity-padded bucket exchange, ``4·S·⌈H_cap/S⌉``
      bytes a buffer, with the reference's ×8 headroom for its fused
      (src, dst, w, order) streams;
    - all-reduce: node-space merges only, a ``[B, N]`` f32 buffer with the
      same ×8 headroom;
    - temp: ``128·4·E_cap``, roomy for sort scratch (a handful of E-sized
      buffers) and two orders under any ``[E, N]`` materialization."""
    e_bytes = 4.0 * spec.edge_capacity
    pad_hot = spec.num_shards * (-(-spec.hot_edge_capacity
                                   // spec.num_shards))
    return CollectiveBudgets(
        all_gather_max=e_bytes,
        all_to_all_max=8.0 * 4.0 * pad_hot,
        all_reduce_max=8.0 * 4.0 * spec.node_capacity * max(spec.batch, 1),
        temp_bytes_max=128.0 * e_bytes)


def budgets_for_graph(edge_capacity: int) -> CollectiveBudgets:
    """The pod-scale dry run's gate: all-gathers strictly under one
    ``4·E_cap`` edge buffer, everything else unbudgeted (the pod-scale
    temporaries are reported, not gated)."""
    return CollectiveBudgets(all_gather_max=4.0 * edge_capacity)


def audit_cost(cost, budgets: CollectiveBudgets, *, program: str,
               temp_bytes: Optional[float] = None) -> List[Finding]:
    """COL findings of a recorded cost
    (:class:`~repro_torch.launch.dispatch_cost.Cost`): its largest op of
    each collective kind against the budget; with ``temp_bytes``, MEM-TEMP
    of the peak temporaries too."""
    findings: List[Finding] = []
    for kind, largest in sorted(cost.coll_max.items()):
        budget = budgets.budget_for(kind)
        if budget is not None and largest >= budget:
            findings.append(Finding(
                pass_id="collective", rule=_RULE_BY_KIND.get(
                    kind, f"COL-{kind.upper()}-BYTES"),
                where=f"{program}:{kind}",
                detail=f"largest {kind} moves {largest:.3e} B >= budget "
                       f"{budget:.3e} B ({cost.coll_counts.get(kind, 0):.0f} "
                       f"{kind} op(s) in all): an E-space buffer crossed "
                       f"the mesh; keep edge-space data sharded"))
    if temp_bytes is not None:
        findings += audit_memory(budgets, program=program,
                                 largest_bytes=temp_bytes)
    return findings


def cuda_peak_bytes(fn: Callable, *args) -> Tuple[object, int]:
    """``(fn(*args), peak)``: the card's peak allocation during the call
    beyond what was allocated before it (the inputs and everything
    else live)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def audit_memory(budgets: CollectiveBudgets, *, program: str,
                 largest_bytes: float, largest_at: str = "",
                 peak_bytes: Optional[float] = None) -> List[Finding]:
    """MEM-TEMP findings of one program: its largest intermediate and, when
    measured on the card, its peak, each against ``temp_bytes_max``."""
    budget = budgets.temp_bytes_max
    if budget is None:
        return []
    over = []
    if largest_bytes >= budget:
        over.append(f"largest intermediate {largest_bytes:.3e} B"
                    + (f" ({largest_at})" if largest_at else ""))
    if peak_bytes is not None and peak_bytes >= budget:
        over.append(f"card peak beyond the inputs {peak_bytes:.3e} B")
    if not over:
        return []
    return [Finding(
        pass_id="memory", rule="MEM-TEMP", where=f"{program}:temp",
        detail=f"{'; '.join(over)} >= budget {budget:.3e} B — the program "
               f"materializes scratch far past the expected edge-buffer "
               f"working set")]
