"""Memory audit: the largest intermediate of each program against a byte
budget derived from the graph spec (the one-device part of
``repro.analysis.hlo_audit``).

- **MEM-TEMP** — the largest single new tensor a program makes (from the
  :class:`~repro_torch.analysis.dispatch_lint.DispatchRecorder` record, on
  either device) and, on the card, its peak allocation beyond its inputs
  (``torch.cuda.max_memory_allocated`` less what was allocated before the
  call, the kernels' scratch included) must stay under
  ``temp_bytes_max``.

The collective budgets of the reference (all-gather, all-to-all,
all-reduce, reduce-scatter, permute) belong to the programs on a mesh of
two or more devices and wait for ROADMAP queue 1 entry 16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding


@dataclasses.dataclass(frozen=True)
class CollectiveBudgets:
    """Byte ceilings of a program; ``None`` = unchecked.  Of the
    reference's fields only the peak-temp budget is kept until the
    sharded programs land."""

    temp_bytes_max: Optional[float] = None


def budgets_for_spec(spec) -> CollectiveBudgets:
    """Budgets derived from a program-catalog ``GraphSpec``: temp
    ``128·4·E_cap`` bytes, roomy for sort scratch (a handful of E-sized
    buffers) and two orders under any ``[E, N]`` materialization."""
    return CollectiveBudgets(temp_bytes_max=128.0 * 4.0 * spec.edge_capacity)


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
