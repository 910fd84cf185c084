"""repro_torch.analysis — the gates that keep the port's hot path on the
device (PyTorch port of ``repro.analysis``, one-device part).

Four cooperating passes over the program catalog, two canned engine loops
and the source tree, unified behind ``tools/analyze_torch.py`` and the
committed baseline ``src/repro_torch/analysis/baseline.json``:

- :mod:`~repro_torch.analysis.dispatch_lint` — every aten op a program
  dispatches, under a ``TorchDispatchMode`` (no f64, no int64/f64 stored
  state, edge-scale int64 casts by site, no edge-scale scatter, no
  ``[E, N]``-class tensor, no host reads);
- :mod:`~repro_torch.analysis.memory_audit` — each program's largest
  intermediate (and on the card its peak) against a byte budget;
- :mod:`~repro_torch.analysis.rebuild` — kernel builds, library loads and
  tuning runs, which a warm engine loop must not repeat;
- :mod:`~repro_torch.analysis.ast_lint` — source-level rules for the
  engine surface (scatters only through ``push``, frozen tensor-free
  plugins, no hidden host reads in hot modules, tuned kernel geometry).

:mod:`~repro_torch.analysis.programs` holds the catalog the program passes
run; :mod:`~repro_torch.analysis.findings` the shared finding/baseline
model.  The collective budgets (``memory_audit.audit_cost`` with
``budgets_for_graph``) hold the sharded programs' collectives as the
pod-scale dry run (:mod:`repro_torch.launch.dryrun`) counts them with the
dispatch cost model (:mod:`repro_torch.launch.dispatch_cost`), the port's
counterpart of the reference's HLO cost model.
"""

from pathlib import Path

from repro_torch.analysis.findings import (BaselineEntry, Finding, check,
                                           load_baseline, render_report)

#: the committed allowlist of the port's known, annotated findings
BASELINE = Path(__file__).resolve().parent / "baseline.json"

__all__ = [
    "BASELINE",
    "BaselineEntry",
    "Finding",
    "check",
    "load_baseline",
    "render_report",
]
