"""Finding model + baseline/allowlist matching for the analysis passes
(PyTorch port of ``repro.analysis.findings``).

Every pass (:mod:`~repro_torch.analysis.dispatch_lint`,
:mod:`~repro_torch.analysis.memory_audit` (the memory and collective
passes),
:mod:`~repro_torch.analysis.rebuild`, :mod:`~repro_torch.analysis.ast_lint`)
emits :class:`Finding` rows; callers compare them against the committed
baseline (``src/repro_torch/analysis/baseline.json``) with :func:`check`:

- a finding whose ``key`` matches a baseline entry is *allowlisted* — a
  known, annotated violation (every entry carries a human ``reason``);
- anything else is *new* and fails the run;
- baseline entries that no longer match any finding are *stale* — the
  violation was fixed, so the entry should be deleted (reported as a
  warning, not a failure, to keep the gate monotone under refactors).

Keys are ``"RULE::where"`` where ``where`` is a *stable* location: a
``program:file:function`` triple for the dispatch rules, ``program:temp``
for the memory rule, ``program:kind`` for the collective rules,
``scenario:event`` for the rebuild rule and
``path:scope`` for source rules — never a line number, so baselines
survive unrelated edits.

One addition to the reference's model: a baseline entry may name the
``device`` type it applies to (``"cpu"`` or ``"cuda"``; absent = both).
The CPU runs every kernel's plain version, which reads what the kernel
never does, and the card copies to the host where the CPU has nothing to
copy; an entry scoped to one device can neither hide a finding on the
other nor go stale there.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation from one pass.

    ``pass_id``/``rule`` identify the check, ``where`` the stable location
    (see module docstring), ``detail`` the human diagnostic — the op, the
    measured value and the budget or contract it violated.
    """

    pass_id: str   # "dispatch" | "memory" | "collective" | "rebuild"
    #                | "ast"
    rule: str      # e.g. "DSP-F64", "MEM-TEMP"
    where: str     # stable location, e.g. "push_coo[plus_times]:temp"
    detail: str    # actionable message (measured vs budget, contract text)

    @property
    def key(self) -> str:
        """The baseline-matching identity: ``RULE::where``."""
        return f"{self.rule}::{self.where}"

    def __str__(self) -> str:
        return f"[{self.pass_id}] {self.rule} at {self.where}: {self.detail}"

    def to_dict(self) -> dict:
        """JSON row for the findings report artifact."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BaselineEntry:
    """One allowlisted violation: its key plus the reason it is accepted,
    and optionally the one device type (``"cpu"``/``"cuda"``) it holds
    on."""

    rule: str
    where: str
    reason: str
    device: Optional[str] = None

    @property
    def key(self) -> str:
        """Same identity space as :attr:`Finding.key`."""
        return f"{self.rule}::{self.where}"

    def applies_to(self, device: Optional[str]) -> bool:
        """Whether the entry holds for a run on ``device`` (a device type;
        ``None`` = any run)."""
        return self.device is None or device is None or self.device == device


def load_baseline(path: Optional[Path]) -> List[BaselineEntry]:
    """Parse the baseline JSON (``{"allow": [...]}``).

    A missing path (or ``None``) is an empty baseline — every finding is
    new.  Entries must carry non-empty ``reason`` strings: an allowlist
    without rationale is how one-off hacks calcify.  ``device``, where
    present, must be ``"cpu"`` or ``"cuda"``.
    """
    if path is None or not Path(path).exists():
        return []
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    entries = []
    for row in data.get("allow", []):
        if not row.get("reason", "").strip():
            raise ValueError(
                f"baseline entry {row.get('rule')}::{row.get('where')} has "
                f"no reason string; annotate why this violation is accepted")
        device = row.get("device")
        if device not in (None, "cpu", "cuda"):
            raise ValueError(
                f"baseline entry {row.get('rule')}::{row.get('where')} has "
                f"device {device!r}; expected 'cpu', 'cuda' or none")
        entries.append(BaselineEntry(rule=row["rule"], where=row["where"],
                                     reason=row["reason"], device=device))
    return entries


#: rule-id prefix → the pass that emits it (``DSP-F64`` → ``dispatch``, …)
_RULE_PASS = {"DSP": "dispatch", "MEM": "memory", "RB": "rebuild",
              "AST": "ast", "COL": "collective"}


def pass_of_rule(rule: str) -> Optional[str]:
    """The pass id a rule belongs to, derived from its prefix.

    Lets staleness be scoped to the passes that actually ran: a ``DSP-*``
    baseline entry can only be declared stale by a run that included the
    dispatch pass.  Unknown prefixes map to ``None`` (never auto-stale).
    """
    return _RULE_PASS.get(rule.split("-", 1)[0])


def check(findings: Sequence[Finding],
          baseline: Sequence[BaselineEntry],
          *, passes_run: Optional[Iterable[str]] = None,
          device: Optional[str] = None,
          ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split findings against the baseline.

    Returns ``(new, allowlisted, stale)``: findings with no baseline
    entry (fail), findings matched by an entry (reported, accepted), and
    entries that matched nothing (the fix landed — delete the entry).
    With ``passes_run``, entries owned by a pass that did NOT run are
    never reported stale — ``--pass ast`` must not claim the dispatch
    allowlist is obsolete.  With ``device`` (the run's device type), only
    the entries that apply to it match or go stale.
    """
    baseline = [e for e in baseline if e.applies_to(device)]
    allowed: Dict[str, BaselineEntry] = {e.key: e for e in baseline}
    new: List[Finding] = []
    matched: List[Finding] = []
    hit = set()
    for f in findings:
        if f.key in allowed:
            matched.append(f)
            hit.add(f.key)
        else:
            new.append(f)
    ran = None if passes_run is None else set(passes_run)
    stale = [e for e in baseline if e.key not in hit
             and (ran is None or pass_of_rule(e.rule) in ran)]
    return new, matched, stale


def render_report(findings: Sequence[Finding],
                  baseline: Sequence[BaselineEntry],
                  *, passes_run: Iterable[str],
                  device: Optional[str] = None) -> dict:
    """The JSON findings report ``tools/analyze_torch.py`` writes."""
    passes_run = list(passes_run)
    new, matched, stale = check(findings, baseline, passes_run=passes_run,
                                device=device)
    reasons: Dict[str, str] = {}
    for e in baseline:
        if e.applies_to(device):
            reasons.setdefault(e.key, e.reason)  # the first entry wins
    return {
        "passes": sorted(passes_run),
        "ok": not new,
        "new": [f.to_dict() for f in new],
        "allowlisted": [{**f.to_dict(), "reason": reasons[f.key]}
                        for f in matched],
        "stale_baseline_entries": [
            {"rule": e.rule, "where": e.where, "reason": e.reason}
            for e in stale
        ],
    }
