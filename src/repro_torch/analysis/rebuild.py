"""Rebuild detector: kernel builds, library loads and tuning runs, asserted
per loop (the PyTorch counterpart of ``repro.analysis.retrace``).

PyTorch runs eagerly and the port compiles nothing per call, so the
reference's retrace (a jit cache miss) has no direct counterpart.  What
can silently repeat on every warm iteration here is the build side of the
hand-written kernels: an ``nvcc`` build or a ``ctypes`` load of a library
(:func:`repro_torch.kernels.build.build_library`,
:func:`~repro_torch.kernels.build.load_entry`, cached per source, defines
and entry), or a merge-tile search and its timings
(:func:`repro_torch.kernels.spmv.autotune.tune`, cached per key).  A
define set or key that changes per call (a tile picked from a live size,
a key with a per-query field) rebuilds or re-times every iteration, which
shows up only as slowness.  Each of those events ticks
:data:`repro_torch.kernels.build.EVENTS`; :class:`RebuildMonitor` counts
the ticks inside its region.

Two ways to assert, as in the reference:

- **Warm-loop contract**: run one warm-up iteration,
  :meth:`RebuildMonitor.snapshot`, run more identical iterations, then
  :meth:`RebuildMonitor.check_warm` — a warm loop must add **zero**
  events, so every event after the snapshot is an **RB-REBUILD** finding.
- **Budget contract**: :meth:`RebuildMonitor.check` against explicit
  per-event budgets (default one each: a library builds and loads once a
  process, a key is tuned once).

Usage::

    with RebuildMonitor() as mon:
        engine.add_edges(*warmup); engine.query()   # first builds, loads
        warm = mon.snapshot()
        for batch in stream:
            engine.add_edges(*batch)
            engine.query()
    findings = mon.check_warm(warm)
"""

from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import build


class RebuildMonitor:
    """Context manager counting build-side events by ``kind:name``
    (``build``, ``load``, ``autotune-search``, ``autotune-timing``) over
    the monitored region.  Reentrant-safe for sequential use."""

    def __init__(self) -> None:
        self._start: Optional[collections.Counter] = None
        self._end: Optional[collections.Counter] = None

    def __enter__(self) -> "RebuildMonitor":
        self._start = collections.Counter(build.EVENTS)
        self._end = None
        return self

    def __exit__(self, *exc) -> None:
        self._end = collections.Counter(build.EVENTS)

    @property
    def events(self) -> collections.Counter:
        """Events since the region began (to its end once it has ended)."""
        now = self._end if self._end is not None else build.EVENTS
        return collections.Counter(
            {k: n - self._start.get(k, 0) for k, n in now.items()
             if n > self._start.get(k, 0)})

    def snapshot(self) -> collections.Counter:
        """A copy of the per-event counts so far — take one after the
        warm-up iteration, diff with :meth:`check_warm`."""
        return collections.Counter(self.events)

    @staticmethod
    def totals(events: Mapping[str, int]) -> Dict[str, int]:
        """Counts summed per kind (``{"build": 2, "load": 5, ...}``)."""
        out: Dict[str, int] = collections.Counter()
        for name, n in events.items():
            out[name.split(":", 1)[0]] += n
        return dict(out)

    def check_warm(self, warm: Mapping[str, int], *,
                   scenario: str = "engine-loop") -> List[Finding]:
        """Findings for every event that happened *after* the warm-up
        snapshot: a warm engine loop reuses every library it loaded and
        every tile it tuned."""
        findings: List[Finding] = []
        for name, count in sorted(self.events.items()):
            extra = count - warm.get(name, 0)
            if extra > 0:
                findings.append(Finding(
                    pass_id="rebuild", rule="RB-REBUILD",
                    where=f"{scenario}:{name}",
                    detail=f"{name!r} happened {extra}× after the warm-up "
                           f"iteration ({count} total) — the loop rebuilds, "
                           f"reloads or re-tunes on identical (shape, "
                           f"algorithm, geometry) input; a define set or "
                           f"tuning key is changing per call"))
        return findings

    def check(self, max_counts: Optional[Mapping[str, int]] = None, *,
              default_max: int = 1,
              scenario: str = "engine-loop") -> List[Finding]:
        """Findings for every event over its budget (``max_counts`` maps
        ``kind:name`` → allowed count; others get ``default_max``)."""
        budgets: Dict[str, int] = dict(max_counts or {})
        findings: List[Finding] = []
        for name, count in sorted(self.events.items()):
            allowed = budgets.get(name, default_max)
            if count > allowed:
                findings.append(Finding(
                    pass_id="rebuild", rule="RB-REBUILD",
                    where=f"{scenario}:{name}",
                    detail=f"{name!r} happened {count}× (budget {allowed}) "
                           f"over the monitored loop — a define set or "
                           f"tuning key is changing per call; every extra "
                           f"build, load or timing is host time on the "
                           f"hot path"))
        return findings
