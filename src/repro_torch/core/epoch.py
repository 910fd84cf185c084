"""Epoch-versioned snapshots: the data model of the async rebuild (PyTorch
port of ``repro.core.epoch``).

The synchronous engine applies updates and sorts its layouts between a
query's arrival and its answer.  With ``EngineConfig.async_rebuild=True``
queries serve a frozen :class:`EpochSnapshot` N while snapshot N+1 is
built: its apply, layout sorts and counts are enqueued on a side CUDA
stream after the query's own work, so the answer's read on the main stream
does not wait for them.  The main stream waits on the build's event when
the snapshot is promoted.  On the CPU the build runs inline.

An :class:`EpochSnapshot` freezes everything a query reads:

- the graph buffers: the engine applies each epoch's updates to a clone of
  the live state (:func:`repro_torch.graph.graph.clone`), so a snapshot's
  buffers are never written again;
- the sorted layout per normalized layout spec (built at dispatch for
  every spec the engine has served, lazily for a new one);
- the hot-set baselines (copies of the degrees and the activity) that
  become ``deg_prev``/``active_prev`` once a query serves the epoch;
- the device vector of its counts (:func:`snapshot_counts`), read by the
  engine once, at promotion.

:class:`AsyncRebuildPipeline` holds two slots, ``current`` (served) and
``building`` (dispatched), so ``snapshot_lag`` is 0 or 1.  Promotion
happens at query or wave boundaries only (:meth:`~AsyncRebuildPipeline.
promote`); :meth:`~AsyncRebuildPipeline.dispatch` refuses to overwrite an
unpromoted build and takes only the successor epoch id, so no build is
ever skipped.  Nothing in this module reads the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.graph.graph import GraphState

#: a normalized (weight, reverse, semiring) layout spec, the key of a
#: snapshot's layout cache (see ``repro_torch.core.backend.
#: normalize_layout_spec``)
LayoutSpec = Tuple


def snapshot_counts(state: GraphState) -> torch.Tensor:
    """int32[2] ``[active vertices, live edges]`` of one snapshot, left on
    the device at build time and read at promotion."""
    return torch.stack([state.num_active_nodes(), state.num_live_edges()])


@dataclass
class EpochSnapshot:
    """One immutable serving epoch: graph buffers and what a query derives
    from them, stamped with a monotone epoch id.

    ``deg``/``active`` are this epoch's hot-set baselines; the engine
    installs them as ``deg_prev``/``active_prev`` after serving a query at
    this epoch, so the first query after a flip sees exactly the churn
    between epochs.  ``counts`` is the device vector of
    :func:`snapshot_counts`; ``num_nodes``/``num_edges`` are its values,
    filled in at promotion.  ``applied``/``removals_*`` describe the update
    batch this epoch integrated over its parent: they are charged to the
    query that promotes it.  ``events`` are the CUDA events recorded on the
    build stream before and after the build (None for a build that ran on
    the current stream).  ``rebalance_probe`` holds a mesh engine's
    rebalance verdict for this epoch's state, the ``(bool, f32)`` pair of
    :func:`repro_torch.graph.partition.rebalance_decision` left on the
    device at build time; it is read with ``counts`` at promotion, and a
    recut applies to the next epoch's layouts.
    """

    epoch: int
    state: GraphState
    deg: torch.Tensor
    active: torch.Tensor
    counts: torch.Tensor
    num_nodes: Optional[int] = None
    num_edges: Optional[int] = None
    applied: int = 0
    removals_requested: int = 0
    removals_resolved: int = 0
    rebalance_probe: Optional[Any] = None
    layouts: Dict[LayoutSpec, Any] = field(default_factory=dict)
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    def layout_for(self, spec: LayoutSpec,
                   builder: Callable[[GraphState, LayoutSpec], Any]) -> Any:
        """The snapshot's layout for one normalized spec, built over this
        epoch's buffers on first request and cached: never rebuilt, never
        built over a later epoch."""
        layout = self.layouts.get(spec)
        if layout is None:
            layout = builder(self.state, spec)
            self.layouts[spec] = layout
        return layout


class AsyncRebuildPipeline:
    """Two epoch slots: serve ``current`` while ``building`` is in
    flight.  Host bookkeeping only.

    Invariants (pinned by ``tests/test_torch_async.py``): epoch ids are
    strictly monotone; ``snapshot_lag`` is 0 or 1; a dispatched build is
    promoted before the next dispatch (never skipped or overwritten);
    promotion installs only the build of ``current.epoch + 1``.
    """

    def __init__(self, initial: EpochSnapshot):
        self.current = initial
        self.building: Optional[EpochSnapshot] = None
        self.promotions = 0
        self.dispatches = 0

    @property
    def epoch(self) -> int:
        """The served epoch id."""
        return self.current.epoch

    @property
    def latest_epoch(self) -> int:
        """The newest epoch (the build, if one is in flight)."""
        return (self.building.epoch if self.building is not None
                else self.current.epoch)

    @property
    def snapshot_lag(self) -> int:
        """Epochs the served snapshot trails the newest build: 0 or 1."""
        return self.latest_epoch - self.current.epoch

    def dispatch(self, snapshot: EpochSnapshot) -> None:
        """Register epoch N+1, whose build is already enqueued.  Refuses to
        overwrite an unpromoted build or to take a non-successor id."""
        if self.building is not None:
            raise RuntimeError(
                f"epoch {self.building.epoch} was dispatched but never "
                f"promoted; promote at the wave boundary before "
                f"dispatching epoch {snapshot.epoch}")
        if snapshot.epoch != self.current.epoch + 1:
            raise RuntimeError(
                f"non-monotone epoch dispatch: serving "
                f"{self.current.epoch}, got {snapshot.epoch}")
        self.building = snapshot
        self.dispatches += 1

    def promote(self) -> Optional[EpochSnapshot]:
        """Boundary flip: install the build as ``current`` and return it
        (a host reference swap; the engine orders the device work), or
        None when no build is in flight."""
        if self.building is None:
            return None
        snapshot, self.building = self.building, None
        self.current = snapshot
        self.promotions += 1
        return snapshot
