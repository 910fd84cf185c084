"""Built-in OnQuery / BeforeUpdates policies (paper §4: "for simple rules,
these functions don't need to be programmed").

Each factory returns a callable with the engine's UDF signature.  These map
directly to the paper's three action indicators: repeat-last-answer,
compute-approximate, compute-exact.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.algorithm import Action


def _updates_since_compute(view: Dict) -> int:
    """Updates not yet reflected in the current scores: those integrated
    under earlier repeat-last answers plus this query's batch (applied or
    still buffered — BeforeUpdates may have deferred application).  The view
    is refreshed after ApplyUpdates, so ``pending`` alone would read 0 once
    the engine has integrated the batch."""
    if "since_compute" in view:
        return int(view["since_compute"])
    return int(view.get("applied", 0)) + int(view.get("pending", 0))


def always(action: Action) -> Callable[[int, Dict], Action]:
    """Fixed action every query (the paper's evaluation uses always-approx)."""
    def policy(query_id: int, view: Dict) -> Action:
        return action
    return policy


def repeat_below_threshold(min_pending: int) -> Callable[[int, Dict], Action]:
    """Repeat the last answer when fewer than ``min_pending`` updates have
    arrived since the last computed answer; otherwise approximate (paper §7:
    "repeating the last results if the updates were not deemed
    significant")."""
    def policy(query_id: int, view: Dict) -> Action:
        if _updates_since_compute(view) < min_pending:
            return Action.REPEAT_LAST
        return Action.APPROXIMATE
    return policy


def exact_above_entropy(max_update_ratio: float) -> Callable[[int, Dict], Action]:
    """Exact recompute when accumulated updates exceed a fraction of |E|
    (paper §7: "performing an exact computation if too much entropy has
    accumulated"); otherwise approximate."""
    def policy(query_id: int, view: Dict) -> Action:
        if view["num_edges"] > 0 and \
                _updates_since_compute(view) / view["num_edges"] > max_update_ratio:
            return Action.EXACT
        return Action.APPROXIMATE
    return policy


def periodic_exact(every: int) -> Callable[[int, Dict], Action]:
    """Exact refresh every ``every`` queries to bound error accumulation
    (beyond-paper: counteracts the RBO drift the paper observes in Figs 5/9/…)."""
    def policy(query_id: int, view: Dict) -> Action:
        if every > 0 and query_id > 0 and query_id % every == 0:
            return Action.EXACT
        return Action.APPROXIMATE
    return policy
