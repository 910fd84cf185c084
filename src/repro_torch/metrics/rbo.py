"""Rank-Biased Overlap (Webber, Moffat, Zobel — TOIS 2010).

The paper's accuracy metric: compares the summarized PageRank's ranking
against the exact ranking, weighting higher ranks more heavily.  We implement
extrapolated RBO (RBO_ext, Webber Eq. 32) over prefix depth k, the standard
choice when both lists are available to a fixed evaluation depth — the paper
uses depth 1000 (≤200 edges/query) or 4000 (above).

Host-side numpy: this is an evaluation metric, not device compute.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def rbo_extrapolated(s: Sequence[int], t: Sequence[int], p: float = 0.99,
                     depth: int | None = None) -> float:
    """RBO_ext between two rankings (sequences of distinct ids, best first).

    ``p`` is the persistence parameter (expected evaluation depth 1/(1-p)).
    ``depth`` truncates both lists.  Returns a scalar in [0, 1]; equals 1
    iff the two (truncated) lists contain the same elements at every prefix
    depth.  RBO_ext(S,T) = (1-p)/1 · Σ_{d=1..k} (X_d/d)·p^{d-1}·(1-p)… — we
    use the prefix form  (1-p)·Σ_{d<k} A_d·p^{d-1} + A_k·p^{k-1}  with
    A_d = X_d/d, which reduces to Webber Eq. 32 when |S|=|T|=k.
    """
    if depth is not None:
        s = list(s[:depth])
        t = list(t[:depth])
    else:
        s = list(s)
        t = list(t)
    k = max(len(s), len(t))
    if k == 0:
        return 1.0
    if min(len(s), len(t)) == 0:
        return 0.0

    seen_s: set = set()
    seen_t: set = set()
    overlap = 0            # |S_{:d} ∩ T_{:d}|
    weighted_sum = 0.0     # Σ_{d=1..k-1} A_d · p^{d-1}
    weight = 1.0           # p^{d-1}
    a_d = 0.0
    for d in range(1, k + 1):
        e_s = s[d - 1] if d <= len(s) else None
        e_t = t[d - 1] if d <= len(t) else None
        if e_s is not None and e_s == e_t:
            overlap += 1
        else:
            if e_s is not None and e_s in seen_t:
                overlap += 1
            if e_t is not None and e_t in seen_s:
                overlap += 1
        if e_s is not None:
            seen_s.add(e_s)
        if e_t is not None:
            seen_t.add(e_t)
        a_d = overlap / d
        if d < k:
            weighted_sum += a_d * weight
        weight *= p
    # contribution of depths 1..k-1, plus extrapolation of A_k beyond depth k
    return float((1.0 - p) * weighted_sum + a_d * (p ** (k - 1)))


def rbo_from_scores(scores_a: np.ndarray, scores_b: np.ndarray, *,
                    depth: int, p: float = 0.99,
                    active: np.ndarray | None = None) -> float:
    """RBO_ext between the rankings induced by two score vectors.

    Ties broken by vertex id (stable), matching a deterministic sort of the
    engine's output.  ``active`` restricts to active vertices.
    """
    a = np.asarray(scores_a, np.float64)
    b = np.asarray(scores_b, np.float64)
    if active is not None:
        idx = np.nonzero(np.asarray(active))[0]
    else:
        idx = np.arange(a.shape[0])
    d = min(depth, idx.shape[0])
    # top-d by (-score, id): lexsort uses the last key as primary
    top_a = idx[np.lexsort((idx, -a[idx]))][:d]
    top_b = idx[np.lexsort((idx, -b[idx]))][:d]
    return rbo_extrapolated(top_a.tolist(), top_b.tolist(), p=p)
