"""Ranking utilities: top-k extraction and rank-value deltas."""

from __future__ import annotations

import numpy as np


def top_k_ids(scores: np.ndarray, k: int,
              active: np.ndarray | None = None) -> np.ndarray:
    """ids of the k highest scores, ties broken by id (deterministic)."""
    s = np.asarray(scores, np.float64)
    idx = np.nonzero(np.asarray(active))[0] if active is not None \
        else np.arange(s.shape[0])
    k = min(k, idx.shape[0])
    return idx[np.lexsort((idx, -s[idx]))][:k]


def l1_delta(a: np.ndarray, b: np.ndarray,
             active: np.ndarray | None = None) -> float:
    """L1 distance between two score vectors over the active mask."""
    m = np.asarray(active, bool) if active is not None \
        else np.ones(len(a), bool)
    return float(np.abs(np.asarray(a)[m] - np.asarray(b)[m]).sum())


def linf_delta(a: np.ndarray, b: np.ndarray,
               active: np.ndarray | None = None) -> float:
    """L∞ (max per-vertex) distance between two score vectors."""
    m = np.asarray(active, bool) if active is not None \
        else np.ones(len(a), bool)
    return float(np.abs(np.asarray(a)[m] - np.asarray(b)[m]).max())
