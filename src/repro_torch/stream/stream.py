"""Edge-update streams — the paper's evaluation protocol (§5).

A stream S is built by uniformly sampling |S| edges (without replacement)
from a dataset's edge list; the *initial graph* is the remaining edges.  S is
split into Q chunks (the paper fixes Q = 50), one chunk applied before each
query.  The paper additionally evaluates a *shuffled* variant to break the
incidence-model ordering of web-graph files; we reproduce both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


@dataclass(frozen=True)
class StreamConfig:
    """The paper's stream protocol parameters: |S| total streamed edges,
    delivered in Q equal chunks (one query per chunk), with optional
    deterministic shuffling of the update order."""

    stream_size: int      # |S| ∈ {5000, 10000, 20000, 40000} in the paper
    num_queries: int = 50  # Q
    shuffle: bool = True
    seed: int = 7

    @property
    def edges_per_query(self) -> int:
        return self.stream_size // self.num_queries


@dataclass
class EdgeStream:
    """The initial graph plus the chunked update stream."""

    init_src: np.ndarray
    init_dst: np.ndarray
    chunks: List[Tuple[np.ndarray, np.ndarray]]
    config: StreamConfig

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return iter(self.chunks)

    @property
    def total_nodes(self) -> int:
        hi = 0
        if self.init_src.size:
            hi = max(hi, int(self.init_src.max()), int(self.init_dst.max()))
        for s, d in self.chunks:
            if s.size:
                hi = max(hi, int(s.max()), int(d.max()))
        return hi + 1

    @property
    def total_edges(self) -> int:
        return int(self.init_src.size) + sum(int(s.size) for s, _ in self.chunks)


def build_stream(src: np.ndarray, dst: np.ndarray, config: StreamConfig) -> EdgeStream:
    """Split a dataset edge list into (initial graph, Q update chunks).

    Sampling matches the paper: stream edges are a uniform sample of the
    dataset's edges; without ``shuffle`` the stream preserves the dataset
    file order (incidence model — out-edges of a vertex arrive together),
    with ``shuffle`` a single offline permutation is applied.
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    m = src.shape[0]
    s_size = min(config.stream_size, m // 2)  # keep a non-trivial initial graph
    rng = np.random.default_rng(config.seed)
    stream_idx = np.sort(rng.choice(m, size=s_size, replace=False))
    mask = np.zeros(m, bool)
    mask[stream_idx] = True

    init_src, init_dst = src[~mask], dst[~mask]
    s_src, s_dst = src[mask], dst[mask]  # dataset order (incidence model)
    if config.shuffle:
        perm = rng.permutation(s_size)
        s_src, s_dst = s_src[perm], s_dst[perm]

    q = config.num_queries
    per = s_size // q
    chunks = [
        (s_src[i * per:(i + 1) * per], s_dst[i * per:(i + 1) * per])
        for i in range(q)
    ]
    return EdgeStream(init_src, init_dst, chunks, config)
