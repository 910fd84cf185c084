"""Synthetic graph generators (offline stand-ins for the paper's datasets).

The container has no network access, so the LAW/SNAP datasets in the paper's
Table 1 (cnr-2000, eu-2005, Cit-HepPh, enron, dblp-2010, amazon-2008,
Facebook-ego) are unavailable.  We generate synthetic graphs from the same
structural families — scale-free preferential attachment for web/social
graphs, a time-ordered preferential-attachment DAG for the citation network,
G(n,m) as an unstructured control — and mirror the paper's protocol on them.
All generators are numpy-based (networkx is too slow at these sizes) and
deterministic given a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def barabasi_albert_edges(
    n: int, m: int, seed: int = 0, directed_both: float = 0.25
) -> Tuple[np.ndarray, np.ndarray]:
    """Directed scale-free graph via the repeated-nodes BA construction.

    Each new node u attaches m out-edges to targets sampled proportionally to
    degree (classic Barabási–Albert).  With probability ``directed_both`` a
    reciprocal edge is added, approximating the partial symmetry of web
    graphs.  O(n·m) time.
    """
    rng = np.random.default_rng(seed)
    if n <= m:
        raise ValueError("n must exceed m")
    # `repeated` holds one entry per edge endpoint => sampling uniformly from
    # it is sampling proportional to degree.
    repeated = np.empty(2 * n * m + 2 * m, np.int64)
    rsize = 0
    src_l = np.empty(n * m, np.int64)
    dst_l = np.empty(n * m, np.int64)
    e = 0
    # seed clique-ish core: node m attaches to 0..m-1
    for t in range(m):
        src_l[e], dst_l[e] = m, t
        repeated[rsize] = m
        repeated[rsize + 1] = t
        rsize += 2
        e += 1
    for u in range(m + 1, n):
        # sample m distinct targets from the repeated-node pool
        targets = repeated[rng.integers(0, rsize, size=4 * m)]
        targets = np.unique(targets)[:m]
        while targets.shape[0] < m:
            extra = repeated[rng.integers(0, rsize, size=4 * m)]
            targets = np.unique(np.concatenate([targets, extra]))[:m]
        k = targets.shape[0]
        src_l[e : e + k] = u
        dst_l[e : e + k] = targets
        repeated[rsize : rsize + k] = u
        repeated[rsize + k : rsize + 2 * k] = targets
        rsize += 2 * k
        e += k
    src = src_l[:e]
    dst = dst_l[:e]
    # reciprocal edges
    flip = np.random.default_rng(seed + 1).random(e) < directed_both
    src = np.concatenate([src, dst[flip]])
    dst = np.concatenate([dst, src[:e][flip]])
    return src.astype(np.int32), dst.astype(np.int32)


def citation_dag_edges(
    n: int, m: int, seed: int = 0, recency_bias: float = 0.3
) -> Tuple[np.ndarray, np.ndarray]:
    """Time-ordered preferential-attachment DAG (Cit-HepPh stand-in).

    Node u (published at time u) cites ~m earlier papers, chosen by a mix of
    preferential attachment and recency — edges always point backwards in
    time, giving the acyclic structure of citation networks.
    """
    rng = np.random.default_rng(seed)
    deg = np.ones(n, np.float64)  # +1 smoothing
    src_l, dst_l = [], []
    for u in range(1, n):
        k = min(u, 1 + rng.poisson(m - 1))
        if rng.random() < recency_bias and u > 10:
            # recency: cite among the latest 10% of papers
            lo = max(0, int(u * 0.9))
            cand = rng.integers(lo, u, size=k)
        else:
            p = deg[:u] / deg[:u].sum()
            cand = rng.choice(u, size=k, p=p, replace=True)
        cand = np.unique(cand)
        src_l.append(np.full(cand.shape[0], u, np.int64))
        dst_l.append(cand)
        deg[cand] += 1.0
        deg[u] += cand.shape[0]
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    return src, dst


def gnm_edges(n: int, m: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Erdős–Rényi G(n,m) directed, no self loops (duplicates possible but rare)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=int(m * 1.05)).astype(np.int32)
    dst = rng.integers(0, n, size=int(m * 1.05)).astype(np.int32)
    ok = src != dst
    return src[ok][:m], dst[ok][:m]


def community_ego_edges(
    n: int, n_comm: int, p_in_deg: float, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense community graph (Facebook-ego stand-in): planted partitions with
    degree-skewed intra-community edges plus a sparse global hub overlay."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comm, size=n)
    order = np.argsort(comm, kind="stable")
    src_l, dst_l = [], []
    for c in range(n_comm):
        members = order[np.searchsorted(comm[order], c, "left"):
                        np.searchsorted(comm[order], c, "right")]
        k = members.shape[0]
        if k < 2:
            continue
        m_edges = int(p_in_deg * k)
        # power-law-ish endpoint choice inside the community
        a = members[np.minimum((rng.pareto(2.0, m_edges)).astype(np.int64), k - 1)]
        b = members[rng.integers(0, k, size=m_edges)]
        ok = a != b
        src_l.append(a[ok])
        dst_l.append(b[ok])
    # hub overlay: 1% hubs receive global edges
    hubs = rng.choice(n, size=max(1, n // 100), replace=False)
    g_src = rng.integers(0, n, size=n)
    g_dst = hubs[rng.integers(0, hubs.shape[0], size=n)]
    ok = g_src != g_dst
    src_l.append(g_src[ok])
    dst_l.append(g_dst[ok])
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    return src, dst


@dataclass(frozen=True)
class DatasetSpec:
    """A named synthetic dataset: generator id + kwargs, scaled to the
    paper's Table 1 families (hashable, so specs can key caches)."""

    name: str
    family: str        # web | social | citation | ego | random
    nodes: int
    gen: str           # generator id
    gen_kwargs: tuple  # sorted kv pairs, hashable
    stream_size: int   # |S| per the paper's Table 1 scaling
    paper_analogue: str


# CPU-scaled stand-ins for Table 1.  Node counts are ~the paper's smaller
# datasets; stream sizes follow the paper's |S| choices.
DATASETS: Dict[str, DatasetSpec] = {
    "synth-web": DatasetSpec(
        "synth-web", "web", 100_000, "ba", (("m", 8), ("directed_both", 0.3)),
        40_000, "cnr-2000 (325k/3.2M)"),
    "synth-web-lg": DatasetSpec(
        "synth-web-lg", "web", 300_000, "ba", (("m", 10), ("directed_both", 0.3)),
        20_000, "eu-2005 (862k/19.2M)"),
    "synth-citation": DatasetSpec(
        "synth-citation", "citation", 34_000, "citation", (("m", 12),),
        40_000, "Cit-HepPh (34.5k/421k)"),
    "synth-social": DatasetSpec(
        "synth-social", "social", 70_000, "ba", (("m", 4), ("directed_both", 0.6)),
        40_000, "enron (69k/276k)"),
    "synth-dblp": DatasetSpec(
        "synth-dblp", "social", 100_000, "ba", (("m", 5), ("directed_both", 0.9)),
        40_000, "dblp-2010 (326k/1.6M)"),
    "synth-amazon": DatasetSpec(
        "synth-amazon", "social", 150_000, "gnm", (("m_edges", 1_000_000),),
        20_000, "amazon-2008 (735k/5.2M)"),
    "synth-ego": DatasetSpec(
        "synth-ego", "ego", 60_000, "ego", (("n_comm", 120), ("p_in_deg", 18.0)),
        40_000, "Facebook-ego (63.7k/1.5M)"),
}


def generate(spec_or_name, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize a dataset's edge list (deduplicated)."""
    spec = DATASETS[spec_or_name] if isinstance(spec_or_name, str) else spec_or_name
    kw = dict(spec.gen_kwargs)
    if spec.gen == "ba":
        src, dst = barabasi_albert_edges(
            spec.nodes, int(kw["m"]), seed, kw.get("directed_both", 0.25))
    elif spec.gen == "citation":
        src, dst = citation_dag_edges(spec.nodes, int(kw["m"]), seed)
    elif spec.gen == "gnm":
        src, dst = gnm_edges(spec.nodes, int(kw["m_edges"]), seed)
    elif spec.gen == "ego":
        src, dst = community_ego_edges(
            spec.nodes, int(kw["n_comm"]), float(kw["p_in_deg"]), seed)
    else:
        raise ValueError(f"unknown generator {spec.gen}")
    # dedupe (streams sample without replacement from unique edges)
    key = src.astype(np.int64) * np.int64(2**32) + dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return src[idx], dst[idx]
