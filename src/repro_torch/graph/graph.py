"""Device-resident streaming graph state (PyTorch port of ``repro.graph.graph``).

A padded COO edge buffer with fixed capacities, the graph analogue of a
KV cache.  Streaming additions and removals write into the preallocated
buffers **in place**: the functions below update the tensors of the state
they are given and return a state that shares them, so a caller must not
keep using the input state (the counterpart of the JAX package's buffer
donation).  A caller that must keep the input state intact (the async
rebuild's served snapshot, the counterpart of the JAX package's
``*_preserving`` variants) applies to a :func:`clone` of it.

Layout (dtypes match the JAX package byte for byte):

- ``src``/``dst``: int32[edge_capacity] COO endpoints; slots at index >=
  ``num_edges`` are padding and hold 0.
- ``edge_alive``: bool[edge_capacity], False for removed edges (tombstones;
  a slot is reclaimed only by :func:`compact`).
- ``num_edges``: int32 0-d tensor, the high-water mark of used slots.
- ``out_deg``/``in_deg``: int32[node_capacity], maintained incrementally.
- ``node_active``: bool[node_capacity], True once a vertex appeared in an
  edge.
- ``edge_len``: optional f32[edge_capacity] per-edge length in slot order.

A state **placed** on a device mesh
(:func:`repro_torch.graph.partition.place_graph_state`, or built from one
rank's slot range by :func:`repro_torch.graph.partition.from_edge_slice`)
holds its edge buffers as ``DTensor`` objects laid out by
``partition.graph_shardings``: each rank keeps the contiguous slot range
its placements give it, while ``num_edges`` and the node vectors stay
whole plain tensors.  ``edge_capacity`` is still the global capacity.
DTensor has no rule for the index ops an edge pass is built from, so a
pass over a placed state runs on :func:`edge_slice` (the rank's local
buffers and the global slot of its first one) and, where its result is
node-sized, meets the other ranks in one all-reduce over
:func:`edge_group`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class GraphState(NamedTuple):
    """Padded COO graph: a NamedTuple of tensors on one device."""

    src: torch.Tensor          # int32[E_cap]
    dst: torch.Tensor          # int32[E_cap]
    edge_alive: torch.Tensor   # bool[E_cap]
    num_edges: torch.Tensor    # int32 0-d
    out_deg: torch.Tensor      # int32[N_cap]
    in_deg: torch.Tensor       # int32[N_cap]
    node_active: torch.Tensor  # bool[N_cap]
    edge_len: Optional[torch.Tensor] = None  # f32[E_cap] or None

    @property
    def node_capacity(self) -> int:
        """Node-space size (vertex ids are < node_capacity)."""
        return self.out_deg.shape[0]

    @property
    def edge_capacity(self) -> int:
        """COO buffer size (live + tombstoned + padding slots)."""
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        """The device every buffer of this state lives on."""
        return self.src.device

    def edge_mask(self) -> torch.Tensor:
        """bool[E_cap]: True for live (non-padding, non-tombstone) edges
        (on a placed state a DTensor of the same placements, each rank's
        shard from its own slots)."""
        sl = edge_slice(self)
        if not _is_dtensor(self.src):
            return sl.mask
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(sl.mask, self.src.device_mesh,
                                  self.src.placements, shape=self.src.shape,
                                  stride=self.src.stride(), run_check=False)

    def num_live_edges(self) -> torch.Tensor:
        """int32 0-d: edges that are in use and not tombstoned."""
        return self.edge_mask().sum(dtype=torch.int32)

    def num_active_nodes(self) -> torch.Tensor:
        """int32 0-d: vertices that have appeared in any edge."""
        return self.node_active.sum(dtype=torch.int32)

    def total_deg(self) -> torch.Tensor:
        """int32[N_cap]: out-degree + in-degree per vertex."""
        return self.out_deg + self.in_deg


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class EdgeSlice(NamedTuple):
    """The edge buffers this rank holds: ``lo`` is the global slot of the
    first; a state that is not placed (or is replicated) holds them all
    (``lo`` 0)."""

    lo: int
    src: torch.Tensor
    dst: torch.Tensor
    edge_alive: torch.Tensor
    edge_len: Optional[torch.Tensor]
    mask: torch.Tensor  # live slots: global slot id < num_edges, alive

    @property
    def hi(self) -> int:
        """One past the global slot of the last local one."""
        return self.lo + self.src.shape[0]


def edge_slice(state: GraphState) -> EdgeSlice:
    """This rank's edge buffers of ``state`` as plain tensors, with the
    global slot of the first, and their live mask (global slot ids compared
    with ``num_edges``)."""
    src = state.src
    lo = 0
    if _is_dtensor(src):
        from repro_torch.sharding.rules import local_index

        lo = local_index(src.shape, src.device_mesh, src.placements)[0].start
    local = lambda t: (None if t is None else
                       t.to_local() if _is_dtensor(t) else t)
    src, dst, alive = local(state.src), local(state.dst), local(
        state.edge_alive)
    in_use = torch.arange(lo, lo + src.shape[0], dtype=torch.int32,
                          device=src.device) < state.num_edges
    return EdgeSlice(lo, src, dst, alive, local(state.edge_len),
                     in_use & alive)


def is_sliced(state: GraphState) -> bool:
    """Whether this rank holds fewer than every edge slot of ``state``."""
    return (_is_dtensor(state.src)
            and state.src.to_local().shape[0] < state.edge_capacity)


def edge_group(state: GraphState):
    """The 1-D device mesh over the mesh dims that a placed state's edge
    slots are split over, the ones ``partition.edge_sharding`` names (a dim
    of size 1 too, whose one rank holds every slot): the ranks whose
    node-sized partial results sum to the whole graph's.  None for a state
    that is not placed, or whose edge buffers the sharding replicates."""
    if not _is_dtensor(state.src):
        return None
    from repro_torch.graph.partition import edge_sharding
    from repro_torch.sharding.rules import flat_mesh

    mesh = state.src.device_mesh
    spec = edge_sharding(mesh, state.edge_capacity).spec
    named = spec[0] if spec else None
    named = (named,) if isinstance(named, str) else tuple(named or ())
    if not named:
        return None
    return flat_mesh(mesh, [a for a in mesh.mesh_dim_names if a in named])


def empty(node_capacity: int, edge_capacity: int, *,
          device=None) -> GraphState:
    """An empty graph with the given capacities on ``device`` (the card
    unless another device is named; see :func:`resolve_device`)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return GraphState(
        src=torch.zeros(edge_capacity, **i32),
        dst=torch.zeros(edge_capacity, **i32),
        edge_alive=torch.ones(edge_capacity, dtype=torch.bool, device=device),
        num_edges=torch.zeros((), **i32),
        out_deg=torch.zeros(node_capacity, **i32),
        in_deg=torch.zeros(node_capacity, **i32),
        node_active=torch.zeros(node_capacity, dtype=torch.bool,
                                device=device),
    )


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    node_capacity: int,
    edge_capacity: int,
    weights: Optional[np.ndarray] = None,
    *,
    device=None,
) -> GraphState:
    """Build a GraphState on ``device`` (the card unless another device is
    named; see :func:`resolve_device`) from host edge arrays (the initial
    graph G).  ``weights`` optionally attaches a per-edge length column;
    slots without one hold 1.0."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be 1-D arrays of equal length")
    m = src.shape[0]
    if m > edge_capacity:
        raise ValueError(f"{m} edges exceed edge_capacity={edge_capacity}")
    if m and (src.max() >= node_capacity or dst.max() >= node_capacity):
        raise ValueError("node id exceeds node_capacity")
    edge_len = None
    if weights is not None:
        weights = np.asarray(weights, np.float32)
        if weights.shape != src.shape:
            raise ValueError("weights must align with src/dst")
        len_pad = np.ones((edge_capacity,), np.float32)
        len_pad[:m] = weights
        edge_len = torch.from_numpy(len_pad).to(device)

    src_pad = np.zeros((edge_capacity,), np.int32)
    dst_pad = np.zeros((edge_capacity,), np.int32)
    src_pad[:m] = src
    dst_pad[:m] = dst
    out_deg = np.bincount(src, minlength=node_capacity).astype(np.int32)
    in_deg = np.bincount(dst, minlength=node_capacity).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(device)
    return GraphState(
        src=to(src_pad),
        dst=to(dst_pad),
        edge_alive=torch.ones(edge_capacity, dtype=torch.bool, device=device),
        num_edges=torch.tensor(m, dtype=torch.int32, device=device),
        out_deg=to(out_deg),
        in_deg=to(in_deg),
        node_active=to((out_deg + in_deg) > 0),
        edge_len=edge_len,
    )


def clone(state: GraphState) -> GraphState:
    """A copy of every buffer of ``state``, for an in-place apply that
    must leave ``state`` itself untouched."""
    return GraphState(*(None if t is None else t.clone() for t in state))


def add_edges(state: GraphState, new_src: torch.Tensor,
              new_dst: torch.Tensor,
              new_len: Optional[torch.Tensor] = None, *,
              num_edges: Optional[int] = None) -> GraphState:
    """Append a chunk of edges **in place** (the input state's buffers are
    updated and shared with the returned state).

    Slots past ``edge_capacity`` are silently dropped: those edges change no
    buffer and no degree (callers check capacity first).  ``new_len``
    optionally streams a per-edge length column; the first weighted chunk
    materializes ``edge_len`` with earlier slots at 1.0, and later
    unweighted chunks leave their slots at 1.0.  ``num_edges`` is the
    state's ``num_edges`` when the caller holds it on the host already;
    then the apply reads nothing from the device.
    """
    k = new_src.shape[0]
    e_cap = state.edge_capacity
    base = int(state.num_edges) if num_edges is None else num_edges
    kept = max(0, min(k, e_cap - base))  # the slots that fit form a prefix
    lo, hi = base, base + kept
    state.src[lo:hi] = new_src[:kept]
    state.dst[lo:hi] = new_dst[:kept]
    state.edge_alive[lo:hi] = True
    edge_len = state.edge_len
    if new_len is not None and edge_len is None:
        edge_len = torch.ones(e_cap, dtype=torch.float32, device=state.device)
    if edge_len is not None:
        edge_len[lo:hi] = (1.0 if new_len is None
                           else new_len[:kept].to(torch.float32))
    ks, kd = new_src[:kept].long(), new_dst[:kept].long()
    one = torch.ones(kept, dtype=torch.int32, device=state.device)
    state.out_deg.index_add_(0, ks, one)
    state.in_deg.index_add_(0, kd, one)
    state.node_active.index_fill_(0, ks, True)
    state.node_active.index_fill_(0, kd, True)
    num_edges = torch.full((), min(base + k, e_cap), dtype=torch.int32,
                           device=state.device)
    return state._replace(num_edges=num_edges, edge_len=edge_len)


def remove_edges_by_slot(state: GraphState,
                         slots: torch.Tensor) -> GraphState:
    """Tombstone the edges stored at ``slots`` **in place**; entries outside
    ``[0, edge_capacity)`` are no-ops.  A slot listed twice decrements its
    endpoints' degrees twice, as in the JAX package."""
    slots = slots.to(device=state.device, dtype=torch.int64)
    valid = (slots >= 0) & (slots < state.edge_capacity)
    slots_c = slots.clamp(0, state.edge_capacity - 1)
    was_alive = state.edge_alive[slots_c] & valid & (slots_c < state.num_edges)
    dec = -was_alive.to(torch.int32)
    state.out_deg.index_add_(0, state.src[slots_c].long(), dec)
    state.in_deg.index_add_(0, state.dst[slots_c].long(), dec)
    state.edge_alive[slots_c[was_alive]] = False
    return state


def find_edge_slots(state: GraphState, src: np.ndarray,
                    dst: np.ndarray) -> np.ndarray:
    """Host-side lookup of the buffer slot holding each given edge (-1 if
    absent); where an edge is stored more than once the lowest live slot
    wins."""
    s = state.src.cpu().numpy().astype(np.int64)
    d = state.dst.cpu().numpy().astype(np.int64)
    live = np.nonzero(state.edge_mask().cpu().numpy())[0]
    # np.unique's first occurrence over ascending slots = the lowest slot
    keys, first = np.unique(s[live] * (2**32) + d[live], return_index=True)
    q = np.asarray(src, np.int64) * (2**32) + np.asarray(dst, np.int64)
    if keys.size == 0:
        return np.full(q.shape, -1, np.int32)
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    return np.where(keys[pos] == q, live[first[pos]], -1).astype(np.int32)


def recompute_degrees(state: GraphState) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(E) degree recomputation, the oracle for the incremental counters."""
    m = state.edge_mask().to(torch.int32)
    n = state.node_capacity
    out_deg = torch.zeros(n, dtype=torch.int32, device=state.device)
    in_deg = torch.zeros(n, dtype=torch.int32, device=state.device)
    out_deg.index_add_(0, state.src.long(), m)
    in_deg.index_add_(0, state.dst.long(), m)
    return out_deg, in_deg


def inv_out_degree(state: GraphState) -> torch.Tensor:
    """f32[N_cap]: 1/d_out(u) with 0 for dangling and inactive vertices."""
    d = state.out_deg.to(torch.float32)
    return torch.where(d > 0, 1.0 / d.clamp(min=1.0), 0.0)


def compact(state: GraphState) -> GraphState:
    """Host-side rebuild dropping tombstones (reclaims removed-edge slots)."""
    mask = state.edge_mask().cpu().numpy()
    s = state.src.cpu().numpy()[mask]
    d = state.dst.cpu().numpy()[mask]
    w = None if state.edge_len is None else state.edge_len.cpu().numpy()[mask]
    return from_edges(s, d, state.node_capacity, state.edge_capacity,
                      weights=w, device=state.device)


def to_networkx(state: GraphState):
    """The live edges as a ``networkx.DiGraph`` over the active vertices
    (a debugging and test helper)."""
    import networkx as nx

    mask = state.edge_mask().cpu().numpy()
    s = state.src.cpu().numpy()[mask]
    d = state.dst.cpu().numpy()[mask]
    g = nx.DiGraph()
    g.add_nodes_from(np.nonzero(state.node_active.cpu().numpy())[0].tolist())
    g.add_edges_from(zip(s.tolist(), d.tolist()))
    return g
