"""Edge partitioning over a device mesh (PyTorch port of
``repro.graph.partition``, its layout half).

The sharded engine cuts the edge buffer into shards while node vectors
stay whole on every rank: a push is one partial push per shard plus one
all-reduce of the dense result.  Two layers live here:

- the **sharded edge layouts** the propagation backend consumes
  (:func:`build_sharded_layout`): the edge buffer cut into contiguous slot
  ranges, each destination-sorted on its own, so no sort ever crosses a
  shard boundary;
- **shard rebalancing** (:func:`rebalance_sharded_layout` and the pieces
  it is built from): streaming appends land at the high-water mark, so the
  contiguous cut fills its tail shards first and removals hollow out
  arbitrary ones.  The engine measures per-shard live-edge counts after
  each applied update batch and, past ``EngineConfig.rebalance_threshold``,
  recuts the partition with a live-balanced slot assignment
  (:func:`balanced_shard_slots`) that the next layout build gathers its
  streams by.  Any valid partition gives the same push (bitwise for the
  min/max semirings), so rebalancing only moves load.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of one or more
dimensions; a layout's edge shards run over the product of its axes
(``mesh_axes``, every axis by default), which :func:`build_sharded_layout`
flattens into one 1-D mesh (``sharding.rules.flat_mesh``), so every push,
summary and rebalance below sees one edge-shard axis.  Each rank keeps
the rows of its own ``num_shards / R`` shards (:func:`place_sharded_layout`).
:func:`edge_sharding`/:func:`graph_shardings` give the raw graph buffers'
shardings under the sharding rules: edge buffers over the mesh by the
``edges`` rule, node vectors replicated.  :func:`place_graph_state` lays a
state out by them, so that a rank holds only its slot range of the edge
buffers, and :func:`from_edge_slice` builds that rank's state from its
slot range alone (a loader that never holds the whole graph).  A placed
layout builds from such a state with no communication: a rank's shards
are slot ranges inside its own (:func:`build_sharded_layout`).  The
engine keeps the whole state (a rebalanced partition moves slots between
ranks, which a sliced state cannot do here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import backend as B
from repro_torch.graph.graph import (GraphState, edge_group, edge_slice,
                                     inv_out_degree, is_sliced)
from repro_torch.sharding.rules import (NamedSharding, flat_mesh,
                                        flat_sum, guarded_pspec,
                                        local_index, mesh_axis_names,
                                        rules_for_mesh)

#: what a sliced state cannot do yet, and where the work is queued
SLICED_REBALANCE = ("a rebalanced slot assignment moves edges between the "
                    "ranks' slices, which the port does not do yet (ROADMAP "
                    "queue 1 entry 15); rebalance on the whole state")


def edge_sharding(mesh, edge_capacity: int) -> NamedSharding:
    """The sharding of an edge-capacity buffer: the ``edges`` logical axis
    laid over the mesh (a ``DeviceMesh`` with dim names) per its rules,
    where the capacity divides."""
    sizes = dict(zip(mesh_axis_names(mesh), mesh.mesh.shape))
    return NamedSharding(mesh, guarded_pspec(
        (edge_capacity,), ("edges",), rules_for_mesh(mesh), sizes))


def graph_shardings(mesh, state: GraphState) -> GraphState:
    """A ``GraphState`` of shardings: edge buffers by
    :func:`edge_sharding`, node vectors and the edge count replicated."""
    e = edge_sharding(mesh, state.edge_capacity)
    n = NamedSharding(mesh, ())
    return GraphState(src=e, dst=e, edge_alive=e, num_edges=n,
                      out_deg=n, in_deg=n, node_active=n,
                      edge_len=None if state.edge_len is None else e)


def edge_slot_range(mesh, edge_capacity: int) -> Tuple[int, int]:
    """``(lo, hi)``: the global edge slots this rank holds under
    :func:`edge_sharding` (every slot where the buffer is replicated)."""
    sh = edge_sharding(mesh, edge_capacity)
    idx = local_index((edge_capacity,), mesh, sh.placements)[0]
    return idx.start, idx.stop


def _edge_dtensor(local: torch.Tensor, mesh,
                  edge_capacity: int) -> DTensor:
    """This rank's slot range ``local`` of an edge buffer as the DTensor
    :func:`edge_sharding` places (no collective)."""
    return DTensor.from_local(
        local, mesh, edge_sharding(mesh, edge_capacity).placements,
        shape=(edge_capacity,), stride=(1,), run_check=False)


def place_graph_state(state: GraphState, mesh) -> GraphState:
    """``state`` laid out as :func:`graph_shardings` gives (the
    reference's ``in_shardings``): each edge buffer a ``DTensor`` of which
    this rank keeps a copy of its own slot range only, ``num_edges`` and
    the node vectors as they are.  Every rank passes the whole state; no
    collective runs."""
    if isinstance(state.src, DTensor):
        raise ValueError("place_graph_state takes a state that is not "
                         "placed yet")
    e_cap = state.edge_capacity
    lo, hi = edge_slot_range(mesh, e_cap)
    cut = lambda t: (None if t is None else
                     _edge_dtensor(t[lo:hi].clone(), mesh, e_cap))
    return state._replace(src=cut(state.src), dst=cut(state.dst),
                          edge_alive=cut(state.edge_alive),
                          edge_len=cut(state.edge_len))


def from_edge_slice(mesh, src, dst, *, node_capacity: int,
                    edge_capacity: int, num_edges: int, weights=None,
                    degrees=None) -> GraphState:
    """This rank's placed state (as :func:`place_graph_state` lays it out)
    from its own slot range alone: ``src``/``dst`` (and ``weights``) hold
    the edges of the slots ``[lo, min(hi, num_edges))`` of
    :func:`edge_slot_range`, in slot order; later slots are padding.

    ``degrees`` ``(out_deg, in_deg)`` are the whole graph's, where the
    caller counted them; without them each rank counts its own slots and
    the counts meet in one all-reduce over the ranks the edges are split
    over.  The buffers go to the mesh's device on this rank."""
    device = (torch.device("cpu") if mesh.device_type == "cpu" else
              torch.device(mesh.device_type, torch.cuda.current_device()))
    lo, hi = edge_slot_range(mesh, edge_capacity)
    m = max(0, min(hi, num_edges) - lo)
    src = torch.as_tensor(src, dtype=torch.int32).to(device)
    dst = torch.as_tensor(dst, dtype=torch.int32).to(device)
    if src.shape != (m,) or dst.shape != (m,):
        raise ValueError(f"this rank holds slots [{lo}, {hi}) of which "
                         f"{m} are below num_edges={num_edges}; got src "
                         f"{tuple(src.shape)}, dst {tuple(dst.shape)}")
    pad = lambda t, v: torch.nn.functional.pad(t, (0, hi - lo - m), value=v)
    place = lambda t: _edge_dtensor(t, mesh, edge_capacity)
    edge_len = None
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32).to(device)
        if w.shape != (m,):
            raise ValueError("weights must align with src/dst")
        edge_len = place(pad(w, 1.0))
    state = GraphState(
        src=place(pad(src, 0)), dst=place(pad(dst, 0)),
        edge_alive=place(torch.ones(hi - lo, dtype=torch.bool,
                                    device=device)),
        num_edges=torch.tensor(num_edges, dtype=torch.int32, device=device),
        out_deg=None, in_deg=None, node_active=None, edge_len=edge_len)
    if degrees is None:
        count = lambda ids: torch.bincount(
            ids.long(), minlength=node_capacity).to(torch.int32)
        out_deg, in_deg = count(src), count(dst)
        group = edge_group(state)
        if group is not None:
            out_deg, in_deg = flat_sum(torch.stack([out_deg, in_deg]),
                                       group)
    else:
        out_deg, in_deg = (torch.as_tensor(d, dtype=torch.int32).to(device)
                           for d in degrees)
    return state._replace(out_deg=out_deg, in_deg=in_deg,
                          node_active=(out_deg + in_deg) > 0)


def host_edge_slice(num_edges: int, process: int,
                    num_processes: int) -> Tuple[int, int]:
    """Contiguous per-host ingestion range (multi-host streaming loaders)."""
    per = (num_edges + num_processes - 1) // num_processes
    lo = min(process * per, num_edges)
    return lo, min(lo + per, num_edges)


# ---------------------------------------------------------------------------
# Sharded edge layouts (the sharded push's input)
# ---------------------------------------------------------------------------


def shard_slots(edge_capacity: int, num_shards: int) -> np.ndarray:
    """int32[S, E_s] original edge slot per (shard, position): the
    contiguous cut :func:`build_sharded_layout` makes before its per-shard
    sorts.  Shard ``s`` owns slots ``[s·E_s, (s+1)·E_s)``; positions past
    ``edge_capacity`` are padding (sentinel ``edge_capacity``)."""
    e_s = -(-edge_capacity // num_shards)
    slots = np.arange(num_shards * e_s, dtype=np.int32)
    return np.where(slots < edge_capacity, slots,
                    edge_capacity).astype(np.int32).reshape(num_shards, e_s)


def _build_shards(state: GraphState, *, num_shards: int, weight: str,
                  reverse: bool, chunk: int, semiring: str,
                  lengths: Optional[torch.Tensor] = None,
                  slots: Optional[torch.Tensor] = None,
                  weight_dtype: Optional[str] = None,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> B.ShardedEdgeLayout:
    """The array work of :func:`build_sharded_layout`: bake the weights in
    slot order, cut the slots into shards (contiguously, or by ``slots``),
    and sort each shard by destination on its own; ``rows`` ``(lo, hi)``
    builds shards ``lo..hi-1`` only (each shard's rows are those of the
    whole build).  On a placed state the work runs on this rank's slot
    range (:func:`~repro_torch.graph.graph.edge_slice`), which must hold
    the rows' slots: the contiguous cut then needs no communication, and
    ``order`` keeps global slot ids."""
    if weight == "length" and lengths is None:
        lengths = state.edge_len
    s = B.validate_weight_spec(weight, reverse=reverse, semiring=semiring,
                               lengths=lengths,
                               edge_capacity=state.edge_capacity)
    dev = state.device
    e_cap, n_cap = state.edge_capacity, state.node_capacity
    es = edge_slice(state)
    if slots is not None and is_sliced(state):
        raise NotImplementedError(SLICED_REBALANCE)
    if isinstance(lengths, DTensor):
        lengths = lengths.to_local()
    elif lengths is not None and lengths.shape[0] != es.src.shape[0]:
        lengths = lengths[es.lo:es.hi]
    mask = es.mask
    e_src, e_dst = (es.dst, es.src) if reverse else (es.src, es.dst)
    # the ⊗-operand of build_layout, here in slot order
    w = B.bake_weights(s, weight, mask, e_src, inv_deg=inv_out_degree(state),
                       lengths=lengths, weight_dtype=weight_dtype)
    # analysis: allow(AST-HOST-SYNC): a numpy identity, no device read
    zero = s.zero.item()

    e_s = -(-e_cap // num_shards)
    lo, hi = (0, num_shards) if rows is None else rows
    if slots is None:
        first, last = lo * e_s, min(hi * e_s, e_cap)
        if first < es.lo or last > es.hi:
            raise ValueError(
                f"shards {lo}..{hi - 1} hold slots [{first}, {last}), "
                f"outside this rank's slots [{es.lo}, {es.hi}): a sliced "
                f"state builds its own rows only (placed=True, num_shards "
                f"a multiple of the ranks the edges are split over, and "
                f"edge_capacity a multiple of num_shards)")

        def cut(x, cval):
            part = x[first - es.lo:last - es.lo]
            return torch.nn.functional.pad(
                part, (0, (hi - lo) * e_s - part.shape[0]),
                value=cval).reshape(hi - lo, e_s)
    else:
        # a rebalanced partition: one gather per buffer migrates the slots
        held = slots[lo:hi]
        ok = held < e_cap
        sl = held.clamp(max=e_cap - 1).long()

        def cut(x, cval):
            return torch.where(ok, x[sl], cval)

    src2 = cut(e_src, 0)
    dst2 = cut(torch.where(mask, e_dst, n_cap), n_cap)  # invalid sorts last
    w2 = cut(w, zero)
    valid2 = cut(mask, False)
    order2 = cut(torch.arange(es.lo, es.hi, dtype=torch.int32, device=dev),
                 e_cap)

    # S independent stable destination sorts, one per row
    dst2, perm = torch.sort(dst2, dim=1, stable=True)
    src2, w2, valid2, order2 = (x.gather(1, perm)
                                for x in (src2, w2, valid2, order2))
    row_offsets = torch.searchsorted(
        dst2, torch.arange(n_cap + 1, dtype=torch.int32, device=dev).expand(
            hi - lo, n_cap + 1).contiguous(), side="left", out_int32=True)

    # the chunk slack of a single layout, per shard
    extra = B.padded_length(e_s, chunk) - e_s
    pad2 = lambda x, cval: torch.nn.functional.pad(x, (0, extra), value=cval)
    dst_p = pad2(dst2, n_cap)
    valid_p = pad2(valid2, False)
    rank = (B.stream_rank(dst_p, valid_p, row_offsets)
            if s.add != "sum" else None)
    return B.ShardedEdgeLayout(
        pad2(src2, 0), dst_p, pad2(w2, zero), valid_p, row_offsets,
        pad2(order2, e_cap), rank, weight_mode=weight, reverse=reverse,
        pad_chunk=chunk, semiring=s.name)


def build_sharded_layout(
    state: GraphState,
    *,
    mesh=None,
    axes: Optional[Tuple[str, ...]] = None,
    num_shards: Optional[int] = None,
    weight: str = "inv_out",
    reverse: bool = False,
    chunk: Optional[int] = None,
    semiring: str = "plus_times",
    lengths: Optional[torch.Tensor] = None,
    slots=None,
    weight_dtype: Optional[str] = None,
    placed: bool = False,
) -> B.ShardedEdgeLayout:
    """Edge-partitioned, per-shard destination-sorted propagation layout.

    The sharded sibling of :func:`repro_torch.core.backend.build_layout`,
    over the same ``weight``/``reverse``/``semiring``/``lengths`` specs;
    the edge stream is first cut into ``num_shards`` slot ranges and each
    shard sorted on its own.

    ``mesh`` is a ``DeviceMesh`` whose ``axes`` (default: every dim) the
    shards run over, flattened into the 1-D mesh the layout carries;
    ``num_shards`` defaults to their product and must be a multiple of
    it.  With ``mesh=None`` (``num_shards`` required) every
    shard is pushed here: the reference semantics, and how a single device
    runs S-way partitioning.  ``slots`` (int32[S, ⌈E_cap/S⌉], sentinel
    ``E_cap`` in padding, every live slot exactly once) replaces the
    contiguous cut of :func:`shard_slots`, e.g. by
    :func:`balanced_shard_slots`.

    Returns every shard's rows, ``[num_shards, E_pad]`` each;
    :func:`place_sharded_layout` keeps this rank's.  With a mesh and
    ``placed`` it builds this rank's rows only: the placed layout, without
    the other ranks' sorts and row offsets (the engine's build; at a
    pod's shard count the whole build's ``[S, N + 1]`` row offsets alone
    would not fit a card).
    """
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if axes is not None:
            axes = tuple(axes)
            for a in axes:
                if a not in names:
                    raise ValueError(f"mesh axis {a!r} not in mesh {names}")
        n_dev = mesh_shard_count(mesh, axes)
        mesh = flat_mesh(mesh, axes)
        axes = axes if axes is not None else names
        if num_shards is None:
            num_shards = n_dev
        if num_shards < 1 or num_shards % n_dev:
            raise ValueError(
                f"num_shards={num_shards} must be a positive multiple of "
                f"the {n_dev} devices on mesh axes {axes}")
    elif num_shards is None:
        raise ValueError("build_sharded_layout needs mesh= or num_shards=")
    else:
        axes = ()
    if slots is not None:
        want = (num_shards, -(-state.edge_capacity // num_shards))
        if tuple(slots.shape) != want:
            raise ValueError(
                f"slots assignment shape {tuple(slots.shape)} does not "
                f"match {want} for num_shards={num_shards}, "
                f"edge_capacity={state.edge_capacity}")
        slots = torch.as_tensor(slots, dtype=torch.int32, device=state.device)
    rows = None
    if mesh is not None and placed:
        rank, size = B.mesh_rank_and_size(mesh)
        per = num_shards // size
        rows = (rank * per, (rank + 1) * per)
    layout = _build_shards(
        state, num_shards=num_shards, weight=weight, reverse=reverse,
        chunk=B.CHUNK if chunk is None else chunk, semiring=semiring,
        lengths=lengths, slots=slots, weight_dtype=weight_dtype, rows=rows)
    if mesh is not None:
        layout = dataclasses.replace(
            layout, mesh=mesh, axes=axes,
            total_shards=num_shards if placed else None)
    return layout


# ---------------------------------------------------------------------------
# Shard rebalancing (streaming keeps the contiguous cut tail-heavy)
# ---------------------------------------------------------------------------


def mesh_shard_count(mesh, axes: Optional[Tuple[str, ...]] = None) -> int:
    """The ranks over ``axes`` (default: every mesh axis): the shard count a
    mesh engine cuts its layouts into unless ``num_shards`` asks for
    more.  The one definition :func:`build_sharded_layout` and the
    engine's rebalance path both go through."""
    if axes is None:
        return mesh.size()
    names = mesh_axis_names(mesh)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    return n


def shard_live_counts(state: GraphState, slots: torch.Tensor) -> torch.Tensor:
    """int32[S]: live edges per shard under a slot assignment, the balance
    signal measured after each applied update batch."""
    e_cap = state.edge_capacity
    ok = slots < e_cap
    live = ok & state.edge_mask()[slots.clamp(max=e_cap - 1).long()]
    return live.sum(dim=1, dtype=torch.int32)


def shard_imbalance(counts: torch.Tensor) -> torch.Tensor:
    """Scalar imbalance of per-shard live counts, ``(max − min) /
    max(mean, 1)``: 0 for an even partition, about S when one shard holds
    everything."""
    c = counts.to(torch.float32)
    return (c.max() - c.min()) / c.mean().clamp(min=1.0)


def balanced_shard_slots(state: GraphState, *,
                         num_shards: int) -> torch.Tensor:
    """A live-balanced slot→shard assignment (int32[S, ⌈E_cap/S⌉]).

    Live slots are dealt round-robin across shards in slot order (counts
    differ by at most one), then dead and padding slots continue the same
    deal, so the slots the next appends fill are spread across shards as
    well.  Prefix sums only; feed it to :func:`build_sharded_layout` as
    ``slots``."""
    e_cap = state.edge_capacity
    dev = state.device
    e_s = -(-e_cap // num_shards)
    mask = state.edge_mask()
    m = mask.to(torch.int32)
    live_rank = torch.cumsum(m, 0, dtype=torch.int32) - m
    dead_rank = torch.cumsum(1 - m, 0, dtype=torch.int32) - (1 - m)
    seq = torch.where(mask, live_rank, m.sum(dtype=torch.int32) + dead_rank)
    flat = (seq % num_shards) * e_s + seq // num_shards
    out = torch.full((num_shards * e_s,), e_cap, dtype=torch.int32,
                     device=dev)
    out[flat.long()] = torch.arange(e_cap, dtype=torch.int32, device=dev)
    return out.reshape(num_shards, e_s)


def rebalance_decision(state: GraphState, slots: torch.Tensor,
                       threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rebalance verdict on the device: ``(should_rebalance bool 0-d,
    imbalance f32 0-d)`` for the current assignment.  Nothing is read to
    the host here; the engine reads the pair once per applied batch, and
    the async pipeline leaves it on the device until the snapshot it was
    measured on is promoted (a recut then applies to the next epoch's
    layouts)."""
    imbalance = shard_imbalance(shard_live_counts(state, slots))
    return imbalance > threshold, imbalance


def rebalance_sharded_layout(
    state: GraphState,
    *,
    num_shards: int,
    slots: Optional[torch.Tensor] = None,
    threshold: float = 1.0,
) -> Tuple[torch.Tensor, bool, float]:
    """Recut the edge partition when live-edge imbalance exceeds
    ``threshold``.

    ``slots`` is the current assignment (default: the contiguous cut of
    :func:`shard_slots`).  Returns ``(slots', rebalanced, imbalance)``:
    the assignment to build the next layouts with, whether it changed, and
    the imbalance measured (one read of the verdict pair, between steps,
    once per applied batch).  The migration happens at the next
    :func:`build_sharded_layout`, which gathers the streams by the new
    assignment."""
    if is_sliced(state):
        raise NotImplementedError(SLICED_REBALANCE)
    if slots is None:
        slots = torch.from_numpy(
            shard_slots(state.edge_capacity, num_shards)).to(state.device)
    should, imbalance = rebalance_decision(state, slots, threshold)
    should, imbalance = torch.stack([should.to(torch.float32),
                                     imbalance]).tolist()
    if not should:
        return slots, False, imbalance
    return balanced_shard_slots(state, num_shards=num_shards), True, imbalance


def place_sharded_layout(
        layout: B.ShardedEdgeLayout) -> B.ShardedEdgeLayout:
    """Keep this rank's rows of a mesh layout: on a mesh of R ranks, rank
    r's ``num_shards / R`` consecutive shards, on the device they were
    built on (the rank's own).  The engine does it once per layout build,
    so no push slices the streams again; a push or a summary refuses a
    mesh layout that is not placed.  No-op without a mesh."""
    if layout.mesh is None or layout.total_shards is not None:
        return layout
    rank, size = B.mesh_rank_and_size(layout.mesh)
    per = layout.num_shards // size
    if per == layout.num_shards:
        return dataclasses.replace(layout, total_shards=per)
    lo, hi = rank * per, (rank + 1) * per
    cut = lambda x: None if x is None else x[lo:hi].contiguous()
    return dataclasses.replace(
        layout, src=cut(layout.src), dst=cut(layout.dst),
        weight=cut(layout.weight), valid=cut(layout.valid),
        row_offsets=cut(layout.row_offsets), order=cut(layout.order),
        rank=cut(layout.rank), total_shards=layout.num_shards)


__all__ = [
    "balanced_shard_slots",
    "build_sharded_layout",
    "edge_sharding",
    "edge_slot_range",
    "from_edge_slice",
    "graph_shardings",
    "host_edge_slice",
    "mesh_shard_count",
    "place_graph_state",
    "place_sharded_layout",
    "rebalance_decision",
    "rebalance_sharded_layout",
    "shard_imbalance",
    "shard_live_counts",
    "shard_slots",
]
